"""Local multi-process worlds over a FileStore (the port's counterpart of
`dcgan_tpu/testing/multihost.py`), for the tests and chip_smoke's drill.

    results = run_world("my_module:rank_fn", 2, kwargs={"steps": 2})

starts 2 processes of this module, one per rank. Each forms the world
over a FileStore in a fresh temporary directory
(`parallel/distributed.py::initialize_multihost` with a "file://"
address), calls `rank_fn(world, **kwargs)` and saves its return value;
`run_world` returns them in rank order. A deadline covers the whole
world: a rank that fails fails the world with its stderr, a rank that
hangs past the deadline fails it too, and every rank still running is
killed. No rank is ever dropped.

The ranks run gloo on the CPU by default (one torch thread each);
`backend="gloo", device="cuda:0"` puts every rank on one card.
`paths` are prepended to each rank's PYTHONPATH, where `module` must be
importable.
"""

from __future__ import annotations

import argparse
import importlib
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Any, List, Optional, Sequence

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _tail(path: str, n: int = 3000) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()[-n:]
    except OSError:
        return ""


def run_world(target: str, world: int, *, kwargs: Optional[dict] = None,
              timeout: float = 120.0, backend: str = "gloo",
              device: str = "cpu", paths: Sequence[str] = (),
              env: Optional[dict] = None) -> List[Any]:
    """`target` ("module:function") in `world` ranks; the ranks' return
    values in rank order. Raises RuntimeError naming the first rank that
    exited non-zero, TimeoutError if the world outlives `timeout`
    seconds."""
    import torch

    tmp = tempfile.mkdtemp(prefix="dcgan_world_")
    procs = []
    try:
        args_path = os.path.join(tmp, "kwargs.pt")
        torch.save(kwargs or {}, args_path)
        penv = dict(os.environ if env is None else env)
        penv["PYTHONPATH"] = os.pathsep.join(
            [*paths, ROOT, penv.get("PYTHONPATH", "")]).rstrip(os.pathsep)
        penv.setdefault("OMP_NUM_THREADS", "1")
        for rank in range(world):
            log = open(os.path.join(tmp, f"rank{rank}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "dcgan_tpu_torch.testing.multihost",
                 "--target", target, "--rank", str(rank), "--world",
                 str(world), "--store", os.path.join(tmp, "store"),
                 "--kwargs", args_path, "--out",
                 os.path.join(tmp, f"rank{rank}.pt"), "--backend", backend,
                 "--device", device],
                cwd=ROOT, env=penv, stdout=log, stderr=subprocess.STDOUT),
                log))
        deadline = time.monotonic() + timeout
        pending = set(range(world))
        while pending:
            for rank in sorted(pending):
                code = procs[rank][0].poll()
                if code is None:
                    continue
                pending.discard(rank)
                if code != 0:
                    raise RuntimeError(
                        f"rank {rank} of {world} exited {code} "
                        f"({target}):\n"
                        + _tail(os.path.join(tmp, f"rank{rank}.log")))
            if pending and time.monotonic() > deadline:
                raise TimeoutError(
                    f"ranks {sorted(pending)} of {world} ({target}) still "
                    f"running after {timeout:.0f} s:\n" + _tail(
                        os.path.join(tmp, f"rank{min(pending)}.log")))
            time.sleep(0.05)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="one rank of run_world")
    p.add_argument("--target", required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--store", required=True)
    p.add_argument("--kwargs", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--backend", default="gloo")
    p.add_argument("--device", default="cpu")
    args = p.parse_args(argv)
    import torch

    from dcgan_tpu_torch.parallel.distributed import initialize_multihost, \
        shutdown

    torch.set_num_threads(1)
    world = initialize_multihost(f"file://{args.store}", args.world,
                                 args.rank, backend=args.backend,
                                 device=args.device, local_rank=0)
    module, name = args.target.split(":")
    fn = getattr(importlib.import_module(module), name)
    result = fn(world, **torch.load(args.kwargs, weights_only=False))
    torch.save(result, args.out)
    shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
