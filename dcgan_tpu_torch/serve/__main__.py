"""`python -m dcgan_tpu_torch.serve`: the generation-as-a-service entry
point on the GPU (the counterpart of `python -m dcgan_tpu.serve`).

  cold start   load the `.npz` weights (`convert.save_weights`) onto the
               device, build the CUDA kernels, prime every bucket rung;
  warm serving replay a recorded arrival trace (`--trace`) or a
               deterministic Poisson demo load (`--demo_requests` /
               `--demo_rps`) through the continuous batcher;
  drain        SIGTERM/SIGINT (or the end of the load) stops intake; queued
               requests complete in FIFO order, the report is written, and
               the process exits 0.

Usage:
    python -m dcgan_tpu_torch.serve --weights G.npz --demo_requests 64
    python -m dcgan_tpu_torch.serve --weights G.npz --trace trace.json \
        --report report.json --device cuda

`--report` writes one JSON object with the same serve/* keys as the JAX
server (p50/p99 latency, samples/sec, pad_frac, cold-start breakdown).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import signal
import sys
import threading
import time
from typing import List, Optional, Tuple


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dcgan_tpu_torch.serve",
        description="continuous-batching sampler server on the GPU")
    p.add_argument("--weights", required=True,
                   help="generator weights .npz written by "
                        "dcgan_tpu_torch.convert.save_weights (config.json "
                        "beside it)")
    p.add_argument("--buckets", default=None,
                   help="explicit bucket ladder, e.g. 8,16,32 (default: a "
                        "doubling ladder under --max_batch)")
    p.add_argument("--max_batch", type=int, default=64,
                   help="top bucket of the default ladder")
    p.add_argument("--max_queue", type=int, default=256,
                   help="request-queue bound (drop-oldest past it)")
    p.add_argument("--max_wait_ms", type=float, default=10.0,
                   help="deadline flush: max time the oldest request "
                        "waits for batchmates")
    p.add_argument("--trace", default=None,
                   help="JSON arrival trace to replay: {\"arrivals\": "
                        "[{\"t_ms\": ..., \"num_images\": ...}, ...]}")
    p.add_argument("--demo_requests", type=int, default=0,
                   help="generate this many Poisson-arrival demo requests "
                        "instead of a trace")
    p.add_argument("--demo_rps", type=float, default=20.0,
                   help="demo load mean arrival rate (requests/sec)")
    p.add_argument("--demo_max_images", type=int, default=8,
                   help="demo per-request image count is uniform in "
                        "[1, this]")
    p.add_argument("--report", default=None,
                   help="write the final JSON report row here")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default cuda; the CPU "
                        "only when asked for by name)")
    return p


def _load_arrivals(args) -> List[dict]:
    """[{t_ms, num_images}, ...] from --trace or the demo generator."""
    if args.trace:
        with open(args.trace) as f:
            arrivals = json.load(f)["arrivals"]
        return sorted(arrivals, key=lambda a: a["t_ms"])
    if args.demo_requests <= 0:
        return []
    import numpy as np

    rng = np.random.default_rng(args.seed)
    t = 0.0
    out = []
    for _ in range(args.demo_requests):
        t += float(rng.exponential(1e3 / args.demo_rps))
        out.append({"t_ms": t,
                    "num_images": int(rng.integers(
                        1, args.demo_max_images + 1))})
    return out


def run(argv: Optional[List[str]] = None) -> Tuple[dict, list]:
    """Serve per `argv` until the load ends or a signal arrives; returns
    (report row, the Responses of the submitted requests)."""
    args = build_parser().parse_args(argv)
    from dcgan_tpu_torch.serve.buckets import parse_buckets
    from dcgan_tpu_torch.serve.server import SamplerServer
    from dcgan_tpu_torch.serve.sources import WeightsSource

    source = WeightsSource(args.weights, device=args.device)
    server = SamplerServer(
        source,
        buckets=parse_buckets(args.buckets).buckets if args.buckets else None,
        max_batch=args.max_batch, max_queue=args.max_queue,
        max_wait_ms=args.max_wait_ms, seed=args.seed)

    # graceful drain on SIGTERM/SIGINT: the handler only sets a flag; the
    # load loop below breaks out and runs the drain
    stop_event = threading.Event()

    def _on_signal(signum, frame):
        print(f"[dcgan_tpu_torch.serve] received signal {signum}: stopping "
              "intake, draining in-flight requests", flush=True)
        stop_event.set()

    previous = {sig: signal.signal(sig, _on_signal)
                for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        t0 = time.perf_counter()
        meta = server.start()
        cold = server.cold_ms
        print(f"[dcgan_tpu_torch.serve] cold start in "
              f"{cold['cold_start_ms']:.0f} ms (load "
              f"{cold['restore_ms']:.0f} ms, "
              f"{len(server.ladder.buckets)} bucket(s) "
              f"{list(server.ladder.buckets)} warm in "
              f"{cold['warmup_ms']:.0f} ms) on {meta['device']}: "
              f"{meta['weights']}", flush=True)
        print("[dcgan_tpu_torch.serve] warm: serving", flush=True)

        arrivals = _load_arrivals(args)
        responses = []
        t_load = time.monotonic()
        for arrival in arrivals:
            wait = arrival["t_ms"] / 1e3 - (time.monotonic() - t_load)
            if wait > 0 and stop_event.wait(wait):
                break
            if stop_event.is_set():
                break
            responses.append(server.submit(arrival["num_images"]))
        if not arrivals:
            # no load source: idle-serve until a signal arrives
            stop_event.wait()
        interrupted = stop_event.is_set()
        server.stop(drain=True)
    except BaseException:
        # stop the dispatch thread; the caller sees the original error
        with contextlib.suppress(Exception):
            server.stop(drain=False)
        raise
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)

    report = server.report()
    row = {
        "label": "serve-report",
        "buckets": list(server.ladder.buckets),
        "meta": meta,
        "device": str(source.device),
        "submitted": len(responses),
        "unsubmitted": len(arrivals) - len(responses),
        "completed": sum(1 for r in responses
                         if r.done() and r.error is None),
        "failed": sum(1 for r in responses
                      if r.done() and r.error is not None),
        "interrupted": interrupted,
        "wall_s": round(time.perf_counter() - t0, 3),
        **{k: (round(v, 3) if isinstance(v, float) else v)
           for k, v in report.items()},
    }
    if args.report:
        with open(args.report, "w") as f:
            json.dump(row, f)
            f.write("\n")
    print(f"[dcgan_tpu_torch.serve] drain: {int(report['serve/completed'])} "
          f"request(s) completed, {int(report['serve/dropped'])} dropped, "
          "queue empty, clean exit", flush=True)
    return row, responses


def main(argv: Optional[List[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
