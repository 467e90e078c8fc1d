"""`python -m dcgan_tpu_torch.serve`: the generation-as-a-service entry
point on the GPU (the counterpart of `python -m dcgan_tpu.serve`).

  cold start   restore the newest intact checkpoint of a training
               checkpoint directory (`--checkpoint_dir`, the live or the
               `--use_ema` generator, `--quantize int8` optionally; the
               architecture from config.json, `--preset` or the model
               flags), load `.npz` weights (`--weights`,
               `convert.save_weights`) or an exported `.pt2` program
               (`--artifact`, `python -m dcgan_tpu_torch.export`) onto the
               device, build the CUDA kernels, capture every bucket rung;
  fleet        `--fleet N` runs N replicas, each with its own copy of the
               weights and its own dispatch thread, behind the failover
               router (serve/fleet.py); `--watch_promotions` swaps in each
               newly finalized checkpoint step live;
  warm serving replay a recorded arrival trace (`--trace`) or a
               deterministic Poisson demo load (`--demo_requests` /
               `--demo_rps`) through the continuous batcher;
  drain        SIGTERM/SIGINT (or the end of the load) stops intake; queued
               requests complete in FIFO order, the report is written, and
               the process exits 0.

Usage:
    python -m dcgan_tpu_torch.serve --checkpoint_dir C --demo_requests 64
    python -m dcgan_tpu_torch.serve --checkpoint_dir C --fleet 2 \
        --watch_promotions --demo_requests 256 --events_dir E
    python -m dcgan_tpu_torch.serve --artifact sampler.pt2 --demo_requests 64
    python -m dcgan_tpu_torch.serve --weights G.npz --trace trace.json \
        --report report.json --device cuda

`--report` writes one JSON object with the same serve/* keys as the JAX
server (p50/p99 latency, samples/sec, pad_frac, cold-start breakdown; in
fleet mode the fleet's row and a `fleet` block with the promotions), and
`--events_dir` mirrors the serve/* row into events.jsonl (MetricWriter).

Two flags of the JAX CLI are not carried over: `--compile_cache_dir`
(a CUDA graph cannot be cached across processes; every rung is captured
at each cold start) and `--platform` (`--device` is the port's platform
flag).
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
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--checkpoint_dir",
                     help="serve the newest intact checkpoint of a "
                          "training run (verified restore)")
    src.add_argument("--weights",
                     help="generator weights .npz written by "
                          "dcgan_tpu_torch.convert.save_weights "
                          "(config.json beside it)")
    src.add_argument("--artifact",
                     help="serve a .pt2 written by dcgan_tpu_torch.export "
                          "(+ .json sidecar); no checkpoint directory "
                          "needed")
    p.add_argument("--use_ema", action="store_true",
                   help="checkpoint source: serve the EMA generator")
    p.add_argument("--quantize", default="", choices=["", "int8"],
                   help="checkpoint source: post-training quantize the "
                        "served generator weights (int8 symmetric "
                        "per-channel quantize-dequantize at load; the "
                        "report rides the warm banner)")
    p.add_argument("--preset", default=None,
                   help="checkpoint source: named config supplying the "
                        "architecture instead of the checkpoint's "
                        "config.json")
    from dcgan_tpu_torch.config import add_model_override_flags

    add_model_override_flags(p)
    p.add_argument("--buckets", default=None,
                   help="explicit bucket ladder, e.g. 8,16,32 (default: "
                        "the artifact sidecar's hint, else a doubling "
                        "ladder under --max_batch)")
    p.add_argument("--max_batch", type=int, default=64,
                   help="top bucket of the default ladder")
    p.add_argument("--max_queue", type=int, default=256,
                   help="request-queue bound (drop-oldest past it)")
    p.add_argument("--max_wait_ms", type=float, default=10.0,
                   help="deadline flush: max time the oldest request "
                        "waits for batchmates")
    p.add_argument("--fleet", type=int, default=0,
                   help="run N health-checked replicas behind the "
                        "failover router (0 = single bare server)")
    p.add_argument("--heartbeat_secs", type=float, default=0.25,
                   help="fleet health-poll cadence")
    p.add_argument("--miss_beats", type=int, default=4,
                   help="consecutive silent health polls before a "
                        "replica is drained from rotation")
    p.add_argument("--watch_promotions", action="store_true",
                   help="fleet mode: watch the checkpoint dir for newly "
                        "finalized steps and swap the weights live (no "
                        "capture, no dropped request)")
    p.add_argument("--watch_interval_secs", type=float, default=0.5,
                   help="promotion-watcher poll interval")
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
    p.add_argument("--events_dir", default=None,
                   help="mirror the serve/* row into events.jsonl here "
                        "(MetricWriter)")
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


def _round(row: dict) -> dict:
    return {k: (round(v, 3) if isinstance(v, float) else v)
            for k, v in row.items()}


def run(argv: Optional[List[str]] = None) -> Tuple[dict, list]:
    """Serve per `argv` until the load ends or a signal arrives; returns
    (report row, the Responses of the submitted requests)."""
    args = build_parser().parse_args(argv)
    from dcgan_tpu_torch.config import MODEL_OVERRIDE_FLAGS
    from dcgan_tpu_torch.serve.buckets import parse_buckets
    from dcgan_tpu_torch.serve.fleet import ServeFleet
    from dcgan_tpu_torch.serve.server import SamplerServer
    from dcgan_tpu_torch.serve.sources import ArtifactSource, \
        CheckpointSource, WeightsSource

    def make_source():
        if args.artifact is not None:
            return ArtifactSource(args.artifact, device=args.device)
        if args.weights is not None:
            return WeightsSource(args.weights, device=args.device)
        return CheckpointSource(
            args.checkpoint_dir, use_ema=args.use_ema, preset=args.preset,
            overrides={n: getattr(args, n) for n in MODEL_OVERRIDE_FLAGS},
            max_batch=args.max_batch, quantize=args.quantize,
            device=args.device)

    buckets = parse_buckets(args.buckets).buckets if args.buckets else None
    fleet = None
    if args.fleet > 0:
        fleet = ServeFleet(
            [make_source() for _ in range(args.fleet)], buckets=buckets,
            max_batch=args.max_batch, max_queue=args.max_queue,
            max_wait_ms=args.max_wait_ms, seed=args.seed,
            heartbeat_secs=args.heartbeat_secs, miss_beats=args.miss_beats,
            watch_promotions=args.watch_promotions,
            watch_interval_secs=args.watch_interval_secs)
        server = fleet.servers[0]   # the banner's cold-start figures
        intake = fleet
    else:
        server = intake = SamplerServer(
            make_source(), buckets=buckets, max_batch=args.max_batch,
            max_queue=args.max_queue, max_wait_ms=args.max_wait_ms,
            seed=args.seed)

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
        meta = fleet.start()[0] if fleet is not None else server.start()
        cold = server.cold_ms
        print(f"[dcgan_tpu_torch.serve] cold start in "
              f"{cold['cold_start_ms']:.0f} ms (load "
              f"{cold['restore_ms']:.0f} ms, "
              f"{len(server.ladder.buckets)} bucket(s) "
              f"{list(server.ladder.buckets)} warm in "
              f"{cold['warmup_ms']:.0f} ms) on {meta['device']}: "
              f"{meta['source']} step {meta['step']} {meta['weights']} "
              "weights", flush=True)
        if meta.get("quantize"):
            q = meta["quantize"]
            print(f"[dcgan_tpu_torch.serve] int8 weights: "
                  f"{q['quantized_leaves']} leaves, max relative error "
                  f"{q['max_rel_error']} ({q['worst_leaf']})", flush=True)
        if fleet is not None:
            print(f"[dcgan_tpu_torch.serve] fleet: {args.fleet} replica(s) "
                  f"warm, heartbeat {args.heartbeat_secs:.2f}s x "
                  f"{args.miss_beats} miss(es)"
                  + (", promotion watcher on" if args.watch_promotions
                     else ""), flush=True)
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
            if fleet is not None:
                responses.append(fleet.submit(
                    arrival["num_images"], client_id=arrival.get("client")))
            else:
                responses.append(server.submit(arrival["num_images"]))
        if not arrivals:
            # no load source: idle-serve until a signal arrives
            stop_event.wait()
        interrupted = stop_event.is_set()
        if fleet is not None:
            fleet.stop(drain=True)
        else:
            server.stop(drain=True)
    except BaseException:
        # stop the dispatch threads; the caller sees the original error
        with contextlib.suppress(Exception):
            intake.stop(drain=False)
        raise
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)

    report = intake.report()
    row = {
        "label": "serve-report",
        "buckets": list(server.ladder.buckets),
        "meta": meta,
        "device": str(server.source.device),
        "submitted": len(responses),
        "unsubmitted": len(arrivals) - len(responses),
        "completed": sum(1 for r in responses
                         if r.done() and r.error is None),
        "failed": sum(1 for r in responses
                      if r.done() and r.error is not None),
        "interrupted": interrupted,
        "wall_s": round(time.perf_counter() - t0, 3),
        **_round(report),
    }
    if fleet is not None:
        row["fleet"] = {
            "replicas": args.fleet,
            "unhealthy": [[i, reason] for i, reason
                          in fleet.router.unhealthy_events],
            "failovers": fleet.router.failovers,
            "stop_errors": fleet.stop_errors,
            "promotions": fleet.promotion_results,
            "per_replica": [_round(r) for r in fleet.per_replica_reports()],
        }
    if args.report:
        with open(args.report, "w") as f:
            json.dump(row, f)
            f.write("\n")
    if args.events_dir:
        from dcgan_tpu_torch.utils.metrics import MetricWriter

        writer = MetricWriter(args.events_dir, every_secs=0.0,
                              tensorboard=False)
        writer.write_scalars(int(meta.get("step") or 0), report)
        writer.close()
    print(f"[dcgan_tpu_torch.serve] drain: {int(report['serve/completed'])} "
          f"request(s) completed, {int(report['serve/dropped'])} dropped, "
          "queue empty, clean exit", flush=True)
    return row, responses


def main(argv: Optional[List[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
