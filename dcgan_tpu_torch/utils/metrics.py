"""Metrics plumbing (parts of `dcgan_tpu/utils/metrics.py`):

- `MetricWriter`: the trainer's JSONL event stream, one
  {"kind", "step", "time", ...payload} object per line in the JAX
  package's format, mirrored into TensorBoard event files
  (utils/tb_events.py), with the JAX writer's `every_secs` throttle;
- `activation_stats`: per-layer histograms and sparsity of the
  activations `summarize` captures, reduced on the device
  (`dcgan_tpu/utils/metrics.py:158-210`), which
  `MetricWriter.write_activations` writes;
- `CounterRegistry` / `CounterSnapshot`: the serving plane's counters.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from dcgan_tpu_torch.utils.retry import retry_io


def _histogram(v: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
               bins: int):
    """jnp.histogram(v, bins, range=(lo, hi)) of a flat f32 tensor: the
    edges by jnp.linspace's arithmetic (lo * (1 - t) + hi * t with t =
    i / bins, the last edge hi itself; a range of width 0 widened by 0.5
    each way), each value in the bin whose right edge is the first one
    above it, a value equal to the last edge in the last bin; counts as
    f32."""
    flat = lo == hi
    lo = torch.where(flat, lo - 0.5, lo)
    hi = torch.where(flat, hi + 0.5, hi)
    t = torch.arange(bins, dtype=torch.float32, device=v.device) / bins
    edges = torch.cat([lo * (1 - t) + hi * t, hi.reshape(1)])
    idx = torch.searchsorted(edges, v, right=True)
    idx = torch.where(v == edges[-1], bins, idx)
    counts = torch.bincount(idx, minlength=bins + 2)[1:bins + 1]
    return counts.float(), edges


def activation_stats(acts: Mapping[str, torch.Tensor], bins: int = 30,
                     group=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """{name: {count, min, max, mean, std, zero_fraction, bin_counts,
    bin_edges}} of each activation tensor, in f32 on its device: the
    two-pass variance around the mean, the share of exact zeros (the
    reference's sparsity), and a `bins`-bin histogram over [min, max].

    With a process `group` the statistics are global, as the JAX
    function's under `axis_name` (`dcgan_tpu/utils/metrics.py:159-190`):
    the min and max taken over the ranks first, so that every rank bins
    against the same edges, the counts then summed, the mean, the zero
    share and the variance around the global mean averaged; every rank
    holds the same result."""
    from dcgan_tpu_torch.parallel.collectives import all_reduce_sum_, \
        mean_scalars, min_max, world_size

    out: Dict[str, Dict[str, torch.Tensor]] = {}
    n = world_size(group)
    for name, x in acts.items():
        v = x.detach().float().reshape(-1)
        lo, hi = min_max(group, v.min(), v.max())
        mean, zero = mean_scalars(group, [v.mean(),
                                          (v == 0.0).float().mean()])
        var = mean_scalars(group, [torch.square(v - mean).mean()])[0]
        counts, edges = _histogram(v, lo, hi, bins)
        if group is not None:
            counts = all_reduce_sum_(group, counts)
        out[name] = {
            "count": v.numel() * n,
            "min": lo,
            "max": hi,
            "mean": mean,
            "std": torch.sqrt(var),
            "zero_fraction": zero,
            "bin_counts": counts,
            "bin_edges": edges,
        }
    return out


class MetricWriter:
    """Time-throttled event writer, `<logdir>/events.jsonl` appended one
    event per line; with tensorboard=True (the default) every event is
    mirrored into an events.out.tfevents.* file.

    `ready()` flips true at most once per `every_secs` (the first call
    always fires), the JAX writer's save_summaries_secs gate. Not
    thread-safe: one writer thread at a time."""

    def __init__(self, logdir: str, *, every_secs: float = 10.0,
                 tensorboard: bool = True):
        self.logdir = logdir
        self.every_secs = every_secs
        self._next_time = 0.0
        self.path = os.path.join(logdir, "events.jsonl")
        # retried: a transient mkdir failure would end the run before its
        # first step
        retry_io(lambda: os.makedirs(logdir, exist_ok=True),
                 tag="metrics-mkdir")
        self._tb = None
        if tensorboard:
            from dcgan_tpu_torch.utils.tb_events import TBEventWriter

            self._tb = TBEventWriter(logdir)

    def ready(self, now: Optional[float] = None) -> bool:
        now = time.time() if now is None else now
        if now >= self._next_time:
            # advance from now, not by accumulation: a slow step must not
            # cause a burst of catch-up events
            self._next_time = now + self.every_secs
            return True
        return False

    def _emit(self, kind: str, step: int, payload: Mapping[str, Any]) -> None:
        event = {"kind": kind, "step": int(step), "time": time.time(),
                 **payload}
        with open(self.path, "a") as f:
            f.write(json.dumps(event) + "\n")

    def write_scalars(self, step: int, scalars: Mapping[str, Any]) -> None:
        vals = {k: float(v) for k, v in scalars.items()}
        self._emit("scalars", step, {"values": vals})
        if self._tb:
            for k, v in vals.items():
                self._tb.add_scalar(k, v, step)
            self._tb.flush()

    def write_activations(self, step: int,
                          stats: Mapping[str, Mapping[str, Any]]) -> None:
        """One "activations" event of `activation_stats`' output (bin
        counts and `count` as ints, the rest as floats), mirrored into
        TensorBoard as a histogram and a sparsity scalar per layer."""
        def conv(rec):
            out = {}
            for k, v in rec.items():
                a = v.detach().cpu().numpy() if isinstance(
                    v, torch.Tensor) else np.asarray(v)
                if a.ndim:
                    cast = int if k == "bin_counts" else float
                    out[k] = [cast(x) for x in a.ravel()]
                else:
                    out[k] = int(a) if k == "count" else float(a)
            return out
        converted = {k: conv(rec) for k, rec in stats.items()}
        self._emit("activations", step, {"values": converted})
        if self._tb:
            for k, rec in converted.items():
                self._tb.add_histogram_bins(
                    k + "/activations", step, bin_edges=rec["bin_edges"],
                    bin_counts=rec["bin_counts"], minimum=rec["min"],
                    maximum=rec["max"], num=float(rec["count"]),
                    mean=rec["mean"], std=rec["std"])
                self._tb.add_scalar(k + "/sparsity", rec["zero_fraction"],
                                    step)
            self._tb.flush()

    def write_image_event(self, step: int, name: str, path: str) -> None:
        """Record that an image was written (the grid PNG itself is saved
        by utils/images.py) and mirror the PNG into TensorBoard."""
        self._emit("image", step, {"name": name, "path": path})
        if self._tb and os.path.exists(path):
            with open(path, "rb") as f:
                self._tb.add_image_png(name, f.read(), step)
            self._tb.flush()

    def flush(self) -> None:
        if self._tb:
            self._tb.flush()

    def close(self) -> None:
        if self._tb:
            self._tb.close()
            self._tb = None


@dataclasses.dataclass(frozen=True)
class CounterSnapshot:
    """One coherent read of the run's recovery and serving counters, with
    the JAX package's fields in its order (`dcgan_tpu/utils/metrics.py`);
    fields a run never wires stay 0. The scalar rows' recovery extras and
    the flight recorder's records read the same snapshot.

    `compile_cache_*` and `live_topology` have no counterpart in the port
    (it compiles nothing it could cache, and has no live elasticity yet);
    they stay 0."""

    services_queue: int = 0        # tasks pending on the services worker
    services_dropped: int = 0      # tasks discarded by backpressure
    rollbacks: int = 0             # NaN-gate rollbacks this run
    corrupt_records: int = 0       # quarantined records this run (delta
                                   # from the trainer's corrupt_base)
    compile_cache_requests: int = 0
    compile_cache_hits: int = 0
    compile_cache_misses: int = 0
    progressive_phase: int = 0     # the active progressive phase's index
                                   # (0 in fixed-resolution runs)
    live_topology: int = 0
    master_f32_leaves: int = 0     # f32 Adam master-moment leaves under a
                                   # reduced-precision policy
    serve_requests: int = 0        # generation requests accepted
    serve_completed: int = 0       # requests fully resolved with images
    serve_dropped: int = 0         # requests shed, total (overload +
                                   # failover)
    serve_dropped_overload: int = 0  # shed by drop-oldest backpressure
    serve_dropped_failover: int = 0  # abandoned during fleet failover
    serve_batches: int = 0         # bucketed device dispatches
    serve_queue: int = 0           # requests pending on the serve queue

    def as_dict(self) -> Dict[str, int]:
        # a flat getattr walk, not dataclasses.asdict (which deep-copies):
        # the flight recorder calls this once per consumed step
        return {name: getattr(self, name) for name in _SNAPSHOT_FIELD_ORDER}


_SNAPSHOT_FIELD_ORDER = tuple(f.name for f in
                              dataclasses.fields(CounterSnapshot))
_SNAPSHOT_FIELDS = frozenset(_SNAPSHOT_FIELD_ORDER)


def _check_fields(fields) -> None:
    for field in fields:
        if field not in _SNAPSHOT_FIELDS:
            raise ValueError(
                f"unknown counter {field!r}; CounterSnapshot fields: "
                f"{sorted(_SNAPSHOT_FIELDS)}")


class CounterRegistry:
    """Named providers -> CounterSnapshot: each subsystem registers its live
    counter once and every consumer reads `snapshot()`."""

    def __init__(self) -> None:
        self._providers: Dict[str, Callable[[], int]] = {}
        self._groups: list = []

    def provide(self, field: str, fn: Callable[[], int]) -> None:
        _check_fields((field,))
        self._providers[field] = fn

    def provide_group(self, fields, fn: Callable[[], Mapping[str, Any]]
                      ) -> None:
        """One provider feeding several fields from a single read:
        snapshot() calls `fn` once, not once per field. `fn` may return
        extra keys; only `fields` are consumed."""
        _check_fields(fields)
        self._groups.append((tuple(fields), fn))

    def snapshot(self) -> CounterSnapshot:
        vals = {name: int(fn()) for name, fn in self._providers.items()}
        for fields, fn in self._groups:
            got = fn()
            for field in fields:
                vals[field] = int(got[field])
        return CounterSnapshot(**vals)
