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


def activation_stats(acts: Mapping[str, torch.Tensor], bins: int = 30
                     ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{name: {count, min, max, mean, std, zero_fraction, bin_counts,
    bin_edges}} of each activation tensor, in f32 on its device: the
    two-pass variance around the mean, the share of exact zeros (the
    reference's sparsity), and a `bins`-bin histogram over [min, max]."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, x in acts.items():
        v = x.detach().float().reshape(-1)
        lo, hi = v.min(), v.max()
        mean = v.mean()
        counts, edges = _histogram(v, lo, hi, bins)
        out[name] = {
            "count": v.numel(),
            "min": lo,
            "max": hi,
            "mean": mean,
            "std": torch.sqrt(torch.square(v - mean).mean()),
            "zero_fraction": (v == 0.0).float().mean(),
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
    """One coherent read of the serving counters; fields a run never wires
    stay 0."""

    serve_requests: int = 0        # generation requests accepted
    serve_completed: int = 0       # requests fully resolved with images
    serve_dropped: int = 0         # requests shed, total (overload +
                                   # failover)
    serve_dropped_overload: int = 0  # shed by drop-oldest backpressure
    serve_dropped_failover: int = 0  # abandoned during fleet failover
    serve_batches: int = 0         # bucketed device dispatches
    serve_queue: int = 0           # requests pending on the serve queue


_SNAPSHOT_FIELDS = frozenset(f.name for f in
                             dataclasses.fields(CounterSnapshot))


class CounterRegistry:
    """Named providers -> CounterSnapshot: each subsystem registers its live
    counter once and every consumer reads `snapshot()`."""

    def __init__(self) -> None:
        self._providers: Dict[str, Callable[[], int]] = {}

    def provide(self, field: str, fn: Callable[[], int]) -> None:
        if field not in _SNAPSHOT_FIELDS:
            raise ValueError(
                f"unknown counter {field!r}; CounterSnapshot fields: "
                f"{sorted(_SNAPSHOT_FIELDS)}")
        self._providers[field] = fn

    def snapshot(self) -> CounterSnapshot:
        return CounterSnapshot(**{name: int(fn())
                                  for name, fn in self._providers.items()})
