"""Metrics plumbing (parts of `dcgan_tpu/utils/metrics.py`):

- `MetricWriter`: the trainer's JSONL event stream, one
  {"kind", "step", "time", ...payload} object per line in the JAX
  package's format, mirrored into TensorBoard event files
  (utils/tb_events.py), with the JAX writer's `every_secs` throttle;
- `CounterRegistry` / `CounterSnapshot`: the serving plane's counters.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, Mapping, Optional

from dcgan_tpu_torch.utils.retry import retry_io


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
    serve_dropped: int = 0         # requests shed by drop-oldest
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
