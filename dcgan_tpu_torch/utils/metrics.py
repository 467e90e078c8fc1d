"""Metrics plumbing (parts of `dcgan_tpu/utils/metrics.py`):

- `MetricWriter`: the trainer's JSONL event stream, one
  {"kind", "step", "time", ...payload} object per line in the JAX
  package's format (its TensorBoard mirror is a later slice);
- `CounterRegistry` / `CounterSnapshot`: the serving plane's counters.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, Mapping


class MetricWriter:
    """JSONL event writer, `<logdir>/events.jsonl`, appended one event per
    line. Not thread-safe: one writer thread at a time."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "events.jsonl")

    def _emit(self, kind: str, step: int, payload: Mapping[str, Any]) -> None:
        event = {"kind": kind, "step": int(step), "time": time.time(),
                 **payload}
        with open(self.path, "a") as f:
            f.write(json.dumps(event) + "\n")

    def write_scalars(self, step: int, scalars: Mapping[str, Any]) -> None:
        self._emit("scalars", step,
                   {"values": {k: float(v) for k, v in scalars.items()}})


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
