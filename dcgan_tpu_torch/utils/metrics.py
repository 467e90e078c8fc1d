"""Counter registry of the serving plane (the serve_* part of
`dcgan_tpu/utils/metrics.py::CounterRegistry` / `CounterSnapshot`)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict


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
