"""Per-step timing for the training loop (the `StepTimer` of
`dcgan_tpu/utils/profiling.py:49-114`, with the same `perf/*` keys).

Each tick must follow a point where the host waited for the device (the
trainer reads the step's losses before it ticks), so a tick-to-tick
interval is a step's wall time, host work and data feed included.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, Optional


class StepTimer:
    """Sliding-window wall-time stats for the training hot loop, over the
    last WINDOW steps."""

    WINDOW = 50

    def __init__(self, *, images_per_step: Optional[int] = None):
        self.images_per_step = images_per_step
        self._durations: collections.deque = collections.deque(
            maxlen=self.WINDOW)
        self._host: collections.deque = collections.deque(maxlen=self.WINDOW)
        self._host_pending = 0.0
        self._last: Optional[float] = None

    def tick(self, now: Optional[float] = None, steps: int = 1) -> None:
        """Mark the end of `steps` training steps (a call of K captured
        steps counts each, with the call's time and host time spread
        evenly over them); the first call only arms the timer."""
        now = time.perf_counter() if now is None else now
        if self._last is not None:
            per_step = (now - self._last) / max(1, steps)
            host_per_step = self._host_pending / max(1, steps)
            for _ in range(max(1, steps)):
                self._durations.append(per_step)
                self._host.append(host_per_step)
        self._host_pending = 0.0
        self._last = now

    def note_host(self, seconds: float) -> None:
        """Accumulate host-side service time (logging, metric reads)
        attributed to the step of the next tick."""
        self._host_pending += seconds

    @property
    def last_step_ms(self) -> Optional[float]:
        """The latest per-step wall ms (None before the second tick): the
        flight recorder's per-record step time."""
        return 1e3 * self._durations[-1] if self._durations else None

    @property
    def last_host_ms(self) -> Optional[float]:
        """The latest per-step host-work ms."""
        return 1e3 * self._host[-1] if self._host else None

    def summary(self) -> Dict[str, float]:
        """The perf/* stats over the current window; empty until two
        ticks."""
        if not self._durations:
            return {}
        ds = sorted(self._durations)
        n = len(ds)
        mean = sum(ds) / n
        out = {
            "perf/step_ms_mean": 1e3 * mean,
            "perf/step_ms_p50": 1e3 * ds[n // 2],
            "perf/step_ms_p90": 1e3 * ds[min(n - 1, (9 * n) // 10)],
            "perf/step_ms_max": 1e3 * ds[-1],
            "perf/steps_per_sec": 1.0 / mean if mean > 0 else 0.0,
        }
        if self.images_per_step and mean > 0:
            out["perf/images_per_sec"] = self.images_per_step / mean
        host_mean = sum(self._host) / len(self._host)
        out["perf/host_ms_mean"] = 1e3 * host_mean
        out["perf/dispatch_occupancy"] = host_mean / mean if mean > 0 else 0.0
        return out
