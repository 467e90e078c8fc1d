"""Step timing, the startup breakdown and torch.profiler trace capture (the
counterpart of `dcgan_tpu/utils/profiling.py`, with the same `perf/*` and
`perf/startup/*` keys):

- `StepTimer`: sliding-window wall-time stats of the training loop
  (mean/p50/p90/max, steps/s, images/s, the dispatch thread's host work).
  Each tick must follow a point where the host waited for the device (the
  trainer reads a call's losses before it ticks), so a tick-to-tick
  interval is a step's wall time, host work and data feed included.
- `StartupProfile`: named-phase wall-clock breakdown of the time to the
  first step (`init`, `restore`, `data`, `warmup`).
- `TraceCapture`: torch.profiler windows of `num_steps` steps, one
  scheduled and any number triggered by touching a file, each written as
  `<host>.<n>.pt.trace.json.gz` (Kineto's Chrome trace, through
  `tensorboard_trace_handler`) and handed to `on_capture` for the
  in-process digest (utils/trace.py).
"""

from __future__ import annotations

import collections
import contextlib
import os
import socket
import time
from typing import Callable, Dict, Optional, Union

import torch


class StepTimer:
    """Sliding-window wall-time stats for the training hot loop, over the
    last `window` steps."""

    def __init__(self, *, window: int = 50,
                 images_per_step: Optional[int] = None):
        self.window = window
        self.images_per_step = images_per_step
        self._durations: collections.deque = collections.deque(maxlen=window)
        self._host: collections.deque = collections.deque(maxlen=window)
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
        attributed to the steps of the next tick."""
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

    def __len__(self) -> int:
        return len(self._durations)

    def summary(self, prefix: str = "perf/") -> Dict[str, float]:
        """Stats over the current window; empty until two ticks."""
        if not self._durations:
            return {}
        ds = sorted(self._durations)
        n = len(ds)
        mean = sum(ds) / n
        out = {
            f"{prefix}step_ms_mean": 1e3 * mean,
            f"{prefix}step_ms_p50": 1e3 * ds[n // 2],
            f"{prefix}step_ms_p90": 1e3 * ds[min(n - 1, (9 * n) // 10)],
            f"{prefix}step_ms_max": 1e3 * ds[-1],
            f"{prefix}steps_per_sec": 1.0 / mean if mean > 0 else 0.0,
        }
        if self.images_per_step and mean > 0:
            out[f"{prefix}images_per_sec"] = self.images_per_step / mean
        if self._host:
            host_mean = sum(self._host) / len(self._host)
            out[f"{prefix}host_ms_mean"] = 1e3 * host_mean
            out[f"{prefix}dispatch_occupancy"] = \
                host_mean / mean if mean > 0 else 0.0
        return out


class StartupProfile:
    """Named-phase wall-clock breakdown of the time to the first step.

    The trainer brackets each startup phase (`init`, `restore`, `data`,
    `warmup`) with `phase()` and stamps `first_step()` at the first call's
    readback. Phases are additive and disjoint; `total_ms` runs from
    construction to the first-step stamp, so time outside the named phases
    shows as total minus their sum."""

    def __init__(self) -> None:
        self._t0 = time.perf_counter()
        self._phases: Dict[str, float] = {}
        self._first_step_ms: Optional[float] = None

    def phase(self, name: str):
        """Context manager accumulating wall time under `name`."""
        @contextlib.contextmanager
        def _cm():
            t0 = time.perf_counter()
            try:
                yield self
            finally:
                self._phases[name] = self._phases.get(name, 0.0) \
                    + (time.perf_counter() - t0) * 1e3
        return _cm()

    def first_step(self) -> None:
        """Stamp the first completed training step (the first call
        wins)."""
        if self._first_step_ms is None:
            self._first_step_ms = (time.perf_counter() - self._t0) * 1e3

    @property
    def done(self) -> bool:
        return self._first_step_ms is not None

    def summary(self, prefix: str = "perf/startup/") -> Dict[str, float]:
        out = {f"{prefix}{k}_ms": v for k, v in self._phases.items()}
        if self._first_step_ms is not None:
            out[f"{prefix}total_ms"] = self._first_step_ms
        return out


def _synchronize(sync: Optional[torch.Tensor]) -> None:
    """Wait for the device of `sync`: a window's trace must hold the
    device work of its steps, not only their launches."""
    if sync is not None and sync.device.type == "cuda":
        torch.cuda.synchronize(sync.device)


class TraceCapture:
    """torch.profiler capture windows: one scheduled, any number
    triggered.

    Call maybe_start(step) before dispatching a call and maybe_stop(step)
    after its readback; each capture records `num_steps` steps. A window
    opens

    - scheduled: with `schedule=True` and a logdir, once, at the first
      boundary >= start_step;
    - triggered: with `trigger_path` set, at the next boundary after the
      file is touched (one touch, one capture). The poll is one os.stat
      per boundary, only when a trigger path is set.

    A trigger is served once per mtime: each process captures when it
    sees a new mtime and remembers it, and only the `consume` process
    deletes the file, at the end of its capture, so peers sharing the
    file all see it for the whole window. A touch during a capture is
    absorbed by the removal at its end.

    A window's first call is a warm-up: the profiler runs (its schedule's
    `warmup=1`) and its events are dropped, and the `num_steps` steps
    after it are recorded. On an H100, in a process that had run for
    minutes, the first replay after the profiler's start lost its
    earliest kernels from the trace (3 of 235 port-kernel launches of a
    5-step window); behind the warm-up call the recorded windows were
    whole. So a window spans JAX's window
    of `num_steps` plus the warm-up call's steps, from the same boundary;
    `recording` is true for the calls after the warm-up.

    The window records the CPU, and the card's kernels, copies and the
    `record_function` ranges they ran under when `device` is a GPU
    (shapes and stacks off). `maybe_stop` synchronizes the device of its
    `sync` before the warm-up ends and before the profiler stops; the
    stop writes `<logdir>/<host>.<n>.pt.trace.json.gz` on the calling
    thread (its time is `last_stop_ms`), then `on_capture(stop_step)`
    fires. A profiler that fails to start or stop raises. Inactive, and
    free, when logdir is empty.
    """

    def __init__(self, logdir: str, *, start_step: int = 10,
                 num_steps: int = 5, schedule: bool = True,
                 trigger_path: str = "", consume: bool = True,
                 on_capture: Optional[Callable[[int], None]] = None,
                 device: Union[str, torch.device] = "cpu"):
        self.logdir = logdir
        self.start_step = start_step
        self.num_steps = num_steps
        self.trigger_path = trigger_path if logdir else ""
        self.consume = consume
        self.on_capture = on_capture
        self.device = torch.device(device)
        self._active = False
        self._warming = False
        self._scheduled_done = not (schedule and logdir and num_steps > 0)
        self._stop_at = 0
        self._served_mtime: Optional[int] = None
        self._consume_pending = False
        self._prof = None
        self.captures = 0
        self.last_stop_ms: Optional[float] = None

    @property
    def active(self) -> bool:
        """A window is open (its warm-up call included)."""
        return self._active

    @property
    def recording(self) -> bool:
        """The open window records: its warm-up call is over."""
        return self._active and not self._warming

    def _begin(self, step: int) -> None:
        from torch.profiler import ProfilerActivity, profile, schedule, \
            tensorboard_trace_handler

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        # one warm-up call, then one recorded span, written at stop()
        prof = profile(
            activities=activities, record_shapes=False, with_stack=False,
            schedule=schedule(wait=0, warmup=1, active=1),
            on_trace_ready=tensorboard_trace_handler(
                self.logdir, worker_name=socket.gethostname(),
                use_gzip=True))
        prof.start()
        self._prof = prof
        self._active = True
        self._warming = True

    def _record(self, step: int) -> None:
        """The warm-up call ended at `step`: record the next num_steps."""
        self._prof.step()
        self._warming = False
        self._stop_at = step + self.num_steps

    def _end(self) -> None:
        prof, self._prof = self._prof, None
        self._active = False
        t0 = time.perf_counter()
        prof.stop()
        self.last_stop_ms = (time.perf_counter() - t0) * 1e3

    def maybe_start(self, step: int) -> None:
        if self._active:
            return
        if not self._scheduled_done and step >= self.start_step:
            self._scheduled_done = True
            self._begin(step)
            return
        if self.trigger_path and self.num_steps > 0:
            try:
                mtime = os.stat(self.trigger_path).st_mtime_ns
            except OSError:
                return  # absent (or unreadable): nothing to serve
            if mtime == self._served_mtime:
                return  # this touch already got its capture
            self._served_mtime = mtime
            self._consume_pending = self.consume
            self._begin(step)

    def _consume_trigger(self) -> None:
        if not self._consume_pending:
            return
        self._consume_pending = False
        try:
            os.remove(self.trigger_path)
        except OSError:
            pass  # the mtime guard prevents a re-trigger loop

    def maybe_stop(self, step: int, sync=None) -> None:
        """`step` is the number of steps completed so far; the device of
        `sync` (the step's outputs) is synchronized first."""
        if not self._active:
            return
        if self._warming:
            _synchronize(sync)
            self._record(step)
            return
        if step < self._stop_at:
            return
        _synchronize(sync)
        self._end()
        self.captures += 1
        self._consume_trigger()
        if self.on_capture is not None:
            self.on_capture(step)

    def close(self) -> None:
        """End an open window (its trace is written, not digested)."""
        if self._active:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            if self._warming:
                self._record(self._stop_at)
            self._end()
            self._consume_trigger()
