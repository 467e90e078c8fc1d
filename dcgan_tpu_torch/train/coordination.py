"""The trainer's preemption stop and hung-section watchdog: the
single-process halves of `dcgan_tpu/train/coordination.py`'s
`CoordinatedStop` and `CollectiveWatchdog` (that module imports JAX, so
this is a copy of the part one process needs).

`install()` registers one-shot SIGTERM and SIGINT handlers that only set
a flag (async-signal-safe; on the first delivery the handler puts the
previous handlers back, so a second signal can still kill a hung final
save). The training loop `poll()`s the flag at each call boundary, breaks,
and writes its final checkpoint, so a preemption resumes where it
stopped. Handlers are installed on the main thread only (the signal
module's rule) and put back by `restore()` in the trainer's `finally`.

`CollectiveWatchdog` puts a deadline on the trainer's sections that can
hang (a call's dispatch and readback, the rollback restore, the save);
on expiry it dumps every thread's stack and exits WATCHDOG_EXIT_CODE, so
a launcher restarts the run from its last checkpoint instead of waiting
on a wedged device forever. One process has no peers, so the JAX
module's anomaly consensus, its stop consensus and its fleet health
gather have no counterpart here yet.
"""

from __future__ import annotations

import faulthandler
import os
import signal
import sys
import threading
import time
from typing import Callable, List, Optional, Tuple

#: the process exit code of a watchdog trip (the JAX package's)
WATCHDOG_EXIT_CODE = 43


class CoordinatedStop:
    """Signal flag for a resumable stop of one process."""

    def __init__(self) -> None:
        self._signal_num: Optional[int] = None
        self._restore: dict = {}

    def install(self) -> None:
        if threading.current_thread() is not threading.main_thread():
            return

        def _on_signal(signum, frame):
            self._signal_num = signum
            for sig, handler in self._restore.items():
                signal.signal(sig, handler)

        for s in (signal.SIGTERM, signal.SIGINT):
            self._restore[s] = signal.signal(s, _on_signal)

    def restore(self) -> None:
        for s, h in self._restore.items():
            signal.signal(s, h)
        self._restore.clear()

    def poll(self) -> Tuple[Optional[int], List[int]]:
        """(the stop signal or None, the processes that raised it: [0])."""
        return (self._signal_num, [0] if self._signal_num else [])


class CollectiveWatchdog:
    """Deadline guard for sections that can hang on the device.

    `guard(phase, step)` arms a deadline for the enclosed section and
    restores the previous arm state on exit. Two enforcement layers,
    because a hung runtime call does not reliably release the GIL:

    - a daemon thread checks the armed deadline every `poll_interval`
      seconds; on expiry it prints a diagnostic header (process, step,
      phase, seconds stuck), dumps every thread's live stack via
      faulthandler, and `os._exit`s with WATCHDOG_EXIT_CODE — the
      informative path, needs the GIL to run;
    - `faulthandler.dump_traceback_later` armed at `timeout_secs * 1.5 + 2`
      as the GIL-immune backstop: its timer lives in C, so even a blocked
      call that never yields the interpreter still gets its stacks dumped
      and the process exits nonzero (status 1 — faulthandler's fixed code).

    Either way the run dies loudly with its stacks instead of hanging.

    `on_trip(phase, step)` replaces both enforcement layers for unit tests.
    `pre_dump(phase, step)` runs on any trip, real or on_trip, before
    enforcement: the trainer hangs the flight recorder's dump here, so a
    trip ships the telemetry ring with the stacks; its failures are
    swallowed.
    """

    def __init__(self, timeout_secs: float, *,
                 poll_interval: Optional[float] = None,
                 on_trip: Optional[Callable[[str, int], None]] = None,
                 pre_dump: Optional[Callable[[str, int], None]] = None):
        if timeout_secs <= 0:
            raise ValueError(
                f"timeout_secs must be > 0, got {timeout_secs}")
        self.timeout_secs = timeout_secs
        self._backstop_secs = timeout_secs * 1.5 + 2.0
        self._poll = poll_interval if poll_interval is not None \
            else max(0.05, min(1.0, timeout_secs / 4))
        self._on_trip = on_trip
        self._pre_dump = pre_dump
        self._lock = threading.Lock()
        self._deadline: Optional[float] = None
        self._phase = ""
        self._step = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="dcgan-watchdog", daemon=True)
        self._thread.start()

    def _set_backstop(self, seconds: Optional[float]) -> None:
        """(Re)arm or cancel the C-level faulthandler timer. Process-global
        by nature — one watchdog instance per process, which the trainer
        guarantees."""
        if self._on_trip is not None:
            return  # unit tests must not arm a process-killing timer
        if seconds is None:
            faulthandler.cancel_dump_traceback_later()
        else:
            faulthandler.dump_traceback_later(
                max(0.1, seconds), repeat=False, file=sys.stderr, exit=True)

    def arm(self, phase: str, step: int) -> tuple:
        """Start (or refresh) the deadline; returns the previous
        (deadline, phase, step) so nested guards can restore it."""
        with self._lock:
            prev = (self._deadline, self._phase, self._step)
            self._deadline = time.monotonic() + self.timeout_secs
            self._phase = phase
            self._step = int(step)
            self._set_backstop(self._backstop_secs)
            return prev

    def disarm(self) -> None:
        with self._lock:
            self._deadline = None
            self._set_backstop(None)

    def _restore(self, prev: tuple) -> None:
        with self._lock:
            self._deadline, self._phase, self._step = prev
            self._set_backstop(
                None if self._deadline is None
                else max(0.1, self._deadline - time.monotonic())
                + (self._backstop_secs - self.timeout_secs))

    def guard(self, phase: str, step: int) -> "_WatchdogGuard":
        return _WatchdogGuard(self, phase, step)

    def close(self) -> None:
        self.disarm()
        self._stop.set()
        self._thread.join(timeout=5.0)

    # -- watchdog thread -----------------------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            with self._lock:
                deadline, phase, step = self._deadline, self._phase, \
                    self._step
            if deadline is None or time.monotonic() < deadline:
                continue
            if self._pre_dump is not None:
                # the flight recorder's dump: best-effort, before
                # enforcement, so that a failing dump cannot stop the trip
                # from ending the process
                try:
                    self._pre_dump(phase, step)
                except Exception:
                    pass
            if self._on_trip is not None:
                self._on_trip(phase, step)
                self.disarm()  # a test hook keeps the process alive
                continue
            self._dump_and_exit(phase, step)

    def _dump_and_exit(self, phase: str, step: int) -> None:
        try:
            print(f"[dcgan_tpu_torch] hung-collective watchdog: process 0 "
                  f"stuck > {self.timeout_secs:.1f}s in phase {phase!r} at "
                  f"step {step} — dumping all thread stacks and "
                  f"exiting {WATCHDOG_EXIT_CODE} so the job restarts from "
                  f"the last checkpoint instead of hanging",
                  file=sys.stderr, flush=True)
            faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
            sys.stderr.flush()
        finally:
            os._exit(WATCHDOG_EXIT_CODE)


class _WatchdogGuard:
    """Arms on enter, restores the previous arm state on exit, so a short
    guarded section nested inside a longer one (the pipeline drain inside
    the rollback restore) hands the deadline back instead of disarming the
    outer section."""

    __slots__ = ("_wd", "_phase", "_step", "_prev")

    def __init__(self, wd: CollectiveWatchdog, phase: str, step: int):
        self._wd = wd
        self._phase = phase
        self._step = step
        self._prev = None

    def __enter__(self):
        self._prev = self._wd.arm(self._phase, self._step)
        return self

    def __exit__(self, *exc):
        self._wd._restore(self._prev)
        return False


class _NullWatchdog:
    """`collective_timeout_secs=0`: every guard is a free no-op."""

    class _Guard:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    _GUARD = _Guard()

    def arm(self, phase: str, step: int) -> None:
        pass

    def disarm(self) -> None:
        pass

    def guard(self, phase: str, step: int):
        return self._GUARD

    def close(self) -> None:
        pass


#: A ready-made no-op guard for call sites that decide per call whether a
#: section runs under the deadline (the trainer exempts a call that
#: captures a graph).
NULL_GUARD = _NullWatchdog._GUARD


def make_watchdog(timeout_secs: float, **kw):
    """The trainer's one switch between a real deadline and the no-op."""
    return CollectiveWatchdog(timeout_secs, **kw) if timeout_secs > 0 \
        else _NullWatchdog()
