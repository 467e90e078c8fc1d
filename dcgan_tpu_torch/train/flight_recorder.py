"""Crash flight recorder (a copy of `dcgan_tpu/train/flight_recorder.py`):
the telemetry that led up to a failure.

A fixed-size ring of the last K per-step records (step, wall and host ms,
the step's losses, the gate's verdict, one `CounterRegistry` snapshot:
services queue and drops, rollbacks, quarantined records, the progressive
phase), written as a standalone JSONL dump when the run dies: on a NaN
abort, a coordinated stop, a watchdog trip or an uncaught exception.

Recording is an in-memory deque append on the dispatch thread; the only
file this module writes is the dump, so a run that does not die writes
nothing (`--flight_recorder_steps`, 0 disables).

Dump format, one JSON object per line:

    {"kind": "flight_recorder", "reason": ..., "time": ..., "step": ...,
     "process": 0, "records": N, ...context/extra...}   # header
    {"step": ..., "gate": ..., "step_ms": ..., "host_ms": ...,
     "metrics": {...}, "counters": {...}}               # K records,
                                                        # oldest first

Writes are tmp + rename, so a dump that itself died mid-write never parses
as complete, and a failed dump never raises over the error it documents.
`record()` runs on the dispatch thread; `dump()` on the dispatch thread or
the watchdog's, so the ring is lock-guarded.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Callable, List, Optional, Tuple


def recorder_path(checkpoint_dir: str, process_index: int = 0) -> str:
    """The dump's path: the chief owns the bare name, rank i > 0 of a
    data-parallel world `flight_recorder.p<i>.jsonl` (the JAX package's
    names)."""
    name = "flight_recorder.jsonl" if process_index == 0 \
        else f"flight_recorder.p{process_index}.jsonl"
    return os.path.join(checkpoint_dir, name)


class FlightRecorder:
    """Fixed-size ring of per-step telemetry records + crash-path dump."""

    def __init__(self, path: str, *, capacity: int,
                 context: Optional[Callable[[], dict]] = None):
        self.path = path
        self.capacity = capacity
        self.enabled = capacity > 0 and bool(path)
        self._ring: collections.deque = collections.deque(
            maxlen=max(1, capacity))
        self._lock = threading.Lock()
        self._context = context
        self.dumps = 0

    def record(self, rec: dict) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._ring.append(rec)

    def snapshot(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def dump(self, reason: str, *, step: Optional[int] = None,
             extra: Optional[dict] = None) -> Optional[str]:
        """Write the dump; returns its path, or None (disabled, or the
        write itself failed — the crash path must never raise over the
        failure it is documenting). Last dump wins the filename: a
        stop-dump followed by an exception-dump leaves the later, more
        specific one."""
        if not self.enabled:
            return None
        header = {"kind": "flight_recorder", "reason": reason,
                  "time": time.time()}
        if step is not None:
            header["step"] = int(step)
        try:
            ctx = self._context() if self._context is not None else None
        except Exception:
            ctx = None
        header.update(ctx or {})
        header.update(extra or {})
        records = self.snapshot()
        header["records"] = len(records)
        tmp = self.path + ".tmp"
        try:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(tmp, "w") as f:
                f.write(json.dumps(header) + "\n")
                for rec in records:
                    f.write(json.dumps(rec) + "\n")
            os.replace(tmp, self.path)
        except (OSError, TypeError, ValueError):
            return None
        self.dumps += 1
        return self.path


def read_dump(path: str) -> Tuple[dict, List[dict]]:
    """(header, records) of one dump — the drill/test parse helper."""
    with open(path) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    if not lines or lines[0].get("kind") != "flight_recorder":
        raise ValueError(f"{path} is not a flight-recorder dump")
    return lines[0], lines[1:]
