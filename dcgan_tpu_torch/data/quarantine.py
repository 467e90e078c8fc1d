"""Corrupt-record quarantine: skip and count instead of dying on the first
bad record (a copy of `dcgan_tpu/data/quarantine.py`).

With `max_corrupt_records` > 0 the loader SKIPS a record whose CRC or
parse fails, logs its file and offset, and counts it here, up to that
budget; past it the run fails, so systemic corruption (a truncated
dataset, a wrong record_dtype) still stops the run. The counter is
process-wide and covers both loaders (the native loader's count is
mirrored in through `add`): the trainer reports this run's delta as the
`data/corrupt_records` scalar.
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
_count = 0


class CorruptRecordError(IOError):
    """The corrupt-record budget was exhausted."""


def record(path: str, offset: int, reason: str, *,
           budget: int = 0, seen: int = 1) -> None:
    """Log and count one quarantined record; raise when `seen` (the calling
    loader's own running count) exceeds `budget`."""
    global _count
    with _lock:
        _count += 1
    print(f"[dcgan_tpu_torch] quarantined corrupt record: {reason} "
          f"({path} @ byte {offset}; {seen}/{budget} of budget)", flush=True)
    if seen > budget:
        raise CorruptRecordError(
            f"corrupt-record budget exhausted: {seen} corrupt record(s) "
            f"with --max_corrupt_records={budget}; last was {reason} in "
            f"{path} @ byte {offset} — repair or re-prepare the shards")


def add(n: int) -> None:
    """Fold quarantines counted elsewhere (the native loader's) into the
    process total."""
    global _count
    if n > 0:
        with _lock:
            _count += n


def count() -> int:
    """Total records quarantined by this process so far."""
    with _lock:
        return _count


def reset() -> None:
    """Zero the counter (tests)."""
    global _count
    with _lock:
        _count = 0
