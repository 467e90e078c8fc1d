"""The trainer's preemption stop: the single-process half of
`dcgan_tpu/train/coordination.py::CoordinatedStop` (that module imports
JAX, so this is a copy of the part one process needs).

`install()` registers one-shot SIGTERM and SIGINT handlers that only set
a flag (async-signal-safe; on the first delivery the handler puts the
previous handlers back, so a second signal can still kill a hung final
save). The training loop `poll()`s the flag at each call boundary, breaks,
and writes its final checkpoint, so a preemption resumes where it
stopped. Handlers are installed on the main thread only (the signal
module's rule) and put back by `restore()` in the trainer's `finally`.
"""

from __future__ import annotations

import signal
import threading
from typing import List, Optional, Tuple


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
