"""Host services: the telemetry work the dispatch thread sheds (a copy of
`dcgan_tpu/train/services.py`, plus `stage`, the port's device-to-host
hand-off).

- `HostServices`: one worker thread draining a bounded deque. When the
  queue is full the oldest droppable task is discarded (drop-oldest
  backpressure: the newest telemetry is worth most, and a slow filesystem
  costs observability, not throughput). A worker exception is re-raised on
  the dispatch thread at the next `raise_if_failed()` / `drain()`.
- `InlineServices`: `--async_services=false`. `submit` runs the task at
  once on the calling thread: the same call sites in the same order, so
  the event stream is the one the async executor writes.

Thread contract: the MetricWriter (JSONL and TensorBoard files) is not
thread-safe; in async mode every writer call is submitted here, so the
one worker serializes them. Only host-local tails move to the worker: file
IO, PNG encoding, and the wait for a device-to-host copy that the dispatch
thread started (`stage`). A task never reads a device tensor itself: the
captured programs' outputs are static buffers that the next replay
overwrites, so the dispatch thread copies what a task needs into pinned
host memory on the stream, behind an event, before the next dispatch.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Optional

import torch

# default queue bound: deep enough to absorb a burst (scalars, grid and
# activations landing on one step), shallow enough that a wedged
# filesystem drops telemetry within seconds instead of hoarding pinned
# host buffers
DEFAULT_QUEUE_DEPTH = 16


class ServiceError(RuntimeError):
    """A background service task failed; carries the original traceback."""


class _Task:
    __slots__ = ("fn", "tag", "droppable")

    def __init__(self, fn: Callable[[], None], tag: str, droppable: bool):
        self.fn = fn
        self.tag = tag
        self.droppable = droppable


class HostServices:
    """Single-worker background executor with drop-oldest backpressure."""

    def __init__(self, *, max_queue: int = DEFAULT_QUEUE_DEPTH,
                 name: str = "dcgan-host-services"):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = max_queue
        self.dropped = 0          # tasks discarded by backpressure
        self.completed = 0
        self._queue: "collections.deque[_Task]" = collections.deque()
        self._lock = threading.Lock()
        self._has_work = threading.Condition(self._lock)
        self._idle = threading.Condition(self._lock)
        self._busy = False        # worker currently executing a task
        self._stop = False
        self._error: Optional[BaseException] = None
        self._error_tag = ""
        self._worker = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._worker.start()

    # -- worker side --------------------------------------------------------

    def _run(self) -> None:
        from dcgan_tpu_torch.testing import chaos
        from dcgan_tpu_torch.utils.retry import retry_io

        n_tasks = 0
        while True:
            with self._lock:
                while not self._queue and not self._stop:
                    self._has_work.wait()
                if self._stop and not self._queue:
                    self._idle.notify_all()
                    return
                task = self._queue.popleft()
                self._busy = True
            n_tasks += 1
            try:
                if chaos.should_crash_worker(n_tasks):
                    raise RuntimeError(
                        "chaos: injected services worker crash")
                # writer tasks are filesystem IO: one transient OSError
                # gets the bounded backoff instead of poisoning the
                # worker; a persistent failure still surfaces on the
                # dispatch thread. Appends are not idempotent, so a
                # failure mid-write that a retry then completes can leave
                # one torn JSONL line or a duplicate row
                retry_io(task.fn, tag="services")
                with self._lock:
                    self.completed += 1
            except BaseException as e:  # noqa: BLE001 — reported to main
                with self._lock:
                    if self._error is None:
                        self._error = e
                        self._error_tag = task.tag
                    # a failed worker stops accepting work; pending tasks
                    # are dropped so close()/drain() can't hang behind a
                    # poisoned writer
                    self._stop = True
                    self._queue.clear()
            finally:
                with self._lock:
                    self._busy = False
                    self._idle.notify_all()

    # -- dispatch-thread side -----------------------------------------------

    def submit(self, fn: Callable[[], None], *, tag: str = "",
               droppable: bool = True) -> bool:
        """Enqueue `fn` for the worker; returns False if it was rejected
        (executor stopped) or immediately displaced. When the queue is
        full, the oldest droppable task is discarded to make room; if
        nothing is droppable the NEW task blocks until space frees (never
        silently lost — non-droppable is reserved for barrier-adjacent
        work like final flushes)."""
        with self._lock:
            if self._stop:
                return False
            while len(self._queue) >= self.max_queue:
                victim = next((t for t in self._queue if t.droppable), None)
                if victim is not None:
                    self._queue.remove(victim)
                    self.dropped += 1
                else:
                    self._idle.wait(timeout=0.1)
                    if self._stop:
                        return False
                    continue
            self._queue.append(_Task(fn, tag, droppable))
            self._has_work.notify()
        return True

    def pending(self) -> int:
        with self._lock:
            return len(self._queue) + (1 if self._busy else 0)

    def raise_if_failed(self) -> None:
        """Propagate a worker failure to the calling (dispatch) thread."""
        with self._lock:
            err, tag = self._error, self._error_tag
        if err is not None:
            raise ServiceError(
                f"background host service {tag or 'task'!r} failed: "
                f"{err!r}") from err

    def drain(self, timeout: Optional[float] = None) -> None:
        """Barrier: block until every queued task has executed (or the
        worker failed — which re-raises). Called at checkpoint boundaries
        and on exit so telemetry ordered before a checkpoint is durable
        before training proceeds past it."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while (self._queue or self._busy) and self._error is None:
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"host-services drain timed out with "
                        f"{len(self._queue)} task(s) pending")
                self._idle.wait(timeout=remaining)
        self.raise_if_failed()

    def close(self, timeout: float = 30.0) -> None:
        """Drain then stop the worker. Safe to call twice. Re-raises a
        worker failure (after the thread is down) so close-on-exception
        paths still surface the original error."""
        try:
            self.drain(timeout=timeout)
        except TimeoutError:
            pass  # stop anyway; daemon thread cannot block interpreter exit
        finally:
            with self._lock:
                self._stop = True
                self._has_work.notify_all()
            self._worker.join(timeout=timeout)
        self.raise_if_failed()


class InlineServices:
    """Synchronous stand-in (`--async_services=false`): `submit` runs the
    task on the calling thread, at its call site and in its order.
    Exceptions propagate at once."""

    max_queue = 0
    dropped = 0
    completed = 0

    def submit(self, fn: Callable[[], None], *, tag: str = "",
               droppable: bool = True) -> bool:
        fn()
        self.completed += 1
        return True

    def pending(self) -> int:
        return 0

    def raise_if_failed(self) -> None:
        pass

    def drain(self, timeout: Optional[float] = None) -> None:
        pass

    def close(self, timeout: float = 30.0) -> None:
        pass


def make_services(async_services: bool, *,
                  max_queue: int = DEFAULT_QUEUE_DEPTH):
    """The trainer's one switch between the async executor and the
    inline escape hatch."""
    return HostServices(max_queue=max_queue) if async_services \
        else InlineServices()


class Staged:
    """A device tensor tree's host copy in flight: `get()` waits for the
    copy (on the worker) and returns the host tree."""

    __slots__ = ("_tree", "_event")

    def __init__(self, tree: Any, event: Optional["torch.cuda.Event"]):
        self._tree = tree
        self._event = event

    def get(self) -> Any:
        if self._event is not None:
            self._event.synchronize()
        return self._tree


def _host_tree(tree: Any, copy) -> Any:
    if isinstance(tree, dict):
        return {k: _host_tree(v, copy) for k, v in tree.items()}
    return copy(tree) if isinstance(tree, torch.Tensor) else tree


def stage(tree: Any) -> Staged:
    """Start the host copy of every tensor in `tree` (nested dicts) now, on
    the dispatch thread: a CUDA tensor into fresh pinned memory on the
    current stream (no host sync), one event behind the last copy; a CPU
    tensor cloned. The tree's tensors may then be overwritten by the next
    dispatch."""
    event = None

    def copy(t: torch.Tensor) -> torch.Tensor:
        nonlocal event
        t = t.detach()
        if t.device.type != "cuda":
            return t.clone()
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        if event is None:
            event = torch.cuda.Event()
        return buf

    host = _host_tree(tree, copy)
    if event is not None:
        event.record()
    return Staged(host, event)
