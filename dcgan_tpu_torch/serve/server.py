"""The sampler server: queue -> continuous batches -> bucketed dispatch (the
counterpart of `dcgan_tpu/serve/server.py`).

Callers `submit()` generation requests from any thread; one dispatch thread
(worker.py) assembles them into dynamic batches, snaps each batch UP to the
nearest bucket (buckets.py), runs the sampler at that bucket, and resolves
each request's `Response` with its images and latency accounting.

Batching policy, as in the JAX package:
- a flush happens when the pending work fills the LARGEST bucket or when
  the OLDEST pending request has waited `max_wait_ms` (the deadline flush);
- requests coalesce in FIFO order; a request larger than the top bucket is
  chunked across consecutive dispatches, never reordered against later
  arrivals (drain-on-stop keeps the same order);
- when the queue is full the OLDEST never-dispatched request is shed and
  its Response fails with `ServeOverloadError` (drop-oldest backpressure).

Weight promotion: `request_promote()` queues a control op that the
dispatch thread takes ahead of queued requests and only between batches
(the drain barrier); it reloads the source's weights into the tensors the
rungs were captured over and replays every rung once (worker.py). The
disk read and the checks run before, on the caller's thread, where the
source can stage them, so the replica pauses only for the copy. A
replica of a `ServeFleet` (fleet.py) also shows the router (router.py) its
liveness (`beats`), its load (`queue_depth()`), and lets it rescue its
untouched requests (`evict_pending()`) and count the requests no peer
could take (`record_failover_drop()`).

`report()` emits the same `serve/*` metric keys as the JAX server, with
`serve/compile_ms/<rung>` holding each rung's capture time and
`serve/recompiles_after_warmup` the captures after the cold start. On
stop the dispatch thread releases the source's captured rungs
(`source.close()`), so their graph pools do not wait for the garbage
collector.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from dcgan_tpu_torch.serve.buckets import BucketLadder, build_ladder

#: default request-queue bound: deep enough to absorb a burst several
#: buckets long, shallow enough that a wedged device sheds load quickly
DEFAULT_MAX_QUEUE = 256


class ServeError(RuntimeError):
    """The serving plane failed (startup, dispatch, or shutdown)."""


class ServeOverloadError(ServeError):
    """This request was shed by drop-oldest backpressure. `queue_depth` is
    the pending-request count at shed time and `oldest_wait_ms` how long
    the head of the queue had been waiting."""

    def __init__(self, msg: str, *, queue_depth: int = 0,
                 oldest_wait_ms: float = 0.0):
        super().__init__(msg)
        self.queue_depth = queue_depth
        self.oldest_wait_ms = oldest_wait_ms


class Response:
    """Future-like handle for one request, resolved by the dispatch thread.
    `meta` carries the latency accounting: queue_ms (submit -> first
    dispatch), infer_ms (dispatch + host copy, summed over chunks),
    total_ms (submit -> resolve), and the bucket size(s) it rode in."""

    def __init__(self) -> None:
        self._ev = threading.Event()
        self._cb_lock = threading.Lock()
        self._cbs: List[Any] = []
        self.images: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.meta: Dict[str, Any] = {}

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._ev.wait(timeout):
            raise TimeoutError("request not resolved within timeout")
        if self.error is not None:
            raise self.error
        return self.images

    def add_done_callback(self, fn) -> None:
        """Run `fn(self)` when the response resolves or fails; at once, on
        the calling thread, if it is done already. Callbacks run on the
        resolving thread (the router's failover hook)."""
        with self._cb_lock:
            if not self._ev.is_set():
                self._cbs.append(fn)
                return
        fn(self)

    # -- dispatch-thread side ---------------------------------------------

    def _finish(self) -> None:
        with self._cb_lock:
            self._ev.set()
            cbs, self._cbs = self._cbs, []
        for fn in cbs:
            fn(self)

    def _resolve(self, images: np.ndarray, meta: Dict[str, Any]) -> None:
        self.images = images
        self.meta.update(meta)
        self._finish()

    def _fail(self, err: BaseException) -> None:
        self.error = err
        self._finish()


class PromotionTicket:
    """Future-like handle for one weight-promotion control op, resolved by
    the replica's dispatch thread after drain -> swap -> prime -> resume;
    `info` carries {replica, step, swap_ms, compile_requests_delta}, and
    stage_ms when the source staged the new step on the caller's thread
    (swap_ms is then the copy and the prime only)."""

    def __init__(self) -> None:
        self._ev = threading.Event()
        self.info: Dict[str, Any] = {}
        self.error: Optional[BaseException] = None
        # the source's staged promotion (`stage_reload`), or None: the
        # dispatch thread then reloads from scratch
        self.staged: Any = None

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        if not self._ev.wait(timeout):
            raise TimeoutError("promotion not resolved within timeout")
        if self.error is not None:
            raise self.error
        return dict(self.info)

    def _resolve(self, info: Dict[str, Any]) -> None:
        self.info.update(info)
        self._ev.set()

    def _fail(self, err: BaseException) -> None:
        self.error = err
        self._ev.set()


class _Pending:
    """One queued request, tracked by the batcher."""

    __slots__ = ("num_images", "z", "labels", "seed", "serial", "resp",
                 "t_submit", "t_first_dispatch", "remaining", "delivered",
                 "parts", "buckets", "infer_ms", "cursor")

    def __init__(self, num_images: int, z: Optional[np.ndarray],
                 labels: Optional[np.ndarray], seed: Optional[int],
                 serial: int):
        self.num_images = num_images
        self.z = z
        self.labels = labels
        self.seed = seed
        self.serial = serial
        self.resp = Response()
        self.t_submit = time.monotonic()
        self.t_first_dispatch: Optional[float] = None
        self.remaining = num_images   # rows not yet taken into a batch
        self.delivered = 0            # rows already returned by dispatches
        self.parts: List[np.ndarray] = []
        self.buckets: List[int] = []
        self.infer_ms = 0.0
        self.cursor = 0               # next z row to hand to a batch

    def take_z(self, take: int, z_dim: int, base_seed: int) -> np.ndarray:
        """The next `take` latent rows: the caller-provided z, or rows drawn
        once per request from a deterministic per-request numpy stream (the
        JAX server's stream exactly, so one seed gives one z in both)."""
        if self.z is None:
            seed = self.seed if self.seed is not None \
                else (base_seed, self.serial)
            rng = np.random.default_rng(seed)
            self.z = rng.uniform(-1.0, 1.0, (self.num_images, z_dim)) \
                .astype(np.float32)
        rows = self.z[self.cursor:self.cursor + take]
        self.cursor += take
        return rows

    def take_labels(self, take: int) -> np.ndarray:
        """The labels of the rows the last `take_z` handed out: the
        caller's, or zeros (class 0) for a request without labels."""
        if self.labels is None:
            return np.zeros((take,), np.int32)
        start = self.cursor - take  # take_z has advanced the cursor
        return np.asarray(self.labels[start:start + take], np.int32)


class SamplerServer:
    """Continuous-batching generation server over one weight source.

    Lifecycle: `start()` spawns the dispatch thread, which cold-starts
    (weight load + one primed dispatch per bucket) and flips warm;
    `submit()` enqueues from any thread (accepted during cold start);
    `stop(drain=True)` stops intake, lets the worker drain the queue in
    FIFO order, and joins it. A worker failure fails the in-flight requests
    and poisons the server (later submits are rejected, `stop()` re-raises).
    `replica_index` is the server's position in a ServeFleet (0 alone).
    """

    def __init__(self, source, *, buckets: Optional[Sequence[int]] = None,
                 max_batch: int = 64,
                 max_queue: int = DEFAULT_MAX_QUEUE,
                 max_wait_ms: float = 10.0,
                 seed: int = 0,
                 replica_index: int = 0):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if max_wait_ms < 0:
            raise ValueError(
                f"max_wait_ms must be >= 0, got {max_wait_ms}")
        self.source = source
        self.max_batch = max_batch
        self.max_queue = max_queue
        self.max_wait_ms = max_wait_ms
        self.seed = seed
        self.replica_index = replica_index
        self._explicit_buckets = tuple(buckets) if buckets else None
        self.ladder: Optional[BucketLadder] = None   # set at cold start

        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._queue: "collections.deque[_Pending]" = collections.deque()
        self._control: "collections.deque[PromotionTicket]" = \
            collections.deque()
        self._draining = False
        self._started = False
        self._ready = threading.Event()
        self._error: Optional[BaseException] = None
        self._worker = None

        # counters, mutated under _lock
        self.submitted = 0
        self.completed = 0
        self.dropped = 0            # all sheds: overload + failover
        self.dropped_overload = 0   # drop-oldest backpressure sheds
        self.dropped_failover = 0   # abandoned by the router in failover
        self.batches = 0
        self.images_out = 0
        self.padded_rows = 0
        self.dispatched_rows = 0
        self.queue_depth_max = 0
        self.promotions = 0         # completed weight promotions
        self.promote_swap_ms = 0.0  # the last promotion's wall time
        self.beats = 0              # the dispatch thread's heartbeat
        self._beat_mute_until = 0.0
        self._serial = 0
        self._latencies_ms: List[float] = []

        # cold-start accounting, filled by the worker
        self.meta: Dict[str, Any] = {}
        self.cold_ms: Dict[str, float] = {}
        # {"sampler@b<rung>": capture ms}, and the source's capture count
        # when the cold start ended
        self.compile_ms: Dict[str, float] = {}
        self._captures_at_warm: Optional[int] = None
        self._t_warm: Optional[float] = None
        self._t_drained: Optional[float] = None

        from dcgan_tpu_torch.utils.metrics import CounterRegistry

        self.registry = CounterRegistry()
        self.registry.provide("serve_requests", lambda: self.submitted)
        self.registry.provide("serve_completed", lambda: self.completed)
        self.registry.provide("serve_dropped", lambda: self.dropped)
        self.registry.provide("serve_dropped_overload",
                              lambda: self.dropped_overload)
        self.registry.provide("serve_dropped_failover",
                              lambda: self.dropped_failover)
        self.registry.provide("serve_batches", lambda: self.batches)
        self.registry.provide("serve_queue", lambda: len(self._queue))

    # -- lifecycle ----------------------------------------------------------

    def start(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        """Spawn the dispatch thread and block until the plane is warm;
        returns the source metadata. Raises the cold-start error if startup
        failed."""
        from dcgan_tpu_torch.serve.worker import ServeWorker

        with self._lock:
            if self._started:
                raise ServeError("server already started")
            self._started = True
        self._worker = ServeWorker(self)
        self._worker.start()
        if not self._ready.wait(timeout):
            raise TimeoutError("serve cold start did not finish in time")
        self.raise_if_failed()
        return dict(self.meta)

    def submit(self, num_images: int = 1, *,
               z: Optional[np.ndarray] = None,
               labels: Optional[np.ndarray] = None,
               seed: Optional[int] = None) -> Response:
        """Enqueue one generation request; returns its Response. Never
        blocks on a full queue: the oldest never-dispatched request is shed
        instead, and a stopped/poisoned server fails the Response at once.
        `labels` [num_images] are the classes of a conditional model's
        images (none: class 0); an unconditional model ignores them."""
        if z is not None:
            z = np.asarray(z, np.float32)
            if z.ndim != 2:
                raise ValueError(f"z must be [n, z_dim], got {z.shape}")
            # z_dim is 0 until the cold start resolves it; the worker
            # re-checks at assembly so a cold-start-window submit with the
            # wrong width fails ITS response, not the server
            if self.source.z_dim and z.shape[1] != self.source.z_dim:
                raise ValueError(
                    f"z width {z.shape[1]} != source z_dim "
                    f"{self.source.z_dim}")
            num_images = z.shape[0]
        if num_images < 1:
            raise ValueError(f"num_images must be >= 1, got {num_images}")
        if labels is not None and len(labels) != num_images:
            raise ValueError(
                f"labels length {len(labels)} != num_images {num_images}")
        fail_after: List[Tuple[Response, BaseException]] = []
        with self._lock:
            if self._draining or self._error is not None:
                p = _Pending(num_images, z, labels, seed, -1)
                fail_after.append((p.resp, ServeError(
                    "server is stopped" if self._error is None else
                    f"server failed: {self._error!r}")))
            else:
                p = _Pending(num_images, z, labels, seed, self._serial)
                self._serial += 1
                self.submitted += 1
                rejected = False
                while len(self._queue) >= self.max_queue:
                    # shed the oldest NEVER-DISPATCHED request: a partly
                    # dispatched head already has device work banked. With
                    # nothing undispatched to shed, the NEW request is the
                    # one rejected.
                    depth = len(self._queue)
                    oldest_ms = (time.monotonic()
                                 - self._queue[0].t_submit) * 1e3
                    overload = ServeOverloadError(
                        f"request shed by drop-oldest backpressure "
                        f"(queue full at {self.max_queue}; depth {depth},"
                        f" oldest waited {oldest_ms:.1f}ms)",
                        queue_depth=depth, oldest_wait_ms=oldest_ms)
                    victim = next(
                        (q for q in self._queue if q.delivered == 0), None)
                    self.dropped += 1
                    self.dropped_overload += 1
                    if victim is None:
                        fail_after.append((p.resp, overload))
                        rejected = True
                        break
                    self._queue.remove(victim)
                    fail_after.append((victim.resp, overload))
                if not rejected:
                    self._queue.append(p)
                    self.queue_depth_max = max(self.queue_depth_max,
                                               len(self._queue))
                    self._work.notify_all()
        for resp, err in fail_after:
            resp._fail(err)
        return p.resp

    def stop(self, drain: bool = True, timeout: float = 120.0) -> None:
        """Stop intake; with drain=True the worker finishes every queued
        request in FIFO order first. Joins the worker and re-raises its
        failure, if any. Safe to call twice. A drain that outlives `timeout`
        raises TimeoutError."""
        fail_after: List[Tuple[Any, BaseException]] = []
        with self._lock:
            if not self._started:
                return
            self._draining = True
            if not drain:
                err = ServeError("server stopped before dispatch")
                while self._queue:
                    fail_after.append((self._queue.popleft().resp, err))
            # a promotion still queued when intake stops does not run
            while self._control:
                fail_after.append((self._control.popleft(), ServeError(
                    "server stopped before promotion")))
            self._work.notify_all()
        for fut, err in fail_after:
            fut._fail(err)
        if self._worker is not None:
            self._worker.join(timeout)
            if self._worker.is_alive():
                raise TimeoutError(
                    f"serve drain did not finish within {timeout}s; the "
                    "dispatch thread is still running and requests are NOT "
                    "all resolved")
        self.raise_if_failed()

    def request_promote(self) -> PromotionTicket:
        """Queue a weight-promotion control op; returns its ticket. A warm
        server's source that can `stage_reload()` restores and checks the
        new step here, on the calling thread, so the replica serves on
        while it reads the disk; a staging failure fails only the ticket.
        The dispatch thread takes the ticket ahead of queued requests once
        the in-flight batch is done, copies the weights in and replays
        every rung before serving on. A stopped or poisoned server fails
        the ticket at once."""
        t = PromotionTicket()
        fail: Optional[BaseException] = None
        stage = getattr(self.source, "stage_reload", None)
        if stage is not None and self._ready.is_set() \
                and self._error is None:
            t0 = time.perf_counter()
            try:
                t.staged = stage()
            except Exception as e:  # the replica keeps its old weights
                t._fail(e)
                return t
            t.info["stage_ms"] = (time.perf_counter() - t0) * 1e3
        with self._lock:
            if self._draining or self._error is not None:
                fail = ServeError(
                    "server is stopped" if self._error is None else
                    f"server failed: {self._error!r}")
            else:
                self._control.append(t)
                self._work.notify_all()
        if fail is not None:
            t._fail(fail)
        return t

    def evict_pending(self) -> int:
        """The router's rescue of an unhealthy replica: fail every queued
        request that no batch has taken rows from with a retryable
        ServeError, so its failover callback resubmits it to a peer.
        Requests already partly dispatched stay with this worker. Returns
        the count evicted."""
        with self._lock:
            keep = [p for p in self._queue if p.remaining < p.num_images]
            victims = [p.resp for p in self._queue
                       if p.remaining == p.num_images]
            self._queue.clear()
            self._queue.extend(keep)
        err = ServeError(
            f"request evicted from unhealthy replica {self.replica_index}")
        for resp in victims:
            resp._fail(err)
        return len(victims)

    def record_failover_drop(self, n: int = 1) -> None:
        """The router abandoned `n` requests that failed on this replica
        and no healthy peer could take; counted apart from overload."""
        with self._lock:
            self.dropped += n
            self.dropped_failover += n

    def queue_depth(self) -> int:
        """Pending-request count (the router's load signal)."""
        return len(self._queue)

    def poisoned(self) -> bool:
        """Whether the dispatch thread died (permanently unhealthy)."""
        return self._error is not None

    def raise_if_failed(self) -> None:
        err = self._error
        if err is not None:
            raise ServeError(f"serve dispatch thread failed: {err!r}") \
                from err

    # -- reporting ----------------------------------------------------------

    def counters(self):
        """One coherent CounterSnapshot."""
        return self.registry.snapshot()

    def report(self) -> Dict[str, float]:
        """The serve/* metric row: request, latency and throughput
        accounting plus the cold-start breakdown."""
        with self._lock:
            lat = sorted(self._latencies_ms)
            out: Dict[str, float] = {
                "serve/requests": float(self.submitted),
                "serve/completed": float(self.completed),
                "serve/dropped": float(self.dropped),
                "serve/dropped_overload": float(self.dropped_overload),
                "serve/dropped_failover": float(self.dropped_failover),
                "serve/batches": float(self.batches),
                "serve/images": float(self.images_out),
                "serve/queue_depth_max": float(self.queue_depth_max),
                "serve/pad_frac": (self.padded_rows
                                   / max(1, self.dispatched_rows)),
            }
            end = self._t_drained if self._t_drained is not None \
                else time.monotonic()
            if self._t_warm is not None and end > self._t_warm:
                out["serve/samples_per_sec"] = \
                    self.images_out / (end - self._t_warm)
        if lat:
            out["serve/p50_ms"] = _percentile(lat, 50.0)
            out["serve/p99_ms"] = _percentile(lat, 99.0)
            out["serve/mean_ms"] = float(np.mean(lat))
        if self.promotions:
            out["serve/promotions"] = float(self.promotions)
            out["serve/promote_swap_ms"] = self.promote_swap_ms
        for key, src in (("serve/restore_ms", "restore_ms"),
                         ("serve/warmup_ms", "warmup_ms"),
                         ("serve/cold_start_ms", "cold_start_ms")):
            if src in self.cold_ms:
                out[key] = self.cold_ms[src]
        for name, ms in self.compile_ms.items():
            out[f"serve/compile_ms/{name}"] = ms
        if self._captures_at_warm is not None:   # set by the cold start
            # the zero-recompile guarantee, measured: captures after the
            # cold start's (must stay 0: every batch replays a bound rung)
            out["serve/recompiles_after_warmup"] = float(
                self.source.captures - self._captures_at_warm)
        return out

    # -- worker side (dispatch thread only) ---------------------------------

    def _resolve_ladder(self) -> BucketLadder:
        """The bucket ladder for this run: the explicit buckets, else the
        source's hint (an artifact's sidecar), else the default doubling
        ladder under max_batch."""
        granule = self.source.granule
        rungs = self._explicit_buckets
        if rungs is None:
            rungs = getattr(self.source, "ladder_hint", lambda: None)()
            if not rungs:
                return build_ladder(self.max_batch, granule)
        return BucketLadder(buckets=tuple(sorted({int(b) for b in rungs})),
                            granule=granule)

    def _bump_beat(self) -> None:
        """The dispatch thread's heartbeat: bumped at every batcher wait and
        after every dispatch and promotion. A wedged worker stops bumping,
        which the router's monitor watches; `_mute_beats` silences it for a
        while (a replica that serves but looks dead)."""
        if time.monotonic() < self._beat_mute_until:
            return
        self.beats += 1

    def _mute_beats(self, secs: float) -> None:
        self._beat_mute_until = time.monotonic() + secs

    def _next_batch(self):
        """Block until work is due, then return it: a PromotionTicket
        (control ops first: the in-flight batch is done, so this is the
        drain barrier), a `(spans, total)` request batch (full top bucket,
        deadline, or drain), or None once draining and empty: the worker's
        exit signal."""
        with self._lock:
            while True:
                self._bump_beat()
                if self._control:
                    return self._control.popleft()
                if not self._queue:
                    if self._draining:
                        self._t_drained = time.monotonic()
                        return None
                    self._work.wait(0.1)
                    continue
                total = sum(p.remaining for p in self._queue)
                top = self.ladder.max_bucket
                now = time.monotonic()
                deadline = self._queue[0].t_submit + self.max_wait_ms / 1e3
                if total >= top or now >= deadline or self._draining:
                    return self._pop_spans(top)
                self._work.wait(min(deadline - now, 0.1))

    def _pop_spans(self, top: int) -> Tuple[List[Tuple[_Pending, int]],
                                            int]:
        spans: List[Tuple[_Pending, int]] = []
        total = 0
        while self._queue and total < top:
            p = self._queue[0]
            take = min(p.remaining, top - total)
            p.remaining -= take
            if p.remaining == 0:
                self._queue.popleft()
            spans.append((p, take))
            total += take
        return spans, total

    def _record_batch(self, bucket: int, pad: int) -> None:
        with self._lock:
            self.batches += 1
            self.padded_rows += pad
            self.dispatched_rows += bucket

    def _record_done(self, p: _Pending, total_ms: float) -> None:
        with self._lock:
            self.completed += 1
            self.images_out += p.num_images
            self._latencies_ms.append(total_ms)

    def _fail_all(self, err: BaseException) -> None:
        """Worker death: fail everything still queued (requests and
        promotions) and poison intake. Responses fail outside the lock, so
        the router's failover callbacks can resubmit them elsewhere."""
        victims: List[Any] = []
        with self._lock:
            self._error = err
            while self._queue:
                victims.append(self._queue.popleft().resp)
            while self._control:
                victims.append(self._control.popleft())
            self._work.notify_all()
        for fut in victims:
            fut._fail(err)


def _percentile(sorted_ms: List[float], pct: float) -> float:
    """Nearest-rank percentile over an ascending list."""
    idx = min(len(sorted_ms) - 1,
              max(0, int(round(pct / 100.0 * (len(sorted_ms) - 1)))))
    return sorted_ms[idx]
