"""Failover router: health-checked dispatch over N sampler replicas (a
copy of `dcgan_tpu/serve/router.py`).

The router owns no device state and makes no CUDA call: it sees replicas
only through their thread-safe surface (`submit`, `queue_depth`, `beats`,
`poisoned`, `evict_pending`, `record_failover_drop`), so it runs on any
thread. Each replica has its own dispatch thread; the router is a client
of all of them.

Routing policy:
- least-queue-depth among healthy replicas, lowest index breaking ties
  (deterministic, so tests can pin the choice);
- sticky per-client routing: a `client_id`'s requests ride ONE replica,
  which preserves the server's per-client FIFO ordering guarantee across
  the fleet — re-picked only if the sticky replica leaves rotation;
- hedge-once failover: when a replica fails a request for a replica-side
  reason (worker death, stop, eviction — NOT overload, NOT a bad
  request), the router resubmits it to a healthy peer at most once; a
  second failure (or no healthy peer) fails the client request and is
  counted as a failover drop on the replica that failed it.

Health model:
- every replica's dispatch thread bumps a `beats` counter on each batcher
  iteration and after each dispatch; the monitor thread polls every
  `heartbeat_secs` and counts polls with NO progress — `miss_beats`
  consecutive silent polls drain the replica from rotation;
- a poisoned replica (dispatch thread died) is unhealthy immediately and
  permanently; a beat-silent replica that resumes beating is re-admitted
  (the slow-heartbeat false-positive path);
- on the healthy->unhealthy transition the router rescues the replica's
  parked queue (`evict_pending`): each evicted request's failover
  callback resubmits it to a healthy peer, so a wedged replica sheds its
  backlog instead of holding clients hostage.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from dcgan_tpu_torch.serve.server import (Response, ServeError,
                                          ServeOverloadError)

#: consecutive silent health polls before a replica leaves rotation
DEFAULT_MISS_BEATS = 4
#: health-poll cadence; beats bump at least every ~0.1s on a live worker
DEFAULT_HEARTBEAT_SECS = 0.25
#: hedge-once: a client request is submitted at most this many times
MAX_ATTEMPTS = 2


def promotion_targets(health: Dict[int, bool]) -> Tuple[int, ...]:
    """The replicas a weight promotion should target: exactly the
    healthy ones, ascending. A dead replica is never in the set, so a
    promotion never waits on one."""
    return tuple(sorted(i for i, ok in health.items() if ok))


class RouterError(ServeError):
    """No healthy replica could take the request."""


class Router:
    """Least-queue-depth dispatch with heartbeat health and hedge-once
    failover over a fixed replica list. Thread-safe; replicas are
    addressed by list index."""

    def __init__(self, replicas, *,
                 heartbeat_secs: float = DEFAULT_HEARTBEAT_SECS,
                 miss_beats: int = DEFAULT_MISS_BEATS):
        if not replicas:
            raise ValueError("router needs at least one replica")
        if miss_beats < 1:
            raise ValueError(f"miss_beats must be >= 1, got {miss_beats}")
        self._replicas = list(replicas)
        self.heartbeat_secs = heartbeat_secs
        self.miss_beats = miss_beats
        self._lock = threading.Lock()
        self._healthy = {i: True for i in range(len(self._replicas))}
        self._last_beats = {i: -1 for i in range(len(self._replicas))}
        self._misses = {i: 0 for i in range(len(self._replicas))}
        self._sticky: Dict[Any, int] = {}
        self.failovers = 0          # requests rescued onto a peer
        self.failover_drops = 0     # requests no peer could absorb
        self.unhealthy_events: List[Tuple[int, str]] = []
        self._monitor_thread: Optional[threading.Thread] = None
        self._monitor_stop = threading.Event()

    # -- health -------------------------------------------------------------

    def health(self) -> Dict[int, bool]:
        """Index -> healthy, the promotion_targets input."""
        with self._lock:
            return {i: (ok and not self._replicas[i].poisoned())
                    for i, ok in self._healthy.items()}

    def healthy_indices(self) -> Tuple[int, ...]:
        return tuple(i for i, ok in self.health().items() if ok)

    def mark_unhealthy(self, idx: int, reason: str) -> None:
        """Drain replica `idx` from rotation and rescue its parked
        queue. Idempotent per transition; also the monitor's edge
        action."""
        with self._lock:
            if not self._healthy.get(idx, False):
                return
            self._healthy[idx] = False
            self.unhealthy_events.append((idx, reason))
        print(f"[dcgan_tpu_torch] serve fleet: replica {idx} UNHEALTHY "
              f"({reason}) — drained from rotation", flush=True)
        # outside the lock: evictions fire failover callbacks that
        # resubmit through pick()
        self._replicas[idx].evict_pending()

    def mark_healthy(self, idx: int) -> None:
        """Re-admit a replica whose heartbeat resumed (never a poisoned
        one — that is permanent)."""
        if self._replicas[idx].poisoned():
            return
        with self._lock:
            if self._healthy.get(idx, True):
                return
            self._healthy[idx] = True
            self._misses[idx] = 0
        print(f"[dcgan_tpu_torch] serve fleet: replica {idx} re-admitted "
              f"(heartbeat resumed)", flush=True)

    def poll_health(self) -> Dict[int, bool]:
        """One monitor tick: advance beat bookkeeping, apply unhealthy /
        re-admission transitions, return the post-tick health map.
        Callable directly from tests — the monitor thread just loops
        this."""
        for i, r in enumerate(self._replicas):
            if r.poisoned():
                self.mark_unhealthy(i, "poisoned")
                continue
            beats = r.beats
            with self._lock:
                progressed = beats != self._last_beats[i]
                self._last_beats[i] = beats
                if progressed:
                    self._misses[i] = 0
                else:
                    self._misses[i] += 1
                misses = self._misses[i]
            if progressed:
                self.mark_healthy(i)
            elif misses >= self.miss_beats:
                self.mark_unhealthy(
                    i, f"missed {misses} heartbeats")
        return self.health()

    def start_monitor(self) -> None:
        """Spawn the health-poll thread (daemon; touches no device)."""
        if self._monitor_thread is not None:
            return
        def _loop():
            while not self._monitor_stop.wait(self.heartbeat_secs):
                self.poll_health()
        self._monitor_thread = threading.Thread(
            target=_loop, name="dcgan-serve-health", daemon=True)
        self._monitor_thread.start()

    def stop_monitor(self) -> None:
        self._monitor_stop.set()
        if self._monitor_thread is not None:
            self._monitor_thread.join(5.0)
            self._monitor_thread = None

    # -- routing ------------------------------------------------------------

    def pick(self, client_id=None) -> int:
        """The replica for the next request: sticky client mapping while
        its replica is in rotation, else least queue depth among healthy
        replicas with lowest index breaking ties."""
        health = self.health()
        with self._lock:
            healthy = [i for i, ok in health.items() if ok]
            if not healthy:
                raise RouterError("no healthy replicas in rotation")
            if client_id is not None:
                stick = self._sticky.get(client_id)
                if stick in healthy:
                    return stick
            choice = min(healthy,
                         key=lambda i: (self._replicas[i].queue_depth(),
                                        i))
            if client_id is not None:
                self._sticky[client_id] = choice
            return choice

    def submit(self, num_images: int = 1, *,
               z: Optional[np.ndarray] = None,
               labels: Optional[np.ndarray] = None,
               seed: Optional[int] = None,
               client_id=None) -> Response:
        """Route one request; returns a client-facing Response that
        survives a replica death mid-flight (hedge-once). Raises
        RouterError only when NO replica is healthy at submit time."""
        client_resp = Response()
        req = {"attempts": 0, "settled": False,
               "lock": threading.Lock(),
               "kwargs": dict(z=z, labels=labels, seed=seed),
               "num_images": num_images, "client_id": client_id}
        idx = self.pick(client_id)
        self._submit_to(idx, client_resp, req)
        return client_resp

    def _submit_to(self, idx: int, client_resp: Response, req) -> None:
        req["attempts"] += 1
        resp = self._replicas[idx].submit(req["num_images"],
                                          **req["kwargs"])
        resp.add_done_callback(
            lambda r, i=idx: self._on_done(i, r, client_resp, req))

    @staticmethod
    def _retryable(err: BaseException) -> bool:
        """Replica-side failures are retryable; deliberate shedding
        (overload) and bad requests (ValueError) are the client's to
        see."""
        return not isinstance(err, (ServeOverloadError, ValueError))

    def _on_done(self, idx: int, resp: Response,
                 client_resp: Response, req) -> None:
        """Failover callback, run on the resolving thread. Settles the
        client response exactly once; a retryable replica failure with
        budget left resubmits to a healthy peer instead."""
        with req["lock"]:
            if req["settled"]:
                return
            err = resp.error
            if err is None:
                req["settled"] = True
                client_resp._resolve(resp.images, resp.meta)
                return
            retry = self._retryable(err) and req["attempts"] < MAX_ATTEMPTS
            if not retry:
                req["settled"] = True
        if req["settled"]:
            if err is not None:
                if self._retryable(err):
                    with self._lock:
                        self.failover_drops += 1
                    self._replicas[idx].record_failover_drop()
                client_resp._fail(err)
            return
        # hedge-once: the failed replica is excluded by its health (a
        # dead replica is poisoned or about to be marked), but exclude
        # it explicitly too in case the monitor has not ticked yet
        try:
            health = self.health()
            healthy = [i for i, ok in health.items()
                       if ok and i != idx]
            if not healthy:
                raise RouterError(
                    f"no healthy peer to absorb failover from replica "
                    f"{idx}")
            with self._lock:
                self.failovers += 1
                peer = min(healthy,
                           key=lambda i: (self._replicas[i].queue_depth(),
                                          i))
                if req["client_id"] is not None:
                    self._sticky[req["client_id"]] = peer
            self._submit_to(peer, client_resp, req)
        except Exception:  # no peer could take it: fail the client
            with req["lock"]:
                req["settled"] = True
            with self._lock:
                self.failover_drops += 1
            self._replicas[idx].record_failover_drop()
            client_resp._fail(err)
