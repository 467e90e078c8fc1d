"""The serving fleet: N replicas, one router, live weight promotion (the
counterpart of `dcgan_tpu/serve/fleet.py`).

A `ServeFleet` owns N in-process `SamplerServer` replicas, each with its
own weight source, its own dispatch thread (worker.py) and its own
captured bucket rungs, behind a `Router` (router.py) that dispatches by
least queue depth, watches each replica's heartbeat and fails requests
over onto healthy peers.

What failover covers. The replicas share one card and one CUDA context.
Failover covers failures at the Python level: an exception in a replica's
dispatch (its source raised) or a wedged replica (its heartbeat stopped).
A sticky CUDA error (an illegal address in a kernel) poisons the context
of the whole process, so it kills every replica at once: in-process
replicas do not isolate a device fault. Replicas on separate processes or
cards would.

Startup: replicas cold-start one after another. A capture synchronizes
the device, empties the cache and reads the device-wide reserved bytes to
size its graph pool (graphs.py), so a replica capturing while another
dispatches would corrupt both the capture and the pool figure. Once all
are warm, each replica's capture count is snapshotted again as the base of
`serve/recompiles_after_warmup`. A replica that fails its cold start fails
`start()`.

Promotion (`promote()`): the drain -> swap -> prime -> resume sequence
(`PROMOTION_SEQUENCE`), targeted at exactly the healthy replicas
(`router.promotion_targets`). Each target swaps behind its own dispatch
thread's drain barrier: the control op is taken only between batches, the
reload copies the newest finalized step into the tensors the rungs were
captured over, and one replay per rung primes them. A promotion never
captures (the ticket's `compile_requests_delta` is 0). Waits are per
ticket and bounded; an unhealthy replica is not in the target set.

An optional watcher thread polls the checkpoint directory for a newly
finalized step (an integer-named directory) and promotes it: weights go
from the trainer to the servers with no restart.

`stop()` stops the watcher, the monitor and then every replica; each
replica's dispatch thread releases its source's rungs as it ends
(`source.close()`), so the fleet's graph pools are gone when `stop()`
returns, without the garbage collector.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from dcgan_tpu_torch.serve.router import Router, promotion_targets
from dcgan_tpu_torch.serve.server import SamplerServer, ServeError, \
    _percentile

#: the promotion sequence, in order
PROMOTION_SEQUENCE = ("drain", "swap", "prime", "resume")

#: counters summed across replicas in the fleet report
_SUM_KEYS = ("serve/requests", "serve/completed", "serve/dropped",
             "serve/dropped_overload", "serve/dropped_failover",
             "serve/batches", "serve/images",
             "serve/recompiles_after_warmup")


class ServeFleet:
    """N health-checked sampler replicas behind a failover router.

    `sources` is one weight source per replica (each replica loads and
    serves its own copy). Server knobs are shared across replicas.
    """

    def __init__(self, sources: Sequence, *,
                 buckets: Optional[Sequence[int]] = None,
                 max_batch: int = 64,
                 max_queue: int = 256,
                 max_wait_ms: float = 10.0,
                 seed: int = 0,
                 heartbeat_secs: float = 0.25,
                 miss_beats: int = 4,
                 watch_promotions: bool = False,
                 watch_interval_secs: float = 0.5):
        if not sources:
            raise ValueError("fleet needs at least one source")
        self.servers = [
            SamplerServer(src, buckets=buckets, max_batch=max_batch,
                          max_queue=max_queue, max_wait_ms=max_wait_ms,
                          seed=seed, replica_index=i)
            for i, src in enumerate(sources)]
        self.router = Router(self.servers,
                             heartbeat_secs=heartbeat_secs,
                             miss_beats=miss_beats)
        self.watch_interval_secs = watch_interval_secs
        self._watch = watch_promotions
        self._watch_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._promotions = 0
        self._promoted_step: Optional[int] = None
        self.promotion_results: List[List[Dict[str, Any]]] = []
        self.stop_errors: List = []

    # -- lifecycle ----------------------------------------------------------

    def start(self, timeout: Optional[float] = None) -> List[dict]:
        """Cold-start every replica, one after another; snapshot every
        replica's capture count once all are warm; then start the health
        monitor and, if asked, the promotion watcher. Returns the
        per-replica source metadata. A replica that fails its cold start
        raises here, after the replicas started before it are stopped."""
        metas = []
        for s in self.servers:
            try:
                metas.append(s.start(timeout))
            except BaseException:
                self.stop(drain=False)
                raise
        for s in self.servers:
            s._captures_at_warm = s.source.captures
        step = metas[0].get("step")
        self._promoted_step = int(step) if step is not None else None
        self.router.start_monitor()
        if self._watch:
            self._watch_thread = threading.Thread(
                target=self._watch_loop, name="dcgan-torch-serve-promoter",
                daemon=True)
            self._watch_thread.start()
        return metas

    def submit(self, num_images: int = 1, *, z=None, labels=None,
               seed=None, client_id=None):
        """Route one request through the fleet; see Router.submit."""
        return self.router.submit(num_images, z=z, labels=labels,
                                  seed=seed, client_id=client_id)

    def stop(self, drain: bool = True, timeout: float = 120.0) -> List:
        """Stop the watcher, the monitor, then every replica. A replica
        that died already does not block the others' drain: its stop error
        is collected into `stop_errors` (and returned), not raised; its
        requests were failed over."""
        self._stop.set()
        if self._watch_thread is not None:
            self._watch_thread.join(5.0)
            self._watch_thread = None
        self.router.stop_monitor()
        errors: List = []
        for s in self.servers:
            try:
                s.stop(drain=drain, timeout=timeout)
            except Exception as e:  # collected, the other replicas go on
                errors.append((s.replica_index, repr(e)))
        self.stop_errors = errors
        return errors

    # -- promotion ----------------------------------------------------------

    def promote(self, timeout: float = 300.0) -> List[Dict[str, Any]]:
        """Swap every healthy replica to the newest finalized checkpoint
        step. Returns one result per target: {replica, step, swap_ms,
        compile_requests_delta} or {replica, error}."""
        targets = promotion_targets(self.router.health())
        if not targets:
            raise ServeError("no healthy replicas to promote")
        tickets = [(i, self.servers[i].request_promote())
                   for i in targets]
        results: List[Dict[str, Any]] = []
        ok = 0
        for i, t in tickets:
            try:
                results.append(t.result(timeout))
                ok += 1
            except Exception as e:  # per replica, reported in the result
                results.append({"replica": i, "error": repr(e)})
        if ok:
            self._promotions += 1
            good = [r for r in results if "error" not in r]
            print(f"[dcgan_tpu_torch] serve fleet: promoted "
                  f"{len(good)}/{len(results)} replica(s) to step "
                  f"{good[0].get('step')}", flush=True)
        self.promotion_results.append(results)
        return results

    def _watch_loop(self) -> None:
        """Poll the checkpoint directory for a newly finalized step and
        promote when one lands. Probe errors read as 'nothing new'."""
        probe = getattr(self.servers[0].source, "latest_step_on_disk",
                        None)
        if probe is None:
            return
        while not self._stop.wait(self.watch_interval_secs):
            step = probe()
            if step is None:
                continue
            if self._promoted_step is not None \
                    and step <= self._promoted_step:
                continue
            try:
                self.promote()
            except ServeError:
                continue  # no healthy replica right now; retry later
            self._promoted_step = step

    # -- reporting ----------------------------------------------------------

    def per_replica_reports(self) -> List[Dict[str, float]]:
        return [s.report() for s in self.servers]

    def report(self) -> Dict[str, float]:
        """The fleet's serve/* row: replica counters summed, latency
        percentiles recomputed over the merged samples, and the fleet's
        health, failover and promotion accounting."""
        rows = self.per_replica_reports()
        out: Dict[str, float] = {
            k: float(sum(r.get(k, 0.0) for r in rows))
            for k in _SUM_KEYS}
        out["serve/queue_depth_max"] = float(max(
            r.get("serve/queue_depth_max", 0.0) for r in rows))
        padded = sum(s.padded_rows for s in self.servers)
        dispatched = sum(s.dispatched_rows for s in self.servers)
        out["serve/pad_frac"] = padded / max(1, dispatched)
        lat = sorted(x for s in self.servers for x in s._latencies_ms)
        if lat:
            out["serve/p50_ms"] = _percentile(lat, 50.0)
            out["serve/p99_ms"] = _percentile(lat, 99.0)
        starts = [s._t_warm for s in self.servers
                  if s._t_warm is not None]
        ends = [s._t_drained for s in self.servers]
        if starts:
            end = max(e for e in ends if e is not None) \
                if any(e is not None for e in ends) else time.monotonic()
            span = end - min(starts)
            if span > 0:
                out["serve/samples_per_sec"] = \
                    out["serve/images"] / span
        out["serve/fleet_replicas"] = float(len(self.servers))
        out["serve/fleet_unhealthy"] = float(len(
            {i for i, _ in self.router.unhealthy_events}))
        out["serve/fleet_failovers"] = float(self.router.failovers)
        # fleet promote() rounds, or the replicas' ticket counts when a
        # caller promoted a server directly
        rounds = self._promotions or max(
            (s.promotions for s in self.servers), default=0)
        if rounds:
            out["serve/promotions"] = float(rounds)
            out["serve/promote_swap_ms"] = max(
                s.promote_swap_ms for s in self.servers)
        return out
