"""The serving plane's dispatch thread: cold start, batch loop, drain (the
counterpart of `dcgan_tpu/serve/worker.py`).

Every CUDA call of the server happens on this one thread: the weight load,
the kernel build, the warm-up dispatches and every sampler dispatch. It
selects the source's device when it starts, so a server on `cuda:1` never
touches the card another thread has current. Callers only touch the
thread-safe queue.

- cold start: the source's `prepare()` (weight load), ladder resolution,
  and the source's `bind`: one eager warm-up dispatch per bucket rung and
  its capture as a CUDA graph, timed into the server's cold_ms and
  compile_ms breakdowns. The first dispatch also builds the CUDA kernels
  and lets cuDNN pick its algorithms, so live traffic pays neither;
- warm serving: `server._next_batch()` -> assemble z (and, for a
  conditional source, each row's label: the request's, or class 0 for a
  request without labels and for the padding rows) -> bucketed dispatch
  -> split images back per request, resolving Responses with latency
  accounting;
- weight promotion: a PromotionTicket popped from the batcher is the drain
  barrier (the loop is sequential, so the in-flight batch has resolved).
  `_promote` calls the source's `reload()`, which copies the newest
  finalized step (restored and checked on the promoter's thread when the
  ticket carries it staged) into the tensors the rungs were captured
  over, on this thread's stream, then replays every bound rung once (the
  prime) and resumes. It captures nothing: the ticket's
  `compile_requests_delta` is the source's captures during the
  promotion, 0;
- drain: once the server stops intake, the loop keeps flushing until the
  queue is empty (FIFO, same batching rules), then exits;
- chaos: before its n-th batch dispatch the replica consults the chaos
  plan (testing/chaos.py): a killed replica fails the batch and poisons
  itself, a hung one sleeps, a slow-beat one mutes its heartbeat;
- release: when the thread ends, for whatever reason, it calls the
  source's `close()`, which releases every captured rung and its graph
  pool.

A failure anywhere fails the in-flight requests and poisons the server.
The one exception is a reload that fails before it copies anything: only
its ticket fails and the old weights keep serving.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from dcgan_tpu_torch.serve.server import PromotionTicket, ServeError
from dcgan_tpu_torch.testing import chaos


class ServeWorker:
    """Single dispatch thread bound to one SamplerServer."""

    def __init__(self, server):
        self._server = server
        name = "dcgan-torch-serve-dispatch" if server.replica_index == 0 \
            else f"dcgan-torch-serve-dispatch-{server.replica_index}"
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        # 1-based count of this replica's batch dispatches (the chaos
        # plan's replica faults are keyed by it)
        self._dispatch_index = 0

    def start(self) -> None:
        self._thread.start()

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)

    def is_alive(self) -> bool:
        return self._thread.is_alive()

    # -- the dispatch thread ------------------------------------------------

    def _run(self) -> None:
        try:
            self._serve()
        finally:
            # the rungs' graph pools go now, not when the collector breaks
            # the cycle between a program and its source
            self._server.source.close()

    def _serve(self) -> None:
        s = self._server
        try:
            device = getattr(s.source, "device", None)
            if device is not None and device.type == "cuda":
                torch.cuda.set_device(device)
            self._cold_start()
        except Exception as e:  # reported to every caller, server poisoned
            s._fail_all(e)
            s._ready.set()
            return
        s._t_warm = time.monotonic()
        s._ready.set()
        while True:
            batch = s._next_batch()
            if batch is None:
                return
            if isinstance(batch, PromotionTicket):
                try:
                    self._promote(batch)
                except Exception as e:  # the prime failed: poisoned
                    batch._fail(e)
                    s._fail_all(e)
                    return
                continue
            spans, total = batch
            self._dispatch_index += 1
            idx = self._dispatch_index
            try:
                # the chaos plan's replica faults (testing/chaos.py), at
                # the JAX worker's points of the loop
                mute = chaos.maybe_replica_slow_beat(s.replica_index, idx)
                if mute:
                    s._mute_beats(mute)
                chaos.maybe_replica_hang(s.replica_index, idx)
                if chaos.should_kill_replica(s.replica_index, idx):
                    raise ServeError(
                        f"chaos: replica {s.replica_index} killed "
                        f"before dispatch {idx}")
                self._dispatch(spans, total)
                s._bump_beat()
            except Exception as e:  # fails this batch and poisons the server
                for p, _ in spans:
                    p.resp._fail(e)
                s._fail_all(e)
                return

    def _cold_start(self) -> None:
        s = self._server
        t0 = time.perf_counter()
        s.meta = s.source.prepare()
        t_restore = time.perf_counter()
        s.ladder = s._resolve_ladder()
        # one eager warm-up dispatch per rung, then its capture: a broken
        # rung fails the cold start loudly instead of the first request
        s.source.bind(s.source.bucket_plan(s.ladder))
        s.compile_ms = dict(s.source.compile_ms)
        s._captures_at_warm = s.source.captures
        t_warm = time.perf_counter()
        s.cold_ms = {
            "restore_ms": (t_restore - t0) * 1e3,
            "warmup_ms": (t_warm - t_restore) * 1e3,
            "cold_start_ms": (t_warm - t0) * 1e3,
        }

    def _promote(self, ticket: PromotionTicket) -> None:
        """Swap to the newest finalized step, on the dispatch thread after
        the in-flight batch resolved. A reload that raises fails only the
        ticket (it raises before it copies a leaf, so the old weights
        serve on); a prime that raises is raised (the caller poisons the
        server: the swapped weights could not dispatch)."""
        s = self._server
        reload_fn = getattr(s.source, "reload", None)
        if reload_fn is None:
            ticket._fail(ServeError(
                f"{type(s.source).__name__} does not support weight "
                "promotion (no reload())"))
            return
        base = s.source.captures
        t0 = time.perf_counter()
        try:
            meta = reload_fn() if ticket.staged is None \
                else reload_fn(ticket.staged)
        except Exception as e:  # the replica survives on its old weights
            ticket._fail(e)
            return
        # the prime: one replay per bound rung, on the stream the reload
        # copied on, so no later replay can read half-copied weights
        for b in s.source.compiled_buckets():
            s.source.sample(b, np.zeros((b, s.source.z_dim), np.float32))
        swap_ms = (time.perf_counter() - t0) * 1e3
        s.meta.update(meta)
        s.promotions += 1
        s.promote_swap_ms = swap_ms
        s._bump_beat()
        ticket._resolve({"replica": s.replica_index,
                         "step": meta.get("step"),
                         "swap_ms": swap_ms,
                         "compile_requests_delta": s.source.captures - base})

    def _dispatch(self, spans: List[Tuple], total: int) -> None:
        s = self._server
        # re-check caller-provided latent widths against the now-resolved
        # z_dim: a bad-width request that slipped in during the cold start
        # fails ITS response here, never the server
        bad = [(p, take) for p, take in spans
               if p.z is not None and p.z.shape[1] != s.source.z_dim]
        if bad:
            for p, _ in bad:
                p.resp._fail(ValueError(
                    f"z width {p.z.shape[1]} != source z_dim "
                    f"{s.source.z_dim}"))
            spans = [sp for sp in spans if sp not in bad]
            total = sum(take for _, take in spans)
            if not spans:
                return
        bucket = s.ladder.snap(total)
        t0 = time.monotonic()
        z_rows, lbl_rows = [], []
        conditional = s.source.num_classes > 0
        for p, take in spans:
            if p.t_first_dispatch is None:
                p.t_first_dispatch = t0
            z_rows.append(p.take_z(take, s.source.z_dim, s.seed))
            if conditional:
                lbl_rows.append(p.take_labels(take))
        pad = bucket - total
        if pad:
            # padding rows are throwaway work: z=0 is a valid latent, the
            # rows are sliced off before any response sees them
            z_rows.append(np.zeros((pad, s.source.z_dim), np.float32))
            if conditional:
                lbl_rows.append(np.zeros((pad,), np.int32))
        labels = np.concatenate(lbl_rows) if conditional else None
        imgs = s.source.sample(bucket, np.concatenate(z_rows), labels)
        infer_ms = (time.monotonic() - t0) * 1e3
        s._record_batch(bucket, pad)
        offset = 0
        for p, take in spans:
            p.parts.append(imgs[offset:offset + take])
            p.buckets.append(bucket)
            p.infer_ms += infer_ms
            p.delivered += take
            offset += take
            if p.delivered == p.num_images:
                total_ms = (time.monotonic() - p.t_submit) * 1e3
                p.resp._resolve(
                    np.concatenate(p.parts) if len(p.parts) > 1
                    else p.parts[0],
                    {"queue_ms": (p.t_first_dispatch - p.t_submit) * 1e3,
                     "infer_ms": p.infer_ms,
                     "total_ms": total_ms,
                     "buckets": list(p.buckets)})
                s._record_done(p, total_ms)
