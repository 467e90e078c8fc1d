"""The port's serving fleet on the CPU (`dcgan_tpu_torch/serve/{router,
fleet}.py`, promotion in `server.py`, `worker.py`, `sources.py`):

- the 16 fake-source scenarios of tests/test_fleet.py, on the port's
  `Router` and `ServeFleet` and on the JAX package's, with the same fake
  sources and replicas (copied here, with the port's source surface
  added): each runs on both, and the fleet reports of the deterministic
  ones are compared key by key (the counts exactly);
- its two end-to-end promotion cases on a port checkpoint: the images
  after a promotion equal a fresh source's on the new step bit for bit,
  every served leaf keeps its `data_ptr`, the promotion captures nothing,
  and the watcher promotes a newly finalized step;
- a reload that fails (a corrupt newest step, a source with no reload())
  fails only its ticket, and the old weights keep serving;
- the rungs are released when a server or a fleet stops, without the
  garbage collector;
- graphs.add_counts from many threads loses no count.
"""

import gc
import os
import shutil
import sys
import threading
import time

import numpy as np
import pytest
import torch

from dcgan_tpu.serve import fleet as j_fleet
from dcgan_tpu.serve import router as j_router
from dcgan_tpu.serve import server as j_server
from dcgan_tpu_torch import graphs
from dcgan_tpu_torch.config import ModelConfig, TrainConfig, save_config
from dcgan_tpu_torch.convert import flatten
from dcgan_tpu_torch.serve import fleet as t_fleet
from dcgan_tpu_torch.serve import router as t_router
from dcgan_tpu_torch.serve import server as t_server
from dcgan_tpu_torch.serve.sources import CheckpointSource, \
    WeightsSource, latest_finalized_step
from dcgan_tpu_torch.train.steps import init_train_state, tree_map
from dcgan_tpu_torch.utils.checkpoint import Checkpointer

TIMEOUT = 30.0

#: the two packages' serving planes, by name
IMPLS = {
    "port": (t_fleet, t_router, t_server),
    "jax": (j_fleet, j_router, j_server),
}


class FakeSource:
    """No-device source: images encode their latent's first coordinate,
    plus reload() so promotions work (tests/test_fleet.py's), with the
    port's source surface (device, capture count, rungs, close)."""

    device = torch.device("cpu")

    def __init__(self, granule=1, z_dim=4, num_classes=0, block=None,
                 explode_at=0):
        self.granule = granule
        self.z_dim = z_dim
        self.num_classes = num_classes
        self.block = block            # optional Event: stall dispatches
        self.explode_at = explode_at  # raise on the n-th sample (1-based)
        self.calls = []
        self.events = []              # interleaving probe: sample/reload
        self.step = 0
        self.compile_ms = {}
        self.captures = 0
        self.closed = 0

    def prepare(self):
        return {"source": "fake", "step": self.step, "weights": "live"}

    def bucket_plan(self, ladder):
        return []

    def bind(self, compiled):
        pass

    def compiled_buckets(self):
        return ()

    def close(self):
        self.closed += 1

    def reload(self):
        self.step += 1
        self.events.append("reload")
        return {"source": "fake", "step": self.step, "weights": "live"}

    def sample(self, bucket, z, labels=None):
        if self.block is not None:
            self.block.wait()
        if self.explode_at and len(self.calls) + 1 >= self.explode_at:
            raise RuntimeError("replica device on fire")
        self.calls.append((bucket, z.shape[0]))
        self.events.append("sample")
        img = np.zeros((bucket, 2, 2, 1), np.float32)
        img[:, 0, 0, 0] = z[:, 0]
        return img


class FakeReplica:
    """The replica surface the router sees, with scripted behavior."""

    def __init__(self, server_mod, depth=0, fail_with=None):
        self._server = server_mod
        self.depth = depth
        self.beats = 0
        self.is_poisoned = False
        self.fail_with = fail_with    # exception failing every submit
        self.responses = []           # unsettled Responses handed out
        self.evictions = 0
        self.failover_drops = 0

    def queue_depth(self):
        return self.depth

    def poisoned(self):
        return self.is_poisoned

    def submit(self, num_images=1, **kw):
        r = self._server.Response()
        self.responses.append(r)
        if self.fail_with is not None:
            r._fail(self.fail_with)
        return r

    def evict_pending(self):
        self.evictions += 1
        return 0

    def record_failover_drop(self, n=1):
        self.failover_drops += n


@pytest.fixture
def fleets():
    """Fleets a test makes: a failing test must leave no blocked worker
    alive, so every one is unblocked and stopped at teardown."""
    made = []

    def make(impl, sources, **kw):
        kw.setdefault("buckets", (4, 8))
        kw.setdefault("max_wait_ms", 5.0)
        f = IMPLS[impl][0].ServeFleet(sources, **kw)
        made.append(f)
        return f
    yield make
    for f in made:
        for s in f.servers:
            block = getattr(s.source, "block", None)
            if block is not None:
                block.set()
        try:
            f.stop(drain=False, timeout=10.0)
        except Exception:
            pass


def same_counts(reports):
    """The fleet reports of the two packages: the same keys, and the same
    value for every count (latencies and rates are timing)."""
    port, jax_ = reports["port"], reports["jax"]
    assert sorted(port) == sorted(jax_)
    timing = ("_ms", "samples_per_sec")
    for k in port:
        if not k.endswith(timing):
            assert port[k] == jax_[k], k


both = pytest.mark.parametrize("impl", sorted(IMPLS))


class TestPromotionTargets:
    @both
    def test_targets_are_sorted_healthy_indices(self, impl):
        targets = IMPLS[impl][1].promotion_targets
        assert targets({0: True, 1: True, 2: True}) == (0, 1, 2)
        assert targets({2: True, 0: True, 1: False}) == (0, 2)
        assert targets({0: False, 1: False}) == ()

    def test_sequence_is_the_committed_lattice(self):
        assert t_fleet.PROMOTION_SEQUENCE == ("drain", "swap", "prime",
                                              "resume")
        assert t_fleet.PROMOTION_SEQUENCE == j_fleet.PROMOTION_SEQUENCE
        assert t_fleet._SUM_KEYS == j_fleet._SUM_KEYS


class TestRouterPolicy:
    @both
    def test_least_queue_depth_lowest_index_tie_break(self, impl):
        _, rt, sv = IMPLS[impl]
        r = rt.Router([FakeReplica(sv, depth=2), FakeReplica(sv, depth=1),
                       FakeReplica(sv, depth=1)])
        assert r.pick() == 1          # min depth, lowest index wins ties
        r._replicas[1].depth = 5
        assert r.pick() == 2

    @both
    def test_unhealthy_and_poisoned_replicas_excluded(self, impl):
        _, rt, sv = IMPLS[impl]
        r = rt.Router([FakeReplica(sv), FakeReplica(sv, depth=9),
                       FakeReplica(sv)])
        r.mark_unhealthy(0, "test")
        assert r.pick() == 2          # depth 9 still beats unhealthy 0
        assert r._replicas[0].evictions == 1   # drain rescued its queue
        r._replicas[2].is_poisoned = True
        assert r.pick() == 1          # poisoned excluded without marking
        r.mark_unhealthy(1, "test")
        with pytest.raises(rt.RouterError, match="no healthy"):
            r.pick()

    @both
    def test_sticky_client_survives_depth_changes(self, impl):
        _, rt, sv = IMPLS[impl]
        r = rt.Router([FakeReplica(sv), FakeReplica(sv, depth=1)])
        assert r.pick(client_id="c") == 0
        r._replicas[0].depth = 50     # 1 is now far cheaper
        assert r.pick(client_id="c") == 0      # sticky: FIFO preserved
        assert r.pick(client_id="new") == 1    # new clients go by depth
        r.mark_unhealthy(0, "test")
        assert r.pick(client_id="c") == 1      # re-picked out of rotation

    @both
    def test_mark_healthy_readmits_but_never_poisoned(self, impl):
        _, rt, sv = IMPLS[impl]
        r = rt.Router([FakeReplica(sv), FakeReplica(sv)])
        r.mark_unhealthy(0, "test")
        r.mark_healthy(0)
        assert r.health()[0] is True
        r._replicas[1].is_poisoned = True
        r.mark_unhealthy(1, "poisoned")
        r.mark_healthy(1)
        assert r.health()[1] is False  # poisoning is permanent

    @both
    def test_poll_health_miss_beats_then_readmission(self, impl):
        _, rt, sv = IMPLS[impl]
        r = rt.Router([FakeReplica(sv), FakeReplica(sv)], miss_beats=3)
        r._replicas[1].beats = 5
        r.poll_health()                # baseline tick records beats
        for _ in range(2):
            r.poll_health()            # 2 silent polls: still in rotation
        assert r.health() == {0: True, 1: True}
        r.poll_health()                # 3rd silent poll: drained
        assert r.health() == {0: False, 1: False}
        r._replicas[0].beats += 1      # heartbeat resumes
        r.poll_health()
        assert r.health() == {0: True, 1: False}
        assert (0, "missed 3 heartbeats") in r.unhealthy_events

    @both
    def test_hedge_once_failover_rescues_request(self, impl):
        _, rt, sv = IMPLS[impl]
        dead = FakeReplica(sv, fail_with=sv.ServeError("worker died"))
        peer = FakeReplica(sv, depth=1)
        r = rt.Router([dead, peer])
        resp = r.submit(num_images=2, client_id="c")
        assert not resp.done()         # hedged onto the peer, in flight
        assert len(peer.responses) == 1
        img = np.zeros((2, 2, 2, 1), np.float32)
        peer.responses[0]._resolve(img, {"buckets": [4]})
        assert resp.result(1).shape == (2, 2, 2, 1)
        assert r.failovers == 1 and r.failover_drops == 0
        # the sticky mapping followed the failover
        assert r.pick(client_id="c") == 1

    @both
    def test_hedge_budget_is_one_retry(self, impl):
        _, rt, sv = IMPLS[impl]
        both_dead = [FakeReplica(sv, fail_with=sv.ServeError("worker died")),
                     FakeReplica(sv, fail_with=sv.ServeError("worker died"))]
        r = rt.Router(both_dead)
        resp = r.submit(num_images=1)
        with pytest.raises(sv.ServeError, match="worker died"):
            resp.result(1)
        assert rt.MAX_ATTEMPTS == 2
        assert sum(len(x.responses) for x in both_dead) == 2
        assert r.failovers == 1 and r.failover_drops == 1
        assert sum(x.failover_drops for x in both_dead) == 1

    @both
    def test_overload_and_bad_requests_are_not_hedged(self, impl):
        _, rt, sv = IMPLS[impl]
        shed = FakeReplica(sv, fail_with=sv.ServeOverloadError(
            "queue full", queue_depth=7, oldest_wait_ms=12.5))
        idle = FakeReplica(sv)
        r = rt.Router([shed, idle])
        resp = r.submit(num_images=1)
        with pytest.raises(sv.ServeOverloadError) as ei:
            resp.result(1)
        assert ei.value.queue_depth == 7
        assert ei.value.oldest_wait_ms == 12.5
        assert idle.responses == []    # deliberate shedding: no hedge
        assert r.failovers == 0 and r.failover_drops == 0


class TestFleetOverFakeSources:
    def test_replica_death_fails_over_zero_failed_requests(self, fleets):
        """One replica's source raises at its first dispatch: every client
        request still completes, the death is logged, and no request is a
        failover drop; both packages give the same fleet report."""
        reports = {}
        for impl in IMPLS:
            fleet = fleets(impl, [FakeSource(explode_at=1), FakeSource(),
                                  FakeSource()])
            fleet.start(timeout=TIMEOUT)
            fleet.router.stop_monitor()    # poll by hand: deterministic
            resps = [fleet.submit(2, client_id=f"c{i}") for i in range(6)]
            out = [r.result(TIMEOUT) for r in resps]
            fleet.router.poll_health()     # notice the poisoned worker
            fleet.stop(drain=True)
            assert all(o.shape == (2, 2, 2, 1) for o in out)
            rep = reports[impl] = fleet.report()
            assert rep["serve/completed"] == 6.0
            assert rep["serve/dropped_failover"] == 0.0
            assert rep["serve/fleet_unhealthy"] == 1.0
            assert rep["serve/fleet_failovers"] >= 1.0
            assert (0, "poisoned") in fleet.router.unhealthy_events
            assert [i for i, _ in fleet.stop_errors] == [0]
        same_counts(reports)

    @both
    def test_wedged_replica_backlog_rescued_by_heartbeat(self, impl,
                                                          fleets):
        """A replica blocked in dispatch stops beating; the monitor drains
        it and its never-dispatched backlog fails over to the peer. The
        in-flight request completes when the wedge clears, and the resumed
        heartbeat re-admits the replica."""
        block = threading.Event()
        wedged = FakeSource(block=block)
        fleet = fleets(impl, [wedged, FakeSource()], miss_beats=2)
        fleet.start(timeout=TIMEOUT)
        fleet.router.stop_monitor()
        block.clear()                  # wedge AFTER the warm-up
        first = fleet.submit(1, client_id="c")   # sticks to replica 0
        time.sleep(0.1)                # worker now blocked in sample
        parked = fleet.submit(1, client_id="c")  # queued behind the wedge
        # poll slower than the idle beat cadence (~0.1 s), like the real
        # monitor: an idle healthy peer must never accumulate misses
        deadline = time.monotonic() + 10.0
        while fleet.router.health()[0] and time.monotonic() < deadline:
            fleet.router.poll_health()
            time.sleep(0.15)
        assert fleet.router.health() == {0: False, 1: True}
        assert parked.result(10).shape == (1, 2, 2, 1)   # rescued
        assert fleet.router.failovers == 1
        block.set()                    # wedge clears: in-flight finishes
        assert first.result(10).shape == (1, 2, 2, 1)
        deadline = time.monotonic() + 10.0
        while not fleet.router.health()[0] \
                and time.monotonic() < deadline:
            fleet.router.poll_health()
            time.sleep(0.15)
        assert fleet.router.health()[0] is True   # re-admitted
        fleet.stop(drain=True)

    def test_muted_heartbeat_drains_then_readmits(self, fleets):
        """A replica that serves but stops beating for a while (muted) is
        drained from rotation, its new requests go to the peer, and it is
        re-admitted when its beats resume; a poisoned one never is."""
        fleet = fleets("port", [FakeSource(), FakeSource()], miss_beats=2)
        fleet.start(timeout=TIMEOUT)
        fleet.router.stop_monitor()
        fleet.servers[0]._mute_beats(0.6)
        deadline = time.monotonic() + 10.0
        while fleet.router.health()[0] and time.monotonic() < deadline:
            fleet.router.poll_health()
            time.sleep(0.15)
        assert fleet.router.health() == {0: False, 1: True}
        assert fleet.submit(1).result(TIMEOUT).shape == (1, 2, 2, 1)
        assert fleet.servers[0].submitted == 0
        deadline = time.monotonic() + 10.0
        while not fleet.router.health()[0] \
                and time.monotonic() < deadline:
            fleet.router.poll_health()
            time.sleep(0.15)
        assert fleet.router.health() == {0: True, 1: True}
        fleet.stop(drain=True)
        assert fleet.report()["serve/fleet_unhealthy"] == 1.0

    def test_promotion_drains_behind_inflight_batch(self, fleets):
        """The control op pops only between batches and ahead of queued
        requests: sample(in flight) -> reload -> sample(queued). The port
        counts the captures of the promotion (0); the JAX package without a
        compile cache reports None."""
        reports = {}
        for impl in IMPLS:
            block = threading.Event()
            block.set()
            src = FakeSource(block=block)
            fleet = fleets(impl, [src], max_wait_ms=1.0)
            fleet.start(timeout=TIMEOUT)
            block.clear()
            inflight = fleet.submit(1)
            time.sleep(0.1)            # worker blocked inside sample 1
            ticket = fleet.servers[0].request_promote()
            queued = fleet.submit(1)
            time.sleep(0.05)
            assert not ticket.done()   # promotion waits on the drain
            block.set()
            info = ticket.result(10)
            assert inflight.result(10) is not None
            assert queued.result(10) is not None
            fleet.stop(drain=True)
            assert src.events == ["sample", "reload", "sample"]
            assert info["replica"] == 0 and info["step"] == 1
            assert info["compile_requests_delta"] == \
                (0 if impl == "port" else None)
            rep = reports[impl] = fleet.report()
            assert rep["serve/promotions"] == 1.0
            assert rep["serve/promote_swap_ms"] >= 0.0
        same_counts(reports)

    def test_promote_targets_only_healthy_replicas(self, fleets):
        reports = {}
        for impl in IMPLS:
            fleet = fleets(impl, [FakeSource(explode_at=1), FakeSource(),
                                  FakeSource()])
            fleet.start(timeout=TIMEOUT)
            fleet.router.stop_monitor()
            fleet.submit(1).result(TIMEOUT)  # first pick poisons replica
            fleet.router.poll_health()       # 0; the request fails over
            results = fleet.promote()
            fleet.stop(drain=True)
            assert sorted(r["replica"] for r in results) == [1, 2]
            assert all("error" not in r for r in results)
            assert all(r["step"] == 1 for r in results)
            reports[impl] = fleet.report()
        same_counts(reports)

    def test_overload_split_and_telemetry_on_fleet_report(self, fleets):
        reports = {}
        for impl in IMPLS:
            block = threading.Event()
            src = FakeSource(block=block)
            fleet = fleets(impl, [src], max_queue=2, max_wait_ms=1.0)
            fleet.start(timeout=TIMEOUT)
            block.clear()
            first = fleet.submit(1)
            time.sleep(0.1)            # worker blocked: submits pile up
            shed = fleet.submit(1)
            fleet.submit(1)
            overflow = fleet.submit(1)  # displaces `shed` (drop-oldest)
            block.set()
            with pytest.raises(IMPLS[impl][2].ServeOverloadError) as ei:
                shed.result(10)
            assert ei.value.queue_depth >= 1
            assert ei.value.oldest_wait_ms >= 0.0
            first.result(10), overflow.result(10)
            fleet.stop(drain=True)
            rep = reports[impl] = fleet.report()
            assert rep["serve/dropped"] == 1.0
            assert rep["serve/dropped_overload"] == 1.0
            assert rep["serve/dropped_failover"] == 0.0
            assert fleet.servers[0].counters().serve_dropped_overload == 1
        same_counts(reports)

    def test_single_replica_fleet_matches_bare_server(self, fleets):
        """The router adds no transformation: the same latent rows through
        a 1-replica fleet and a bare server give the same images, in both
        packages."""
        z = np.random.default_rng(7).uniform(
            -1, 1, (5, 4)).astype(np.float32)
        reports = {}
        for impl in IMPLS:
            bare = IMPLS[impl][2].SamplerServer(FakeSource(), buckets=(4, 8),
                                                max_wait_ms=5.0)
            bare.start(timeout=TIMEOUT)
            want = bare.submit(z=z).result(10)
            bare.stop()
            fleet = fleets(impl, [FakeSource()])
            fleet.start(timeout=TIMEOUT)
            got = fleet.submit(z=z).result(10)
            fleet.stop(drain=True)
            np.testing.assert_array_equal(got, want)
            reports[impl] = fleet.report()
        same_counts(reports)


# ---------------------------------------------------------------------------
# End to end, on a port checkpoint on the CPU
# ---------------------------------------------------------------------------

MODEL = dict(output_size=16, gf_dim=8, df_dim=8, z_dim=8,
             compute_dtype="float32", use_pallas=True, pallas_fused=True)


def _state(cfg, step, scale):
    """A training state at `step` whose G weights are the seeded init's
    times `scale` (a stand-in for a trainer's update)."""
    state = init_train_state(cfg, device="cpu")
    state["params"]["gen"] = tree_map(lambda w: w * scale,
                                      state["params"]["gen"])
    state["ema_gen"] = tree_map(lambda w: w * (scale + 1.0),
                                state["ema_gen"])
    state["step"] = torch.tensor(step, dtype=torch.int32)
    return state


@pytest.fixture(scope="module")
def promotable_ckpt(tmp_path_factory):
    """Two checkpoint dirs of one lineage: `serve` holds only step 1 (what
    the fleet cold-starts on); `donor` holds step 2 (the newly finalized
    step a test delivers mid-serve)."""
    root = tmp_path_factory.mktemp("fleet")
    cfg = TrainConfig(model=ModelConfig(**MODEL), batch_size=4)
    serve_dir, donor_dir = str(root / "serve"), str(root / "donor")
    for d, steps in ((serve_dir, (1,)), (donor_dir, (1, 2))):
        save_config(cfg, d)
        ckpt = Checkpointer(d)
        for step in steps:
            ckpt.save(step, _state(cfg, step, 1.0 + step))
            ckpt.wait()
    return serve_dir, donor_dir


def inject_step(donor_dir, serve_dir, step):
    """Deliver `step` into `serve_dir` as the trainer does: the integrity
    manifest first, then the step copied under a temporary name and
    renamed in, so no reader sees a half-copied step."""
    integ = os.path.join(donor_dir, "integrity")
    dst = os.path.join(serve_dir, "integrity")
    os.makedirs(dst, exist_ok=True)
    for name in os.listdir(integ):
        if name.startswith(f"{step}."):
            shutil.copy2(os.path.join(integ, name), os.path.join(dst, name))
    tmp = os.path.join(serve_dir, f"tmp.promote.{step}")
    shutil.copytree(os.path.join(donor_dir, str(step)), tmp)
    os.rename(tmp, os.path.join(serve_dir, str(step)))


def _work(promotable_ckpt, tmp_path):
    serve_dir, donor_dir = promotable_ckpt
    work = str(tmp_path / "serve")
    shutil.copytree(serve_dir, work)
    assert latest_finalized_step(work) == 1
    return work, donor_dir


def _fresh_images(ckpt_dir, z, bucket):
    """A fresh source's images on the newest step, for rows z."""
    src = CheckpointSource(ckpt_dir, device="cpu")
    src.prepare()
    src.bind((bucket,))
    rows = np.zeros((bucket, z.shape[1]), np.float32)
    rows[:len(z)] = z
    out = src.sample(bucket, rows)[:len(z)]
    src.close()
    return out


def _leaf_ptrs(src):
    return {k: v.data_ptr() for k, v in
            flatten({"p": src._params, "s": src._state}).items()}


class TestPromotionEndToEnd:
    def test_promotion_serves_the_new_weights_in_place(
            self, promotable_ckpt, tmp_path, fleets):
        """A newly finalized step delivered mid-serve promotes with no
        capture; the images after it equal a fresh source's on the new
        step, bit for bit; every served leaf kept its address; no request
        failed or was dropped."""
        work, donor_dir = _work(promotable_ckpt, tmp_path)
        srcs = [CheckpointSource(work, device="cpu") for _ in range(2)]
        fleet = fleets("port", srcs, buckets=None, max_batch=8,
                       max_wait_ms=2.0)
        metas = fleet.start(timeout=TIMEOUT)
        assert [m["step"] for m in metas] == [1, 1]
        ptrs = [_leaf_ptrs(s) for s in srcs]
        z = np.random.default_rng(11).uniform(
            -1, 1, (6, 8)).astype(np.float32)
        before = fleet.submit(z=z).result(TIMEOUT)

        inject_step(donor_dir, work, 2)
        results = fleet.promote()
        assert [(r["replica"], r["step"], r["compile_requests_delta"])
                for r in results] == [(0, 2, 0), (1, 2, 0)]
        assert all(r["swap_ms"] > 0 for r in results)
        after = [fleet.submit(z=z, client_id=f"c{i}").result(TIMEOUT)
                 for i in range(2)]
        rep = fleet.report()
        fleet.stop(drain=True)
        assert [_leaf_ptrs(s) for s in srcs] == ptrs
        want = _fresh_images(work, z, 8)
        assert not np.array_equal(before, want)   # the swap was real
        for got in after:
            np.testing.assert_array_equal(got, want)
        assert rep["serve/recompiles_after_warmup"] == 0.0
        assert rep["serve/dropped"] == 0.0
        assert rep["serve/completed"] == 3.0
        assert rep["serve/promotions"] == 1.0

    def test_watcher_promotes_newly_finalized_step(
            self, promotable_ckpt, tmp_path, fleets):
        """The watch loop notices the renamed-in step and swaps it in
        without a promote() call, while a client keeps submitting."""
        work, donor_dir = _work(promotable_ckpt, tmp_path)
        fleet = fleets("port", [CheckpointSource(work, device="cpu")],
                       buckets=None, max_batch=8, max_wait_ms=2.0,
                       watch_promotions=True, watch_interval_secs=0.05)
        fleet.start(timeout=TIMEOUT)
        inject_step(donor_dir, work, 2)
        resps = []
        deadline = time.monotonic() + 60.0
        while not fleet.promotion_results \
                and time.monotonic() < deadline:
            resps.append(fleet.submit(2))
            time.sleep(0.02)
        fleet.stop(drain=True)
        assert fleet.promotion_results, "watcher never promoted"
        (result,) = fleet.promotion_results[0]
        assert result["step"] == 2 and "error" not in result
        assert result["compile_requests_delta"] == 0
        assert all(r.result(0).shape == (2, 16, 16, 3) for r in resps)

    def test_replica_serves_while_the_new_step_is_staged(
            self, promotable_ckpt, tmp_path):
        """The promotion's restore runs on the promoter's thread: a
        request submitted while it reads the disk is served, on the old
        weights, by the dispatch thread; the ticket then swaps step 2 in."""
        work, donor_dir = _work(promotable_ckpt, tmp_path)
        src = CheckpointSource(work, device="cpu")
        server = t_server.SamplerServer(src, buckets=(4,), max_wait_ms=1.0)
        server.start(timeout=TIMEOUT)
        z = np.random.default_rng(5).uniform(
            -1, 1, (2, 8)).astype(np.float32)
        before = server.submit(z=z).result(TIMEOUT)
        inject_step(donor_dir, work, 2)
        reading, release, threads = threading.Event(), threading.Event(), []
        real_restore = src._restore

        def restore():
            threads.append(threading.current_thread().name)
            reading.set()
            assert release.wait(TIMEOUT)
            return real_restore()
        src._restore = restore
        tickets = []
        promoter = threading.Thread(
            target=lambda: tickets.append(server.request_promote()))
        try:
            promoter.start()
            assert reading.wait(TIMEOUT)
            during = server.submit(z=z).result(TIMEOUT)
            release.set()
            promoter.join(TIMEOUT)
            assert tickets[0].result(TIMEOUT)["step"] == 2
            after = server.submit(z=z).result(TIMEOUT)
        finally:
            release.set()
            server.stop()
        np.testing.assert_array_equal(during, before)
        assert not np.array_equal(after, before)
        assert threads == [promoter.name]


class TestFailedPromotionKeepsServing:
    def test_corrupt_newest_step_fails_only_the_ticket(
            self, promotable_ckpt, tmp_path, fleets):
        work, donor_dir = _work(promotable_ckpt, tmp_path)
        fleet = fleets("port", [CheckpointSource(work, device="cpu")],
                       buckets=(8,), max_wait_ms=2.0)
        fleet.start(timeout=TIMEOUT)
        z = np.random.default_rng(3).uniform(
            -1, 1, (3, 8)).astype(np.float32)
        before = fleet.submit(z=z).result(TIMEOUT)
        inject_step(donor_dir, work, 2)
        path = os.path.join(work, "2", "state.npz")
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
        (result,) = fleet.promote()
        assert "failed verification" in result["error"]
        assert os.path.isdir(os.path.join(work, "2.corrupt"))
        np.testing.assert_array_equal(fleet.submit(z=z).result(TIMEOUT),
                                      before)
        assert fleet.router.health() == {0: True}
        fleet.stop(drain=True)
        assert fleet.stop_errors == []

    def test_source_without_reload_fails_the_ticket(self, tmp_path):
        from dcgan_tpu_torch import convert
        from dcgan_tpu_torch.models.dcgan import generator_init

        cfg = ModelConfig(**MODEL)
        p, s = generator_init(cfg, device="cpu")
        path = convert.save_weights(str(tmp_path / "g.npz"), cfg, p, s)
        server = t_server.SamplerServer(WeightsSource(path, device="cpu"),
                                        buckets=(2,), max_wait_ms=1.0)
        server.start(timeout=TIMEOUT)
        try:
            ticket = server.request_promote()
            with pytest.raises(t_server.ServeError, match="no reload"):
                ticket.result(TIMEOUT)
            assert not server.poisoned()
            assert server.submit(2).result(TIMEOUT).shape == (2, 16, 16, 3)
        finally:
            server.stop()
        assert server.report()["serve/completed"] == 1.0
        # a stopped server fails a ticket at once
        assert isinstance(server.request_promote().error,
                          t_server.ServeError)

    def test_reload_refuses_another_tree(self, promotable_ckpt, tmp_path):
        """A step whose generator differs in shape from the served one
        raises before it copies a leaf."""
        work, _ = _work(promotable_ckpt, tmp_path)
        src = CheckpointSource(work, device="cpu")
        src.prepare()
        for v in flatten(src._params).values():
            v.add_(1.0)               # differs from every leaf on disk
        served = {k: v.clone() for k, v in flatten(src._params).items()}
        src._params["proj"]["w"] = torch.zeros(3, 3)
        with pytest.raises(ValueError, match="proj/w"):
            src.reload()
        for k, v in flatten(src._params).items():
            if k != "proj/w":
                assert torch.equal(v, served[k]), k


class TestRungsReleasedOnStop:
    def _programs(self, srcs):
        return [prog for s in srcs for *_, prog in s._rungs.values()]

    def test_server_and_fleet_release_without_the_collector(
            self, promotable_ckpt, tmp_path, fleets):
        work, _ = _work(promotable_ckpt, tmp_path)
        collecting = gc.isenabled()
        gc.disable()
        try:
            src = CheckpointSource(work, device="cpu")
            server = t_server.SamplerServer(src, buckets=(1, 4),
                                            max_wait_ms=1.0)
            server.start(timeout=TIMEOUT)
            progs = self._programs([src])
            assert len(progs) == 2 and all(p.captured for p in progs)
            server.submit(3).result(TIMEOUT)
            server.stop()
            assert src._rungs == {}
            assert all(p.fn is None and p.outputs is None
                       and not p.captured for p in progs)

            srcs = [CheckpointSource(work, device="cpu") for _ in range(2)]
            fleet = fleets("port", srcs, buckets=(2, 4))
            fleet.start(timeout=TIMEOUT)
            progs = self._programs(srcs)
            assert len(progs) == 4
            fleet.submit(2).result(TIMEOUT)
            fleet.stop()
            assert all(s._rungs == {} for s in srcs)
            assert all(p.fn is None and not p.captured for p in progs)
        finally:
            if collecting:
                gc.enable()

    def test_failed_cold_start_releases_and_fails_the_fleet(self, fleets):
        class Broken(FakeSource):
            def prepare(self):
                raise RuntimeError("no weights")

        srcs = [FakeSource(), Broken()]
        fleet = fleets("port", srcs)
        with pytest.raises(t_server.ServeError, match="no weights"):
            fleet.start(timeout=TIMEOUT)
        assert [s.closed for s in srcs] == [1, 1]


class TestLaunchCounters:
    def test_add_counts_from_many_threads_loses_nothing(self):
        """Replays on several replicas' threads add their captures'
        counts at once: the counters end at replays x counts."""
        names = graphs.kernel_wrappers()
        delta = {name: (1, {}) for name in names}
        before = {name: fn.launches for name, fn in names.items()}
        threads, per = 8, 2000
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            workers = [threading.Thread(
                target=lambda: [graphs.add_counts(delta)
                                for _ in range(per)])
                for _ in range(threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(TIMEOUT)
                assert not w.is_alive()
        finally:
            sys.setswitchinterval(interval)
            graphs.add_counts(delta, -threads * per)
        for name, fn in names.items():
            assert fn.launches == before[name]


class LabelEcho(FakeSource):
    """A conditional fake: each image encodes its row's label."""

    def __init__(self, **kw):
        super().__init__(num_classes=5, **kw)

    def sample(self, bucket, z, labels=None):
        img = super().sample(bucket, z, labels)
        img[:, 0, 0, 0] = labels
        return img


class TestConditionalFleet:
    def test_labels_follow_requests_through_failover(self, fleets):
        """The router forwards each request's labels; a request rescued
        from a replica that died carries them to its peer, and a request
        without labels is served as class 0."""
        fleet = fleets("port", [LabelEcho(explode_at=1), LabelEcho()])
        fleet.start(timeout=TIMEOUT)
        fleet.router.stop_monitor()
        labels = [np.arange(i, i + 3) % 5 for i in range(4)]
        resps = [fleet.submit(3, labels=lab, client_id=f"c{i}")
                 for i, lab in enumerate(labels)]
        plain = fleet.submit(2, client_id="x")
        for lab, r in zip(labels, resps):
            np.testing.assert_array_equal(r.result(TIMEOUT)[:, 0, 0, 0],
                                          lab)
        np.testing.assert_array_equal(plain.result(TIMEOUT)[:, 0, 0, 0],
                                      [0, 0])
        fleet.router.poll_health()
        fleet.stop(drain=True)
        assert fleet.report()["serve/fleet_failovers"] >= 1.0

    def test_conditional_bn_promotion_copies_the_tables(self, tmp_path,
                                                         fleets):
        """A conditional-BN checkpoint promoted from step 1 to 2: the cBN
        tables are copied into the served tensors at their addresses, no
        capture, and the images of each class equal a fresh source's on
        step 2 bit for bit."""
        cfg = TrainConfig(model=ModelConfig(**dict(
            MODEL, num_classes=3, conditional_bn=True, pallas_fused=False)),
            batch_size=4)
        work, donor = str(tmp_path / "serve"), str(tmp_path / "donor")
        def state_at(step):
            state = _state(cfg, step, 1.0 + step)
            for name, p in state["params"]["gen"].items():
                if name.startswith("bn"):   # per-class rows that differ
                    p["bias"] = p["bias"] + 0.3 * step * torch.arange(
                        3, dtype=torch.float32)[:, None]
            return state

        for d, steps in ((work, (1,)), (donor, (1, 2))):
            save_config(cfg, d)
            ckpt = Checkpointer(d)
            for step in steps:
                ckpt.save(step, state_at(step))
                ckpt.wait()
        srcs = [CheckpointSource(work, device="cpu")]
        fleet = fleets("port", srcs, buckets=None, max_batch=8,
                       max_wait_ms=2.0)
        fleet.start(timeout=TIMEOUT)
        ptrs = _leaf_ptrs(srcs[0])
        z = np.random.default_rng(3).uniform(-1, 1, (6, 8)).astype(
            np.float32)
        lab = np.array([0, 1, 2, 0, 1, 2], np.int32)
        before = fleet.submit(z=z, labels=lab).result(TIMEOUT)
        inject_step(donor, work, 2)
        (result,) = fleet.promote()
        after = fleet.submit(z=z, labels=lab).result(TIMEOUT)
        fleet.stop(drain=True)
        assert (result["step"], result["compile_requests_delta"]) == (2, 0)
        assert _leaf_ptrs(srcs[0]) == ptrs
        served = flatten(srcs[0]._params)
        new = flatten(state_at(2)["params"]["gen"])
        tables = [k for k in served if k.startswith("bn")]
        assert served["bn1/bias"].shape == (3, 8) and len(tables) == 4
        assert all(torch.equal(served[k], new[k]) for k in tables)
        fresh = CheckpointSource(work, device="cpu")
        fresh.prepare()
        fresh.bind((8,))
        rows, labels = np.zeros((8, 8), np.float32), np.zeros(8, np.int32)
        rows[:6], labels[:6] = z, lab
        want = fresh.sample(8, rows, labels)[:6]
        fresh.close()
        assert not np.array_equal(before, want)
        np.testing.assert_array_equal(after, want)
