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

import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from dcgan_tpu.serve import fleet as j_fleet
from dcgan_tpu.serve import router as j_router
from dcgan_tpu.serve import server as j_server
from dcgan_tpu_torch.config import ModelConfig, TrainConfig, save_config
from dcgan_tpu_torch.convert import flatten
from dcgan_tpu_torch.serve import fleet as t_fleet
from dcgan_tpu_torch.serve import router as t_router
from dcgan_tpu_torch.serve import server as t_server
from dcgan_tpu_torch.serve.sources import (
    CheckpointSource, latest_finalized_step)
from dcgan_tpu_torch.train.steps import init_train_state, tree_map
from dcgan_tpu_torch.utils.checkpoint import Checkpointer
from torch_jax_draws import one_torch_thread  # noqa: F401

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
        failover drop; both packages give the same fleet report.

        The replicas' dispatch loops are held until their requests are
        queued, so the batches do not depend on how quick requests
        coalesce under the 5 ms deadline: the six requests are routed
        while every queue is held, replica 0 then takes its share and
        dies, and replicas 1 and 2 start only once its requests have
        failed over to their queues."""
        reports = {}
        for impl in IMPLS:
            fleet = fleets(impl, [FakeSource(explode_at=1), FakeSource(),
                                  FakeSource()])
            gates = [threading.Event() for _ in fleet.servers]
            for server, gate in zip(fleet.servers, gates):
                def held(orig=server._next_batch, gate=gate):
                    gate.wait(TIMEOUT)
                    return orig()
                server._next_batch = held
            fleet.start(timeout=TIMEOUT)
            fleet.router.stop_monitor()    # poll by hand: deterministic
            resps = [fleet.submit(2, client_id=f"c{i}") for i in range(6)]
            gates[0].set()
            deadline = time.monotonic() + TIMEOUT
            while sum(s.queue_depth() for s in fleet.servers[1:]) < 6:
                assert time.monotonic() < deadline, "no failover"
                time.sleep(0.005)
            for gate in gates[1:]:
                gate.set()
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


class LabelEcho(FakeSource):
    """A conditional fake: each image encodes its row's label."""

    def __init__(self, **kw):
        super().__init__(num_classes=5, **kw)

    def sample(self, bucket, z, labels=None):
        img = super().sample(bucket, z, labels)
        img[:, 0, 0, 0] = labels
        return img
