"""Continued from test_torch_fleet.py: The port's serving fleet on the CPU
(`dcgan_tpu_torch/serve/{router, fleet}.py`, promotion in `server.py`,
`worker.py`, `sources.py`)."""

import gc
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from dcgan_tpu_torch import graphs
from dcgan_tpu_torch.config import ModelConfig, TrainConfig, save_config
from dcgan_tpu_torch.convert import flatten
from dcgan_tpu_torch.serve import server as t_server
from dcgan_tpu_torch.serve.sources import CheckpointSource, WeightsSource
from dcgan_tpu_torch.utils.checkpoint import Checkpointer
from torch_jax_draws import one_torch_thread  # noqa: F401
from test_torch_fleet import (  # noqa: F401
    FakeSource, LabelEcho, MODEL, TIMEOUT, _fresh_images, _leaf_ptrs,
    _state, _work, fleets, inject_step, promotable_ckpt)


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
