"""The port's serving plane on the CPU: ladder, batcher, drain, backpressure,
and served images against the JAX generator on the same numpy z rows; the
CLI's fleet, promotion, int8, preset and events flags, the fleet report's
keys equal to the JAX fleet's."""

import dataclasses
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcgan_tpu.config import ModelConfig as JModelConfig
from dcgan_tpu.models import dcgan as jdcgan
from dcgan_tpu.serve import buckets as jbuckets
from dcgan_tpu_torch import convert
from dcgan_tpu_torch.config import ModelConfig
from dcgan_tpu_torch.serve import __main__ as serve_main
from dcgan_tpu_torch.serve.buckets import BucketLadder, build_ladder, \
    parse_buckets
from dcgan_tpu_torch.serve.server import SamplerServer, ServeError, \
    ServeOverloadError
from dcgan_tpu_torch.serve.sources import WeightsSource

TIMEOUT = 60.0


class FakeSource:
    """Echoes each dispatched batch's z rows back as its "images" and
    records the bucket of every dispatch; it captures nothing."""

    device = torch.device("cpu")

    def __init__(self, z_dim=4):
        self.z_dim = z_dim
        self.num_classes = 0
        self.granule = 1
        self.dispatches = []
        self._rungs = ()
        self.compile_ms = {}
        self.captures = 0

    def prepare(self):
        return {"source": "fake", "step": None, "weights": "-",
                "device": "cpu"}

    def bucket_plan(self, ladder):
        return tuple(ladder.buckets)

    def bind(self, rungs):
        self._rungs = tuple(rungs)

    def compiled_buckets(self):
        return self._rungs

    def close(self):
        self._rungs = ()

    def sample(self, bucket, z, labels=None):
        assert bucket in self._rungs and z.shape == (bucket, self.z_dim)
        self.dispatches.append((bucket, z.copy()))
        return z.copy()


@pytest.fixture
def servers():
    """Servers a test creates; stopped at teardown so no dispatch thread
    outlives its test."""
    made = []
    yield made
    for s in made:
        try:
            s.stop(drain=False, timeout=TIMEOUT)
        except ServeError:
            pass


def _z(seed, n, z_dim=4):
    return np.random.default_rng(seed).uniform(-1, 1, (n, z_dim)) \
        .astype(np.float32)


class TestBucketLadder:
    @pytest.mark.parametrize("max_batch,granule", [
        (64, 1), (1, 1), (48, 1), (64, 8), (20, 8), (7, 2)])
    def test_matches_jax_ladder(self, max_batch, granule):
        assert build_ladder(max_batch, granule).buckets == \
            jbuckets.build_ladder(max_batch, granule).buckets

    def test_snap_and_parse(self):
        ladder = build_ladder(64)
        assert ladder.buckets == (1, 2, 4, 8, 16, 32, 64)
        assert [ladder.snap(n) for n in (1, 3, 8, 9, 64, 100)] == \
            [1, 4, 8, 16, 64, 64]
        assert parse_buckets("8,2,4,,8").buckets == (2, 4, 8)
        with pytest.raises(ValueError):
            parse_buckets("2,x")
        with pytest.raises(ValueError):
            ladder.snap(0)

    @pytest.mark.parametrize("rungs,granule", [((), 1), ((4, 2), 1),
                                               ((2, 3), 2), ((0, 1), 1)])
    def test_invalid_ladders_raise(self, rungs, granule):
        with pytest.raises(ValueError):
            BucketLadder(buckets=rungs, granule=granule)


class TestBatcher:
    def test_padding_to_the_snapped_bucket(self, servers):
        src = FakeSource()
        s = SamplerServer(src, buckets=(2, 4, 8), max_wait_ms=0.0)
        servers.append(s)
        z = _z(0, 3)
        s.start(timeout=TIMEOUT)
        out = s.submit(z=z).result(TIMEOUT)
        np.testing.assert_array_equal(out, z)
        bucket, sent = src.dispatches[-1]
        assert bucket == 4
        np.testing.assert_array_equal(sent[3:], 0.0)   # the pad row
        s.stop()
        rep = s.report()
        assert rep["serve/pad_frac"] == 1 / 4
        assert rep["serve/completed"] == 1.0

    def test_fifo_drain_and_chunking(self, servers):
        """Requests queued before the warm start drain in FIFO order; one
        larger than the top bucket is chunked without reordering."""
        src = FakeSource()
        s = SamplerServer(src, buckets=(1, 2, 4), max_wait_ms=1e4)
        servers.append(s)
        zs = [_z(i, n) for i, n in enumerate((3, 6, 1, 2))]
        resps = [s.submit(z=z) for z in zs]
        s.start(timeout=TIMEOUT)
        s.stop(drain=True, timeout=TIMEOUT)
        for z, r in zip(zs, resps):
            np.testing.assert_array_equal(r.result(0), z)
        rows = np.concatenate([z for _, z in src.dispatches])
        # dispatched rows, minus the warm-up and pad rows (all zero), are
        # the requests' rows in submission order
        kept = rows[np.any(rows != 0.0, axis=1)]
        np.testing.assert_array_equal(kept, np.concatenate(zs))
        # 3+6+1+2 rows over a top bucket of 4: the 6-row request is split
        # across all three batches, each full or snapped to 4
        assert resps[1].meta["buckets"] == [4, 4, 4]
        assert [b for b, _ in src.dispatches][-3:] == [4, 4, 4]

    def test_drop_oldest_never_dispatched(self, servers):
        src = FakeSource()
        s = SamplerServer(src, buckets=(1, 2), max_queue=2)
        servers.append(s)
        a, b, c = (s.submit(z=_z(i, 1)) for i in range(3))
        assert a.done() and isinstance(a.error, ServeOverloadError)
        assert a.error.queue_depth == 2
        assert not b.done() and not c.done()
        s.start(timeout=TIMEOUT)
        s.stop(drain=True, timeout=TIMEOUT)
        np.testing.assert_array_equal(b.result(0), _z(1, 1))
        np.testing.assert_array_equal(c.result(0), _z(2, 1))
        assert s.report()["serve/dropped"] == 1.0
        assert s.counters().serve_dropped == 1

    def test_deadline_flush_below_top_bucket(self, servers):
        src = FakeSource()
        s = SamplerServer(src, buckets=(1, 2, 4, 8), max_wait_ms=5.0)
        servers.append(s)
        s.start(timeout=TIMEOUT)
        out = s.submit(2).result(TIMEOUT)    # never fills the top bucket
        assert out.shape == (2, 4)
        assert src.dispatches[-1][0] == 2

    def test_stopped_server_rejects_and_bad_z_raises(self, servers):
        src = FakeSource()
        s = SamplerServer(src, buckets=(1, 2))
        servers.append(s)
        s.start(timeout=TIMEOUT)
        with pytest.raises(ValueError, match="z width"):
            s.submit(z=np.zeros((1, 3), np.float32))
        s.stop()
        r = s.submit(1)
        assert r.done() and isinstance(r.error, ServeError)

    def test_dispatch_failure_poisons_the_server(self, servers):
        src = FakeSource()
        s = SamplerServer(src, buckets=(1, 2))
        servers.append(s)
        s.start(timeout=TIMEOUT)
        src._rungs = ()   # the next dispatch hits an unbound rung
        r = s.submit(1)
        with pytest.raises(AssertionError):
            r.result(TIMEOUT)
        assert s.poisoned()
        with pytest.raises(ServeError):
            s.stop()

    def test_requests_from_many_threads(self, servers):
        src = FakeSource()
        s = SamplerServer(src, buckets=(1, 2, 4, 8), max_wait_ms=1.0)
        servers.append(s)
        s.start(timeout=TIMEOUT)
        out = {}

        def client(i):
            out[i] = s.submit(z=_z(100 + i, 1 + i % 3))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
            assert not t.is_alive()
        s.stop(drain=True, timeout=TIMEOUT)
        for i, r in out.items():
            np.testing.assert_array_equal(r.result(0), _z(100 + i, 1 + i % 3))
        assert s.report()["serve/completed"] == 16.0


def _weights(tmp_path, **cfg_kw):
    """JAX-initialized generator weights (numpy) with nontrivial BN
    statistics, written through convert.save_weights."""
    rng = np.random.default_rng(3)
    jcfg = JModelConfig(**cfg_kw)
    params, state = jdcgan.generator_init(jax.random.key(3), jcfg)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = {name: {"mean": rng.normal(0, 0.05, s["mean"].shape)
                    .astype(np.float32),
                    "var": rng.uniform(0.002, 0.02, s["var"].shape)
                    .astype(np.float32)}
             for name, s in state.items()}
    tp, ts = convert.generator_from_jax(params, state, device="cpu")
    path = convert.save_weights(str(tmp_path / "g.npz"),
                                ModelConfig(**cfg_kw), tp, ts)
    return path, params, state, jcfg


class TestServedImages:
    CFG = dict(output_size=16, gf_dim=8, compute_dtype="float32",
               use_pallas=True, pallas_fused=True)

    def test_seeded_request_equals_jax_generator(self, tmp_path, servers):
        """The response to seed=s is the JAX generator on the same numpy z
        rows (the server's per-request stream): f32, 1e-4."""
        path, params, state, jcfg = _weights(tmp_path, **self.CFG)
        s = SamplerServer(WeightsSource(path, device="cpu"), max_batch=8,
                          max_wait_ms=1.0)
        servers.append(s)
        s.start(timeout=TIMEOUT)
        got = {seed: s.submit(n, seed=seed) for seed, n in ((11, 3),
                                                             (12, 10))}
        s.stop(drain=True, timeout=TIMEOUT)
        for seed, r in got.items():
            img = r.result(0)
            n = img.shape[0]
            z = np.random.default_rng(seed).uniform(
                -1.0, 1.0, (n, jcfg.z_dim)).astype(np.float32)
            want, _ = jdcgan.generator_apply(params, state, jnp.asarray(z),
                                             cfg=jcfg, train=False)
            want = np.asarray(want)
            assert img.shape == (n, 16, 16, 3) and img.dtype == np.float32
            assert want.std() > 0.05
            np.testing.assert_allclose(img, want, rtol=0, atol=1e-4)
        assert got[12].result(0).shape[0] == 10   # chunked over bucket 8

    def test_unbound_bucket_and_wrong_z_raise(self, tmp_path):
        path, *_ = _weights(tmp_path, **self.CFG)
        src = WeightsSource(path, device="cpu")
        src.prepare()
        src.bind((1, 2))
        assert src.compiled_buckets() == (1, 2)
        with pytest.raises(KeyError):
            src.sample(4, np.zeros((4, 100), np.float32))
        with pytest.raises(ValueError):
            src.sample(2, np.zeros((2, 99), np.float32))

    def test_cli_report_keys(self, tmp_path):
        path, *_ = _weights(tmp_path, **self.CFG)
        report = tmp_path / "report.json"
        row, responses = serve_main.run([
            "--weights", path, "--device", "cpu", "--max_batch", "4",
            "--demo_requests", "6", "--demo_rps", "500",
            "--demo_max_images", "3", "--report", str(report)])
        assert row["completed"] == 6 and row["failed"] == 0
        assert all(r.result(0).shape[1:] == (16, 16, 3) for r in responses)
        saved = json.loads(report.read_text())
        for key in ("serve/p50_ms", "serve/p99_ms", "serve/samples_per_sec",
                    "serve/pad_frac", "serve/cold_start_ms",
                    "serve/warmup_ms", "serve/restore_ms"):
            assert key in saved, key
        assert saved["buckets"] == [1, 2, 4]
        assert saved["device"] == "cpu"


MODEL = dict(output_size=16, gf_dim=8, df_dim=8, z_dim=8,
             compute_dtype="float32")
CKPT_FLAGS = ["--output_size", "16", "--gf_dim", "8", "--df_dim", "8",
              "--z_dim", "8", "--device", "cpu"]


def _save_step(directory, step, scale=1.0):
    """Save a training state at `step` (G's weights the seeded init's times
    `scale`) with its config.json, as the trainer does."""
    from dcgan_tpu_torch.config import TrainConfig, save_config
    from dcgan_tpu_torch.train.steps import init_train_state, tree_map
    from dcgan_tpu_torch.utils.checkpoint import Checkpointer

    cfg = TrainConfig(model=ModelConfig(**MODEL), batch_size=4)
    state = init_train_state(cfg, device="cpu")
    state["params"]["gen"] = tree_map(lambda w: w * scale,
                                      state["params"]["gen"])
    state["step"] = torch.tensor(step, dtype=torch.int32)
    save_config(cfg, directory)
    ckpt = Checkpointer(directory)
    ckpt.save(step, state)
    ckpt.wait()
    return state


def _jax_fleet_report_keys():
    """The key set of the JAX ServeFleet's report after one promotion, over
    a fake source."""
    from dcgan_tpu.serve.fleet import ServeFleet as JServeFleet

    class Fake(FakeSource):
        step = 0

        def bucket_plan(self, ladder):
            return []

        def reload(self):
            return {"source": "fake", "step": 1, "weights": "live"}

        def sample(self, bucket, z, labels=None):
            return z.copy()

    fleet = JServeFleet([Fake(), Fake()], buckets=(1, 2), max_wait_ms=1.0)
    fleet.start(timeout=TIMEOUT)
    try:
        fleet.submit(z=_z(0, 2)).result(TIMEOUT)
        fleet.promote()
    finally:
        fleet.stop()
    return set(fleet.report())


class TestCliFlags:
    def test_fleet_watch_promotions_and_events(self, tmp_path):
        """--fleet 2 --watch_promotions: a step finalized while the trace
        plays is promoted on both replicas with no capture and no failed
        request; the report's serve/* keys are the JAX fleet's, and
        --events_dir mirrors them into events.jsonl."""
        ckpt = str(tmp_path / "ckpt")
        _save_step(ckpt, 1, 2.0)
        trace = tmp_path / "trace.json"
        trace.write_text(json.dumps({"arrivals": [
            {"t_ms": 40.0 * i, "num_images": 1 + i % 3,
             "client": f"c{i % 4}"} for i in range(40)]}))
        saved = threading.Event()

        def deliver():
            # step 2 lands while the trace plays
            time.sleep(0.2)
            _save_step(ckpt, 2, 3.0)
            saved.set()
        saver = threading.Thread(target=deliver)
        saver.start()
        try:
            row, responses = serve_main.run([
                "--checkpoint_dir", ckpt, *CKPT_FLAGS, "--fleet", "2",
                "--watch_promotions", "--watch_interval_secs", "0.05",
                "--max_batch", "4", "--trace", str(trace), "--events_dir",
                str(tmp_path / "events"), "--report",
                str(tmp_path / "report.json")])
        finally:
            saver.join(TIMEOUT)
        assert saved.is_set()
        assert row["completed"] == 40 and row["failed"] == 0
        assert row["fleet"]["replicas"] == 2
        assert row["fleet"]["stop_errors"] == []
        promoted = [r for rnd in row["fleet"]["promotions"] for r in rnd]
        assert promoted and all(r["step"] == 2 for r in promoted)
        assert all(r["compile_requests_delta"] == 0 for r in promoted)
        assert row["serve/recompiles_after_warmup"] == 0
        keys = {k for k in row if k.startswith("serve/")}
        assert keys == _jax_fleet_report_keys()
        events = [json.loads(line) for line in
                  (tmp_path / "events" / "events.jsonl").read_text()
                  .splitlines()]
        assert [e["kind"] for e in events] == ["scalars"]
        assert set(events[0]["values"]) == keys
        assert events[0]["values"]["serve/fleet_replicas"] == 2.0
        assert json.loads((tmp_path / "report.json").read_text())[
            "fleet"]["replicas"] == 2

    def test_quantize_int8(self, tmp_path):
        from dcgan_tpu_torch.serve.quantize import quantize_dequantize_int8

        ckpt = str(tmp_path / "ckpt")
        state = _save_step(ckpt, 3, 2.0)
        row, responses = serve_main.run([
            "--checkpoint_dir", ckpt, *CKPT_FLAGS, "--quantize", "int8",
            "--max_batch", "4", "--demo_requests", "4", "--demo_rps",
            "500"])
        assert row["completed"] == 4
        _, report = quantize_dequantize_int8(state["params"]["gen"])
        assert row["meta"]["quantize"] == report
        assert row["meta"]["step"] == 3

    def test_preset_with_model_flags(self, tmp_path):
        """--preset supplies the architecture over config.json, the model
        flags over the preset (the JAX resolution): celeba64's bf16 compute
        with the 16 px widths."""
        from dcgan_tpu import config as j_config
        from dcgan_tpu_torch import config as t_config
        from dcgan_tpu_torch.serve.sources import CheckpointSource

        ckpt = str(tmp_path / "ckpt")
        _save_step(ckpt, 1, 2.0)
        overrides = dict.fromkeys(t_config.MODEL_OVERRIDE_FLAGS)
        overrides.update(output_size=16, gf_dim=8, df_dim=8, z_dim=8)
        src = CheckpointSource(ckpt, preset="celeba64", overrides=overrides,
                               device="cpu")
        src.prepare()
        want = j_config.resolve_model_config(ckpt, preset="celeba64",
                                             overrides=overrides)
        assert dataclasses.asdict(src.cfg) == dataclasses.asdict(want)
        assert src.cfg.compute_dtype == "bfloat16"
        row, _ = serve_main.run([
            "--checkpoint_dir", ckpt, "--preset", "celeba64", *CKPT_FLAGS,
            "--max_batch", "2", "--demo_requests", "3", "--demo_rps",
            "500", "--demo_max_images", "2"])
        assert row["completed"] == 3 and row["failed"] == 0


class LabelSource(FakeSource):
    """A conditional FakeSource: each dispatch's labels are recorded and
    returned, one per row, as the "images"."""

    def __init__(self, num_classes=3):
        super().__init__()
        self.num_classes = num_classes
        self.labels = []

    def sample(self, bucket, z, labels=None):
        super().sample(bucket, z, labels)
        assert labels is not None and labels.shape == (bucket,)
        assert labels.dtype == np.int32
        self.labels.append(labels.copy())
        return labels.astype(np.float32)


class TestConditionalServing:
    COND = dict(output_size=16, gf_dim=8, compute_dtype="float32",
                num_classes=3, conditional_bn=True, use_pallas=True)

    def test_labels_per_row_or_class_zero(self, servers):
        """Each row is dispatched with its request's label, a request
        without labels with class 0, the padding rows with class 0; a
        request chunked over two batches keeps its labels in order."""
        src = LabelSource()
        s = SamplerServer(src, buckets=(2, 4), max_wait_ms=0.0)
        servers.append(s)
        s.start(timeout=TIMEOUT)
        a = s.submit(z=_z(0, 3), labels=np.array([2, 1, 2])).result(TIMEOUT)
        b = s.submit(3).result(TIMEOUT)
        c = s.submit(z=_z(1, 6), labels=np.arange(6) % 3).result(TIMEOUT)
        np.testing.assert_array_equal(a, [2, 1, 2])
        np.testing.assert_array_equal(b, [0, 0, 0])
        np.testing.assert_array_equal(c, [0, 1, 2, 0, 1, 2])
        assert [lab.tolist() for lab in src.labels[:2]] == [[2, 1, 2, 0],
                                                           [0, 0, 0, 0]]

    def test_labels_length_checked_as_jax(self, servers):
        from dcgan_tpu.serve.server import SamplerServer as JServer

        errors = []
        for cls in (SamplerServer, JServer):
            s = cls(LabelSource())
            with pytest.raises(ValueError) as e:
                s.submit(3, labels=np.array([1, 2]))
            errors.append(str(e.value))
        assert errors[0] == errors[1] and "labels length" in errors[0]

    def test_served_images_equal_jax_with_labels(self, tmp_path, servers):
        """A conditional-BN generator served with labels (and one request
        without, class 0): the JAX generator on the same z rows and
        labels, f32 1e-4."""
        path, params, state, jcfg = _weights(tmp_path, **self.COND)
        src = WeightsSource(path, device="cpu")
        s = SamplerServer(src, max_batch=8, max_wait_ms=1.0)
        servers.append(s)
        s.start(timeout=TIMEOUT)
        assert src.num_classes == 3
        reqs = [(_z(5, 4, 100), np.array([0, 1, 2, 1], np.int32)),
                (_z(6, 3, 100), None),
                (_z(5, 4, 100), np.array([2, 2, 2, 2], np.int32))]
        got = [s.submit(z=z, labels=lab) for z, lab in reqs]
        s.stop(drain=True, timeout=TIMEOUT)
        jparams = jax.tree_util.tree_map(jnp.asarray, params)
        for (z, lab), r in zip(reqs, got):
            lab = np.zeros(len(z), np.int32) if lab is None else lab
            want, _ = jdcgan.generator_apply(
                jparams, state, jnp.asarray(z), cfg=jcfg, train=False,
                labels=jnp.asarray(lab))
            np.testing.assert_allclose(r.result(0), np.asarray(want),
                                       rtol=0, atol=1e-4)
        assert np.abs(got[0].result(0) - got[2].result(0)).max() > 1e-3

    def test_rung_labels_slot(self, tmp_path):
        """A bound rung copies the labels into its input tensor on every
        call: the same z under two labels gives two images, each the
        direct sampler's; no labels is class 0; a wrong length raises."""
        from dcgan_tpu_torch.models.dcgan import sampler_apply

        path, *_ = _weights(tmp_path, **self.COND)
        src = WeightsSource(path, device="cpu")
        src.prepare()
        src.bind((4,))
        z = _z(7, 4, 100)
        outs = {}
        for name, lab in (("a", [0, 1, 2, 0]), ("b", [2, 2, 1, 1]),
                          ("none", [0, 0, 0, 0])):
            lab = np.array(lab, np.int32)
            outs[name] = src.sample(4, z, None if name == "none" else lab)
            want = sampler_apply(src._params, src._state,
                                 torch.from_numpy(z), cfg=src.cfg,
                                 labels=torch.from_numpy(lab)).numpy()
            np.testing.assert_array_equal(outs[name], want)
        assert not np.array_equal(outs["a"], outs["b"])
        with pytest.raises(ValueError, match="labels must be"):
            src.sample(4, z, np.zeros(3, np.int32))
        src.close()
