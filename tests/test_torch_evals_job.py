"""The port's eval job and CLI on the CPU (`dcgan_tpu_torch/evals/job.py`,
`python -m dcgan_tpu_torch.evals`), held against the JAX package's
`dcgan_tpu/evals/job.py`:

- compute_fid with KID and PRDC on a tiny generator (16 px, gf 8, z 8),
  unconditional and conditional: one set of weights (numpy_init's, G's
  kernels scaled by 10 so that the images span tanh's range) in both
  packages through `convert.generator_from_jax`, the JAX z rows handed to
  the port (`draw_z`), the same real batches and the same tower npz
  (tools/export_feature_tower.py): every key of the result equal, FID
  and KID within JOB_TOL, the PRDC fractions within PRDC_TOL;
- the real-statistics npz written by either package loads in the other
  with every array equal, and the cache's validation errors are the JAX
  package's;
- the CLI on a tiny port checkpoint with --device cpu: one JSON line with
  the JAX CLI's keys, equal to compute_fid on the restored weights (live
  or --use_ema) with the port's z; a --real_stats rerun bit for bit;
  TFRecord shards with a uint8 manifest; its refusals (--multihost, no
  data, no checkpoint, no card); distributed scoring is refused.
"""

import importlib.util
import io
import json
import pathlib
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from dcgan_tpu.config import ModelConfig as JModelConfig
from dcgan_tpu.config import TrainConfig as JTrainConfig
from dcgan_tpu.evals import features as j_features
from dcgan_tpu.evals import job as j_job
from dcgan_tpu.models import sampler_apply as j_sampler_apply
from dcgan_tpu.train import steps as jsteps
from dcgan_tpu_torch import convert
from dcgan_tpu_torch.config import ModelConfig, TrainConfig
from dcgan_tpu_torch.data.synthetic import synthetic_batches, \
    write_image_tfrecords
from dcgan_tpu_torch.evals import __main__ as cli
from dcgan_tpu_torch.evals import features as t_features
from dcgan_tpu_torch.evals import job as t_job
from dcgan_tpu_torch.generate import generate_z
from dcgan_tpu_torch.models.dcgan import sampler_apply
from dcgan_tpu_torch.train import trainer
from dcgan_tpu_torch.train.steps import init_train_state
from dcgan_tpu_torch.utils.checkpoint import Checkpointer
from torch_jax_draws import numpy_init, one_torch_thread  # noqa: F401


ROOT = pathlib.Path(__file__).resolve().parent.parent
MODEL = dict(output_size=16, gf_dim=8, df_dim=8, z_dim=8,
             compute_dtype="float32")
N, B, POOL = 256, 32, 128
# FID and KID of the two packages: the same statistics code over features
# that differ by the f32 sampler's (1e-4, tests/test_torch_models.py) and
# the tower's (1e-5 relative) rounding
JOB_TOL = dict(rtol=1e-3, atol=1e-7)
# a PRDC fraction counts k-NN ball memberships: one flipped by rounding
# moves it by 1/POOL
PRDC_TOL = 2.0 / POOL
JAX_KEYS = sorted(["fid", "num_samples", "feature_dim", "kid", "kid_std",
                   "kid_pool", "precision", "recall", "density", "coverage",
                   "prdc_pool", "prdc_k", "step"])


@pytest.fixture(scope="module")
def tower(tmp_path_factory):
    """The JAX package's default tower at 16 px, narrowed (feature_dim 16,
    base_ch 8) so that 256 samples give full-rank covariances."""
    spec = importlib.util.spec_from_file_location(
        "export_feature_tower", ROOT / "tools" / "export_feature_tower.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    path = str(tmp_path_factory.mktemp("tower") / "tower16.npz")
    tool.main(["--image_size", "16", "--feature_dim", "16", "--base_ch",
               "8", "--out", path])
    return path


def _gen_weights(num_classes):
    """(JAX params, JAX BN state) of G from numpy_init, kernels x 10."""
    jcfg = JTrainConfig(model=JModelConfig(**MODEL,
                                           num_classes=num_classes),
                        batch_size=B)
    state = numpy_init(jsteps.make_train_step(jcfg).init, seed=3)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: a * 10 if p[-1].key == "w" else a,
        state["params"]["gen"])
    return jcfg.model, params, state["bn"]["gen"]


def _jax_z(seed):
    def draw(i):
        return np.asarray(jax.random.uniform(
            jax.random.fold_in(jax.random.key(seed), i), (B, 8),
            minval=-1.0, maxval=1.0))
    return draw


class TestComputeFidParity:
    @pytest.mark.parametrize("num_classes", [0, 3],
                             ids=["unconditional", "conditional"])
    def test_fid_kid_prdc_match_jax(self, tower, num_classes):
        jmodel, jparams, jbn = _gen_weights(num_classes)
        tparams, tbn = convert.generator_from_jax(jparams, jbn,
                                                  device="cpu")
        tmodel = ModelConfig(**MODEL, num_classes=num_classes)
        jsample = jax.jit(lambda z, labels=None: j_sampler_apply(
            jparams, jbn, z, cfg=jmodel, labels=labels))

        def tsample(z, labels=None):
            return sampler_apply(tparams, tbn, z, cfg=tmodel, labels=labels)

        stream = synthetic_batches(B, 16, 3, seed=1, pool=0)
        reals = [next(stream) for _ in range(N // B)]
        kw = dict(image_size=16, z_dim=8, num_samples=N, batch_size=B,
                  num_classes=num_classes, seed=5, feature_dim=16,
                  kid=True, kid_subset_size=64, kid_subsets=10,
                  kid_pool_size=POOL, prdc=True, prdc_k=3)
        want = j_job.compute_fid(
            jsample, iter(reals),
            feature_fn=j_features.make_npz_feature_fn(tower)[0], **kw)
        timings = {}
        got = t_job.compute_fid(
            tsample, iter(reals),
            feature_fn=t_features.make_npz_feature_fn(tower,
                                                      device="cpu")[0],
            draw_z=_jax_z(5), timings=timings, **kw)
        assert sorted(got) == sorted(want)
        for k in ("num_samples", "feature_dim", "kid_pool", "prdc_pool",
                  "prdc_k"):
            assert got[k] == want[k], k
        assert want["fid"] > 1e-3     # the two sides differ
        for k in ("fid", "kid", "kid_std"):
            np.testing.assert_allclose(got[k], want[k], **JOB_TOL,
                                       err_msg=k)
        for k in ("precision", "recall", "density", "coverage"):
            assert abs(got[k] - want[k]) <= PRDC_TOL, k
        assert set(timings) == {"real_s", "sampler_s", "tower_s",
                                "stats_s", "fid_s", "kid_s", "prdc_s"}

    def test_conditional_labels_cycle_across_batches(self):
        seen = []

        def sample(z, labels):
            seen.append(labels.numpy().copy())
            return torch.zeros((z.shape[0], 4, 4, 3))

        t_job.generator_stats(sample, lambda x: x.reshape(len(x), -1), 48,
                              num_samples=10, batch_size=4, z_dim=2,
                              num_classes=3)
        np.testing.assert_array_equal(np.concatenate(seen),
                                      np.arange(12) % 3)
        assert all(s.dtype == np.int32 for s in seen)

    def test_default_z_is_generate_z(self):
        zs = []
        t_job.generator_stats(
            lambda z: zs.append(z.numpy().copy()) or torch.zeros(
                (len(z), 1, 1, 1)),
            lambda x: x.reshape(len(x), -1), 1, num_samples=6,
            batch_size=3, z_dim=2, seed=9)
        for i, z in enumerate(zs):
            np.testing.assert_array_equal(z, generate_z(9, i, 3, 2))

    def test_stream_errors_match(self):
        for job in (j_job, t_job):
            with pytest.raises(ValueError, match="exhausted at 4/10"):
                job.stats_from_batches(lambda x: np.asarray(x)[:, :2],
                                       [np.zeros((4, 2))], 10, 2)
            with pytest.raises(ValueError, match="feature_dim required"):
                job.compute_fid(None, [], image_size=16,
                                feature_fn=lambda x: x)


def _side(n=40, dim=6, pool=True, capacity=16, seed=0):
    rng = np.random.default_rng(seed)
    stats = t_job.StreamingStats(dim)
    feats = rng.normal(size=(n, dim)).astype(np.float32)
    stats.update(feats)
    p = None
    if pool:
        p = t_job.FeaturePool(dim, capacity, seed=seed)
        p.update(feats)
    return stats, p


class TestRealStatsNpz:
    @pytest.mark.parametrize("writer,reader", [(t_job, j_job),
                                               (j_job, t_job)],
                             ids=["port_to_jax", "jax_to_port"])
    def test_cross_load(self, tmp_path, writer, reader):
        stats, pool = _side()
        path = str(tmp_path / "real")         # extensionless on purpose
        writer.real_side_to_npz(path, stats, pool)
        got, got_pool = reader.real_side_from_npz(path, need_pool=True)
        assert got.n == 40 and got.dim == 6
        np.testing.assert_array_equal(got._sum, stats._sum)
        np.testing.assert_array_equal(got._outer, stats._outer)
        np.testing.assert_array_equal(got_pool.features(), pool.features())
        assert (got_pool.n_seen, got_pool.capacity) == (40, 16)

    @pytest.mark.parametrize("case", ["n", "dim", "capacity", "no_pool",
                                      "both"])
    def test_cache_errors_match(self, tmp_path, case):
        path = str(tmp_path / "real.npz")
        t_job.real_side_to_npz(path, *_side(pool=case != "no_pool"))
        kw = dict(image_size=16, num_samples=40, feature_fn=lambda x: x,
                  feature_dim=6, kid=True, kid_pool_size=16,
                  real_cache_path=path)
        kw.update({"n": dict(num_samples=50), "dim": dict(feature_dim=7),
                   "capacity": dict(kid_pool_size=20), "no_pool": {},
                   "both": dict(real_side=_side())}[case])
        msgs = []
        for job in (j_job, t_job):
            with pytest.raises(ValueError) as e:
                job.compute_fid(None, [], **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


class TestMultiProcessRefused:
    def test_distributed_and_allgathers_raise(self):
        with pytest.raises(NotImplementedError, match="Queue A item 7"):
            t_job.compute_fid(None, [], image_size=16, distributed=True)
        stats, pool = _side()
        for call in (lambda: t_job.allgather_merge_stats(stats),
                     lambda: t_job.allgather_merge_pool(pool)):
            with pytest.raises(NotImplementedError, match="multi-process"):
                call()


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A port run of 2 steps whose EMA differs from its live G."""
    root = tmp_path_factory.mktemp("evals_cli")
    cfg = TrainConfig(model=ModelConfig(**MODEL), batch_size=4,
                      g_ema_decay=0.5, checkpoint_dir=str(root / "run"),
                      sample_every_steps=0, save_summaries_secs=1e9,
                      save_model_secs=1e9, tensorboard=False)
    trainer.train(cfg, synthetic_data=True, max_steps=2, device="cpu")
    return str(root / "run")


SMALL = ["--num_samples", "64", "--batch_size", "16", "--kid", "--prdc",
         "--kid_pool", "64", "--kid_subset_size", "16", "--kid_subsets",
         "5", "--device", "cpu"]


def _cli(argv):
    out = io.StringIO()
    with redirect_stdout(out):
        result = cli.main(argv)
    lines = out.getvalue().splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == result
    return result


class TestCli:
    @pytest.mark.parametrize("use_ema", [False, True], ids=["live", "ema"])
    def test_json_line_equals_compute_fid(self, ckpt, tmp_path, use_ema):
        args = ["--checkpoint_dir", ckpt, "--synthetic",
                "--real_stats", str(tmp_path / "real.npz")] + SMALL
        result = _cli(args + (["--use_ema"] if use_ema else []))
        assert sorted(result) == JAX_KEYS
        assert result["step"] == 2 and result["num_samples"] == 64
        # the same score by hand: the restored weights, the port's z
        state = Checkpointer(ckpt).restore_latest(init_train_state(
            TrainConfig(model=ModelConfig(**MODEL)), device="cpu"))
        gen = state["ema_gen"] if use_ema else state["params"]["gen"]
        want = t_job.compute_fid(
            lambda z: sampler_apply(gen, state["bn"]["gen"], z,
                                    cfg=ModelConfig(**MODEL)),
            synthetic_batches(16, 16, 3, seed=1, pool=0), image_size=16,
            z_dim=8, num_samples=64, batch_size=16, kid=True,
            kid_subset_size=16, kid_subsets=5, kid_pool_size=64, prdc=True,
            device="cpu")
        assert {k: v for k, v in result.items() if k != "step"} == want
        # the cached real side: the real pass skipped, the score the same
        assert _cli(args + (["--use_ema"] if use_ema else [])) == result

    def test_ema_and_live_differ(self, ckpt):
        base = ["--checkpoint_dir", ckpt, "--synthetic"] + SMALL
        assert _cli(base)["fid"] != _cli(base + ["--use_ema"])["fid"]

    def test_feature_npz_and_uint8_shards(self, ckpt, tower, tmp_path):
        data = tmp_path / "shards"
        write_image_tfrecords(str(data), num_examples=80, image_size=16,
                              record_dtype="uint8")
        (data / "dataset.json").write_text(json.dumps(
            {"image_size": 16, "channels": 3, "record_dtype": "uint8",
             "feature_name": "image_raw"}))
        result = _cli(["--checkpoint_dir", ckpt, "--data_dir", str(data),
                       "--feature_npz", tower] + SMALL)
        assert result["feature_dim"] == 16
        assert np.isfinite(result["fid"]) and result["fid"] > 0

    @pytest.mark.parametrize("extra,msg", [
        (["--synthetic", "--multihost"], "--multihost"),
        ([], "need --data_dir or --synthetic"),
        (["--synthetic", "--num_samples", "32", "--real_stats", "R"],
         "holds statistics over 64 examples"),
    ], ids=["multihost", "no_data", "cache_mismatch"])
    def test_refusals(self, ckpt, tmp_path, extra, msg):
        extra = [str(tmp_path / "r.npz") if a == "R" else a for a in extra]
        if "--real_stats" in extra:     # a cache over 64 samples first
            _cli(["--checkpoint_dir", ckpt, "--synthetic", "--real_stats",
                  extra[-1]] + SMALL)
        argv = ["--checkpoint_dir", ckpt] + SMALL + extra
        with pytest.raises(SystemExit, match=msg):
            cli.main(argv)

    def test_no_checkpoint(self, tmp_path):
        with pytest.raises(SystemExit, match="no checkpoint under"):
            cli.main(["--checkpoint_dir", str(tmp_path), "--synthetic",
                      "--output_size", "16", "--gf_dim", "8", "--df_dim",
                      "8", "--z_dim", "8", "--device", "cpu"])

    def test_default_device_is_the_card(self, ckpt):
        if torch.cuda.is_available():
            pytest.skip("checks the behaviour of a machine without a GPU")
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(["--checkpoint_dir", ckpt, "--synthetic"])
