"""The port's evals statistics and feature towers on the CPU
(`dcgan_tpu_torch/evals/{fid,kid,prdc,features}.py`), held against the
JAX package's (`dcgan_tpu/evals/`) on the same numpy inputs:

- StreamingStats, frechet_distance (also its jitter retry), FeaturePool
  (fill, reservoir and merge draws), the KID estimator and PRDC are the
  JAX package's numpy code, copied: the same float64 / float32 inputs
  give the same bits (assert_array_equal, ==);
- make_npz_feature_fn on one npz in both packages, at 16 and 32 px: the
  port's tower (conv2d_apply's XLA SAME pads, cuDNN or the CPU's conv)
  against JAX's `lax.conv_general_dilated` tower within TOWER_TOL (f32
  sums in another order);
- tools/export_feature_tower.py writes the JAX package's default random
  tower: its npz through JAX's make_npz_feature_fn gives
  make_random_feature_fn's features within EXPORT_TOL, and through the
  port's within TOWER_TOL;
- the port's own random tower: deterministic, its weights drawn on the
  CPU (the same on every device), its shapes the JAX tower's.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from dcgan_tpu.evals import features as j_features
from dcgan_tpu.evals import fid as j_fid
from dcgan_tpu.evals import kid as j_kid
from dcgan_tpu.evals import prdc as j_prdc
from dcgan_tpu_torch.evals import features as t_features
from dcgan_tpu_torch.evals import fid as t_fid
from dcgan_tpu_torch.evals import kid as t_kid
from dcgan_tpu_torch.evals import prdc as t_prdc
from torch_jax_draws import one_torch_thread  # noqa: F401


ROOT = pathlib.Path(__file__).resolve().parent.parent

# the port's tower against JAX's on the same weights: f32 convolutions and
# means summed in another order, features of magnitude ~1e-2..1
TOWER_TOL = dict(rtol=1e-5, atol=1e-6)
# JAX's npz tower against JAX's random tower on the exported weights: the
# same program up to the constants' folding
EXPORT_TOL = dict(rtol=1e-6, atol=1e-7)


def _tool():
    spec = importlib.util.spec_from_file_location(
        "export_feature_tower", ROOT / "tools" / "export_feature_tower.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _images(n, size, seed=0):
    return np.tanh(np.random.default_rng(seed).normal(
        size=(n, size, size, 3))).astype(np.float32)


class TestStatsCopies:
    def test_streaming_stats_bit_for_bit(self):
        rng = np.random.default_rng(0)
        x = rng.normal(size=(300, 9))
        stats = {m: m.StreamingStats(9) for m in (j_fid, t_fid)}
        for chunk in np.array_split(x, 7):
            for s in stats.values():
                s.update(chunk)
        j, t = stats[j_fid], stats[t_fid]
        assert j.n == t.n == 300
        np.testing.assert_array_equal(j._outer, t._outer)
        for a, b in zip(j.finalize(), t.finalize()):
            np.testing.assert_array_equal(a, b)
        extra = rng.normal(size=(40, 9))
        for s, mod in ((j, j_fid), (t, t_fid)):
            other = mod.StreamingStats(9)
            other.update(extra)
            s.merge(other)
        np.testing.assert_array_equal(j.finalize()[1], t.finalize()[1])

    def test_streaming_stats_errors_match(self):
        for mod in (j_fid, t_fid):
            s = mod.StreamingStats(3)
            with pytest.raises(ValueError, match=r"expected \[B, 3\]"):
                s.update(np.zeros((4, 5)))
            s.update(np.zeros((1, 3)))
            with pytest.raises(ValueError, match="need >= 2 samples"):
                s.finalize()
            with pytest.raises(ValueError, match="dim mismatch"):
                s.merge(mod.StreamingStats(4))

    @pytest.mark.parametrize("n", [200, 6], ids=["full_rank", "singular"])
    def test_frechet_distance_equal(self, n):
        """n = 6 < D = 12: singular covariances take the jitter retry."""
        rng = np.random.default_rng(n)
        a, b = rng.normal(size=(n, 12)), rng.normal(0.3, 1.2, (n, 12))
        args = (a.mean(0), np.cov(a, rowvar=False), b.mean(0),
                np.cov(b, rowvar=False))
        assert t_fid.frechet_distance(*args) == j_fid.frechet_distance(*args)


class TestKidCopies:
    def _stream(self):
        rng = np.random.default_rng(3)
        return [rng.normal(size=(b, 6)).astype(np.float32)
                for b in (5, 17, 9, 40, 3)]

    def test_pool_draws_bit_for_bit(self):
        pools = [m.FeaturePool(6, 20, seed=7) for m in (j_kid, t_kid)]
        for batch in self._stream():
            for p in pools:
                p.update(batch)
        j, t = pools
        assert j.n_seen == t.n_seen == 74
        np.testing.assert_array_equal(j.features(), t.features())
        others = [m.FeaturePool(6, 20, seed=8) for m in (j_kid, t_kid)]
        for o in others:
            o.update(self._stream()[3])
        j.merge(others[0])
        t.merge(others[1])
        assert j.n_seen == t.n_seen
        np.testing.assert_array_equal(j.features(), t.features())

    def test_pool_errors_match(self):
        for mod in (j_kid, t_kid):
            with pytest.raises(ValueError, match="capacity must be >= 2"):
                mod.FeaturePool(4, 1)
            with pytest.raises(ValueError, match=r"expected \[B, 4\]"):
                mod.FeaturePool(4, 8).update(np.zeros((2, 3)))
            with pytest.raises(ValueError, match="pool shape mismatch"):
                mod.FeaturePool(4, 8).merge(mod.FeaturePool(4, 9))

    def test_kid_estimator_equal(self):
        rng = np.random.default_rng(4)
        x, y = rng.normal(size=(60, 8)), rng.normal(0.2, 1.0, (50, 8))
        np.testing.assert_array_equal(t_kid.polynomial_kernel(x, y),
                                      j_kid.polynomial_kernel(x, y))
        assert t_kid.mmd2_unbiased(x[:40], y[:40]) == \
            j_kid.mmd2_unbiased(x[:40], y[:40])
        assert t_kid.kid_score(x, y, subset_size=20, num_subsets=7,
                               seed=3) == \
            j_kid.kid_score(x, y, subset_size=20, num_subsets=7, seed=3)
        for mod in (j_kid, t_kid):
            with pytest.raises(ValueError, match="need >= 2 samples"):
                mod.mmd2_unbiased(x[:1], y[:3])


class TestPrdcCopies:
    def test_prdc_equal(self):
        rng = np.random.default_rng(5)
        real = rng.normal(size=(70, 10)).astype(np.float32)
        fake = rng.normal(0.4, 1.1, (60, 10)).astype(np.float32)
        np.testing.assert_array_equal(
            t_prdc._pairwise_sq_dists(fake, real, block=16),
            j_prdc._pairwise_sq_dists(fake, real, block=16))
        np.testing.assert_array_equal(
            t_prdc._knn_radii_sq(real, 3, block=32),
            j_prdc._knn_radii_sq(real, 3, block=32))
        assert t_prdc.prdc(real, fake, k=3) == j_prdc.prdc(real, fake, k=3)

    def test_prdc_errors_match(self):
        for mod in (j_prdc, t_prdc):
            with pytest.raises(ValueError, match=r"k must be in \[1, 4\]"):
                mod._knn_radii_sq(np.zeros((5, 2), np.float32), 5)
            with pytest.raises(ValueError, match="equal D"):
                mod.prdc(np.zeros((5, 2)), np.zeros((5, 3)))


def _random_npz(path, size, *, feature_dim=24, base_ch=4, seed=0):
    """A tower npz with weights large enough that every stage matters."""
    rng = np.random.default_rng(seed)
    n_stages = max(1, int(np.log2(size / 4)))
    arrays, in_ch, total = {}, 3, 0
    for i in range(n_stages):
        out_ch = base_ch * 2 ** i
        arrays[f"conv{i}/w"] = rng.normal(
            0, 0.3, (5, 5, in_ch, out_ch)).astype(np.float32)
        arrays[f"conv{i}/b"] = rng.normal(0, 0.1, (out_ch,)).astype(
            np.float32)
        total += out_ch
        in_ch = out_ch
    arrays["proj"] = rng.normal(0, 1, (total, feature_dim)).astype(
        np.float32)
    np.savez(path, **arrays)
    return str(path)


class TestNpzTower:
    @pytest.mark.parametrize("size", [16, 32])
    def test_same_npz_same_features(self, tmp_path, size):
        path = _random_npz(tmp_path / "tower.npz", size)
        jfn, jdim = j_features.make_npz_feature_fn(path)
        tfn, tdim = t_features.make_npz_feature_fn(path, device="cpu")
        assert jdim == tdim == 24
        x = _images(6, size)
        want = np.asarray(jfn(x))
        got = tfn(x)
        assert got.dtype == torch.float32 and got.shape == (6, 24)
        np.testing.assert_allclose(got.numpy(), want, **TOWER_TOL)
        # a tensor input gives the same features as the numpy array
        np.testing.assert_array_equal(tfn(torch.from_numpy(x)).numpy(),
                                      got.numpy())

    @pytest.mark.parametrize("drop", ["conv0/b", "proj"])
    def test_npz_errors_match(self, tmp_path, drop):
        src = dict(np.load(_random_npz(tmp_path / "full.npz", 16)))
        del src[drop]
        path = str(tmp_path / "bad.npz")
        np.savez(path, **src)
        msg = "conv0/b missing" if drop == "conv0/b" else "expected conv0/w"
        for make in (j_features.make_npz_feature_fn,
                     lambda p: t_features.make_npz_feature_fn(
                         p, device="cpu")):
            with pytest.raises(ValueError, match=msg):
                make(path)


class TestExportedJaxTower:
    @pytest.mark.parametrize("size", [16, 32])
    def test_export_reproduces_jax_default_tower(self, tmp_path, size):
        tool = _tool()
        path = str(tmp_path / f"tower{size}.npz")
        assert tool.main(["--image_size", str(size), "--out", path,
                          "--feature_dim", "64", "--base_ch", "8"]) == 0
        jrand, dim = j_features.make_random_feature_fn(
            size, 3, feature_dim=64, base_ch=8)
        jnpz, dim_npz = j_features.make_npz_feature_fn(path)
        assert dim == dim_npz == 64
        x = _images(5, size, seed=1)
        want = np.asarray(jrand(x))
        np.testing.assert_allclose(np.asarray(jnpz(x)), want, **EXPORT_TOL)
        tnpz, _ = t_features.make_npz_feature_fn(path, device="cpu")
        np.testing.assert_allclose(tnpz(x).numpy(), want, **TOWER_TOL)

    def test_default_arguments_are_the_jax_defaults(self):
        arrays = _tool().tower_arrays(64)
        assert sorted(arrays) == ["conv0/b", "conv0/w", "conv1/b",
                                  "conv1/w", "conv2/b", "conv2/w",
                                  "conv3/b", "conv3/w", "proj"]
        assert arrays["conv3/w"].shape == (5, 5, 128, 256)
        assert arrays["proj"].shape == (32 + 64 + 128 + 256, 512)


class TestPortTower:
    def test_deterministic_with_the_jax_shapes(self):
        fn_a, dim = t_features.make_random_feature_fn(32, 3, device="cpu")
        fn_b, _ = t_features.make_random_feature_fn(32, 3, device="cpu")
        jfn, _ = j_features.make_random_feature_fn(32, 3)
        x = _images(4, 32, seed=2)
        assert dim == 512
        np.testing.assert_array_equal(fn_a(x).numpy(), fn_b(x).numpy())
        shapes = {k: (tuple(v["w"].shape) if isinstance(v, dict)
                      else tuple(v.shape))
                  for k, v in fn_a.params.items()}
        assert shapes == {"conv0": (5, 5, 3, 32), "conv1": (5, 5, 32, 64),
                          "conv2": (5, 5, 64, 128), "proj": (224, 512)}
        # drawn from a torch.Generator, not jax.random: other weights, so
        # the port's surrogate scores compare only with the port's
        assert not np.allclose(fn_a(x).numpy(), np.asarray(jfn(x)))
        other, _ = t_features.make_random_feature_fn(32, 3, seed=7,
                                                     device="cpu")
        assert not np.allclose(other(x).numpy(), fn_a(x).numpy())

    def test_weights_follow_the_jax_init_rule(self):
        fn, _ = t_features.make_random_feature_fn(64, 3, device="cpu")
        w = torch.cat([fn.params[f"conv{i}"]["w"].reshape(-1)
                       for i in range(4)])
        assert float(w.abs().max()) <= 0.04 + 1e-7   # cut at 2 sigma
        assert abs(float(w.std()) - 0.0176) < 1e-3    # 0.02 truncated
        assert all(float(fn.params[f"conv{i}"]["b"].abs().max()) == 0.0
                   for i in range(4))
        proj = fn.params["proj"]
        assert abs(float(proj.std()) * np.sqrt(480) - 1.0) < 0.01

    def test_full_f32_leaves_the_flags(self):
        before = (torch.backends.cudnn.allow_tf32,
                  torch.backends.cuda.matmul.allow_tf32)
        with t_features.full_f32(torch.device("cpu")):
            pass
        assert (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32) == before

    def test_default_device_is_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("checks the behaviour of a machine without a GPU")
        with pytest.raises(RuntimeError, match="cuda"):
            t_features.make_random_feature_fn(16)
