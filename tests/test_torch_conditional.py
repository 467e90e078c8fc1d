"""Class conditioning in the port against `dcgan_tpu`'s on the CPU: the
label one-hot on G's z and as maps on D's image, and conditional
BatchNorm (per-class [K, C] scale and bias tables), forward. Labels out of
range, the gradients and the config are
tests/test_torch_conditional_grads.py's; the train step with labels is
tests/test_torch_conditional_step.py's.

Weights are numpy draws from a seed in the JAX init's tree at K = 4
classes (`_gan`), carried over with `convert`; the BN biases and scales
are perturbed so that every class's row differs. JAX runs its Pallas kernels
in interpret mode on the use_pallas and pallas_fused routes, as its own
tests do; the port runs its kernels' plain versions.

Tolerances: images and logits f32 1e-4 (summation order only), bf16 2e-2
(the sampler's, tests/test_torch_models.py); BN running statistics 1e-5;
gradients rtol 1e-3 of each leaf's largest value plus 1e-5
(tests/test_torch_models.py's rule).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcgan_tpu.config import ModelConfig as JModelConfig
from dcgan_tpu.models import dcgan as jdcgan
from dcgan_tpu_torch import convert
from dcgan_tpu_torch.config import ModelConfig
from dcgan_tpu_torch.models import dcgan as tdcgan
from dcgan_tpu_torch.ops import labels as L
from torch_jax_draws import one_torch_thread  # noqa: F401

K = 4
ROUTES = {"plain": {}, "use_pallas": {"use_pallas": True},
          "fused": {"use_pallas": True, "pallas_fused": True}}
# (route, conditional_bn): cBN is refused with pallas_fused, as in JAX
CASES = [("plain", False), ("use_pallas", False), ("fused", False),
         ("plain", True), ("use_pallas", True)]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _mk(route, cbn, dtype="float32", size=16):
    return dict(output_size=size, gf_dim=8, df_dim=8, z_dim=8,
                compute_dtype=dtype, num_classes=K, conditional_bn=cbn,
                **ROUTES[route])


def _gan(cbn, seed=0, size=16):
    """(params, bn) of both nets as numpy in the JAX gan_init's tree (its
    names, shapes and dtypes, from eval_shape, so nothing is drawn by
    JAX): weights N(0, 0.02) cut at 2 sigma and biases 0 as the init
    draws them, BN scales 1 + N(0, 0.02), running means 0 and variances
    1, and G's BN biases (every class's row with cBN) N(0, 0.1)."""
    jcfg = JModelConfig(**_mk("plain", cbn, size=size))
    shapes = jax.eval_shape(lambda k: jdcgan.gan_init(k, jcfg),
                            jax.random.key(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        net, name = path[1].key, path[-1].key
        if name == "w":
            return np.clip(rng.normal(0, 0.02, leaf.shape), -0.04,
                           0.04).astype(leaf.dtype)
        if name == "scale":
            return (1.0 + rng.normal(0, 0.02, leaf.shape)).astype(
                leaf.dtype)
        if name == "bias" and net == "gen":
            return rng.normal(0, 0.1, leaf.shape).astype(leaf.dtype)
        return np.full(leaf.shape, 1.0 if name == "var" else 0.0,
                       leaf.dtype)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _t(tree):
    return convert._to_torch(tree, torch.device("cpu"))


def _j(tree):
    # JAX gathers clamp only on device arrays; numpy would raise
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _labels(seed=3):
    return np.random.default_rng(seed).integers(0, K, 4).astype(np.int32)


class TestLabelSemantics:
    def test_one_hot_is_jax_one_hot(self):
        lab = np.array([0, 3, -1, K, K + 3, -K - 1, 2], np.int32)
        want = np.asarray(jax.nn.one_hot(jnp.asarray(lab), K,
                                         dtype=jnp.float32))
        got = L.one_hot(torch.from_numpy(lab), K, torch.float32).numpy()
        np.testing.assert_array_equal(got, want)
        assert got[2:6].sum() == 0   # out of range: a zero row

    def test_class_rows_is_jax_gather(self):
        lab = np.array([0, 3, -1, K, K + 3, -K - 1, 2, -2], np.int32)
        table = np.random.default_rng(0).normal(size=(K, 5)).astype(
            np.float32)
        want = np.asarray(jnp.asarray(table)[jnp.asarray(lab)])
        got = L.class_rows(torch.from_numpy(table),
                           torch.from_numpy(lab)).numpy()
        np.testing.assert_array_equal(got, want)
        # wrapped once, then clamped: rows 0, 3, 3, 3, 3, 0, 2, 2
        np.testing.assert_array_equal(got, table[[0, 3, 3, 3, 3, 0, 2, 2]])

    def test_class_rows_gradient_is_a_scatter_sum(self):
        """The table's gradient: each class's rows summed over the batch
        (JAX's scatter-add, which drops a label still out of range after
        the wrap); the same bits across calls."""
        lab = torch.tensor([1, 1, -1, 7, 0], dtype=torch.int32)
        table = torch.randn(K, 3, requires_grad=True)
        g = torch.randn(5, 3)
        (grad,) = torch.autograd.grad((L.class_rows(table, lab) * g).sum(),
                                      table)
        want = np.asarray(jax.grad(lambda t: jnp.sum(
            t[jnp.asarray(lab.numpy())] * jnp.asarray(g.numpy())))(
                jnp.asarray(table.detach().numpy())))
        np.testing.assert_allclose(grad.numpy(), want, rtol=0, atol=1e-6)
        (again,) = torch.autograd.grad(
            (L.class_rows(table, lab) * g).sum(), table)
        assert torch.equal(grad, again)


class TestModels:
    @pytest.mark.parametrize("route,cbn", CASES)
    @pytest.mark.parametrize("train", [False, True])
    def test_generator_and_discriminator_match_jax(self, route, cbn, train):
        """G (images, new BN state) and D (logits, new BN state) with
        labels, f32: images and logits 1e-4, BN state 1e-5."""
        params, bn = _gan(cbn)
        jcfg, tcfg = JModelConfig(**_mk(route, cbn)), \
            ModelConfig(**_mk(route, cbn))
        z = np.random.default_rng(1).uniform(-1, 1, (4, 8)).astype(
            np.float32)
        lab = _labels()
        want, wst = jdcgan.generator_apply(
            _j(params["gen"]), bn["gen"], jnp.asarray(z), cfg=jcfg,
            train=train, labels=jnp.asarray(lab))
        got, gst = tdcgan.generator_apply(
            _t(params["gen"]), _t(bn["gen"]), torch.from_numpy(z),
            cfg=tcfg, train=train, labels=torch.from_numpy(lab))
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-4
        img = np.asarray(want)
        jp, jl, jst = jdcgan.discriminator_apply(
            params["disc"], bn["disc"], jnp.asarray(img), cfg=jcfg,
            train=train, labels=jnp.asarray(lab))
        tp, tl, tst = tdcgan.discriminator_apply(
            _t(params["disc"]), _t(bn["disc"]), torch.from_numpy(img),
            cfg=tcfg, train=train, labels=torch.from_numpy(lab))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        for mine, theirs in ((gst, wst), (tst, jst)):
            assert sorted(mine) == sorted(theirs)
            for name in mine:
                for key in ("mean", "var"):
                    np.testing.assert_allclose(
                        mine[name][key].numpy(),
                        np.asarray(theirs[name][key]), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("route,cbn", CASES)
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_sampler_matches_jax(self, route, cbn, dtype):
        """The sampler with labels: f32 1e-4, bf16 2e-2; a label changes
        the image."""
        params, bn = _gan(cbn, seed=1)
        z = np.random.default_rng(2).uniform(-1, 1, (4, 8)).astype(
            np.float32)
        lab = np.arange(4, dtype=np.int32)
        want = jdcgan.sampler_apply(_j(params["gen"]), bn["gen"],
                                    jnp.asarray(z),
                                    cfg=JModelConfig(**_mk(route, cbn,
                                                           dtype)),
                                    labels=jnp.asarray(lab))
        tcfg = ModelConfig(**_mk(route, cbn, dtype))
        got = tdcgan.sampler_apply(_t(params["gen"]), _t(bn["gen"]),
                                   torch.from_numpy(z), cfg=tcfg,
                                   labels=torch.from_numpy(lab))
        assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL[dtype]
        other = tdcgan.sampler_apply(_t(params["gen"]), _t(bn["gen"]),
                                     torch.from_numpy(z), cfg=tcfg,
                                     labels=torch.from_numpy(lab[::-1]
                                                             .copy()))
        assert not torch.equal(got, other)

    @pytest.mark.parametrize("cbn", [False, True])
    def test_parameter_tree_equals_jax(self, cbn):
        """proj takes z_dim + K inputs, conv0 c_dim + K channels, cBN
        tables [K, C]: the JAX tree's names and shapes."""
        jcfg = JModelConfig(**_mk("plain", cbn, size=32))
        jp, js = jax.eval_shape(lambda k: jdcgan.gan_init(k, jcfg),
                                jax.random.key(0))
        tp, ts = tdcgan.gan_init(ModelConfig(**_mk("plain", cbn, size=32)),
                                 device="cpu")

        def shapes(tree):
            return {k: tuple(v.shape) for k, v in
                    convert.flatten(tree).items()}
        assert shapes(tp) == shapes(jp) and shapes(ts) == shapes(js)
        assert tp["gen"]["proj"]["w"].shape[0] == 8 + K
        assert tp["disc"]["conv0"]["w"].shape[2] == 3 + K
        assert tp["gen"]["bn0"]["scale"].ndim == (2 if cbn else 1)

    def test_conditional_models_need_labels(self):
        cfg = ModelConfig(**_mk("plain", True))
        params, state = tdcgan.generator_init(cfg, device="cpu")
        z = torch.zeros(2, 8)
        with pytest.raises(ValueError, match="requires labels"):
            tdcgan.generator_apply(params, state, z, cfg=cfg, train=False)
        d_params, d_state = tdcgan.discriminator_init(cfg, device="cpu")
        with pytest.raises(ValueError, match="requires labels"):
            tdcgan.discriminator_apply(d_params, d_state,
                                       torch.zeros(2, 16, 16, 3), cfg=cfg,
                                       train=True)
