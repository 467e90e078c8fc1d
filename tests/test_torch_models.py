"""The port's generator and discriminator against `dcgan_tpu`'s on shared
weights and inputs.

Weights come from the JAX package's own init and are carried over with
`convert.generator_from_jax`; BN running statistics are the moments of one
batch (a JAX train-mode pass at momentum 0) perturbed with numpy noise, and
the BN betas and deconv biases are drawn from numpy, so every scale and
shift of the sampler path is nontrivial. z rows are numpy draws.

Tolerances on the tanh outputs: f32 1e-4 (summation order only); bf16 2e-2
(the frameworks round bf16 at different points through every stage). The
train-mode cases (batch statistics) are stated in their tests.
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
from torch_jax_draws import one_torch_thread  # noqa: F401

ROUTES = {"plain": {},
          "use_pallas": {"use_pallas": True},
          "fused": {"use_pallas": True, "pallas_fused": True}}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_paths(v, p))
        else:
            out[p] = tuple(v.shape)
    return out


def _shared_weights(output_size, gf_dim, seed=0):
    """(numpy params, numpy BN state) of a JAX-initialized generator with
    calibrated, perturbed running statistics and nonzero biases."""
    rng = np.random.default_rng(seed)
    jcfg = JModelConfig(output_size=output_size, gf_dim=gf_dim,
                        compute_dtype="float32", bn_momentum=0.0)
    params, state = jdcgan.generator_init(jax.random.key(seed), jcfg)
    params = jax.tree_util.tree_map(np.asarray, params)
    for name, p in params.items():
        if name.startswith("deconv"):
            p["b"] = rng.normal(0, 0.02, p["b"].shape).astype(np.float32)
        elif name.startswith("bn"):
            p["bias"] = rng.normal(0, 0.1, p["bias"].shape).astype(
                np.float32)
    z = rng.uniform(-1, 1, (8, jcfg.z_dim)).astype(np.float32)
    # momentum 0: the "running" statistics become this batch's moments
    _, batch_state = jdcgan.generator_apply(params, state, jnp.asarray(z),
                                            cfg=jcfg, train=True)
    state = {}
    for name, s in batch_state.items():
        c = s["mean"].shape[0]
        state[name] = {
            "mean": (np.asarray(s["mean"])
                     * (1 + rng.normal(0, 0.1, c))).astype(np.float32),
            "var": (np.asarray(s["var"])
                    * rng.uniform(0.8, 1.25, c)).astype(np.float32)}
    return params, state


def _both(params_np, state_np, z, **cfg_kw):
    jcfg = JModelConfig(**cfg_kw)
    want, _ = jdcgan.generator_apply(params_np, state_np, jnp.asarray(z),
                                     cfg=jcfg, train=False)
    tp, ts = convert.generator_from_jax(params_np, state_np, device="cpu")
    got = tdcgan.sampler_apply(tp, ts, torch.from_numpy(z),
                               cfg=ModelConfig(**cfg_kw))
    return got.numpy(), np.asarray(want)


class TestGeneratorParity:
    @pytest.mark.parametrize("route", sorted(ROUTES))
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("output_size,gf_dim", [(16, 8), (32, 8)])
    def test_sampler_matches_jax(self, route, dtype, output_size, gf_dim):
        params, state = _shared_weights(output_size, gf_dim)
        z = np.random.default_rng(7).uniform(-1, 1, (4, 100)).astype(
            np.float32)
        got, want = _both(params, state, z, output_size=output_size,
                          gf_dim=gf_dim, compute_dtype=dtype,
                          **ROUTES[route])
        assert got.shape == want.shape == (4, output_size, output_size, 3)
        assert got.dtype == np.float32
        assert want.std() > 0.05   # the check is not of a near-zero image
        err = np.abs(got - want).max()
        assert err <= TOL[dtype], err

    def test_routes_agree_in_f32(self):
        """The kernel route and the cuDNN/torch-BN route are the same
        function: f32, 1e-5 apart on the CPU."""
        params, state = _shared_weights(16, 8, seed=3)
        tp, ts = convert.generator_from_jax(params, state, device="cpu")
        z = torch.from_numpy(np.random.default_rng(8).uniform(
            -1, 1, (3, 100)).astype(np.float32))
        outs = [tdcgan.sampler_apply(tp, ts, z, cfg=ModelConfig(
            output_size=16, gf_dim=8, compute_dtype="float32", **flags))
            for flags in ROUTES.values()]
        for out in outs[1:]:
            torch.testing.assert_close(out, outs[0], rtol=1e-5, atol=1e-5)

    def test_train_mode_not_ported_yet(self):
        """generator_apply(train=True), fused routing, f32, against JAX:
        images 1e-4 and the new BN state 1e-5 (the name dates from before
        train mode was ported; TestTrainMode covers the other routings)."""
        _check_generator_train("fused", "float32")


def _gan_numpy(output_size=16, width=8, seed=0):
    """(params, bn) of both nets from the JAX package's gan_init, numpy."""
    jcfg = JModelConfig(output_size=output_size, gf_dim=width, df_dim=width,
                        z_dim=8)
    params, bn = jdcgan.gan_init(jax.random.key(seed), jcfg)
    return (jax.tree_util.tree_map(np.asarray, params),
            jax.tree_util.tree_map(np.asarray, bn))


def _mk(route, dtype):
    return dict(output_size=16, gf_dim=8, df_dim=8, z_dim=8,
                compute_dtype=dtype, **ROUTES[route])


def _to_t(tree):
    return convert._to_torch(tree, torch.device("cpu"))


def _check_generator_train(route, dtype):
    params, bn = _gan_numpy()
    z = np.random.default_rng(9).uniform(-1, 1, (4, 8)).astype(np.float32)
    want, want_state = jdcgan.generator_apply(
        params["gen"], bn["gen"], jnp.asarray(z), cfg=JModelConfig(
            **_mk(route, dtype)), train=True)
    got, got_state = tdcgan.generator_apply(
        _to_t(params["gen"]), _to_t(bn["gen"]), torch.from_numpy(z),
        cfg=ModelConfig(**_mk(route, dtype)), train=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL[dtype]
    assert sorted(got_state) == sorted(want_state)
    stol = 1e-5 if dtype == "float32" else 1e-3
    for name, s in got_state.items():
        for key in ("mean", "var"):
            np.testing.assert_allclose(s[key].numpy(),
                                       np.asarray(want_state[name][key]),
                                       rtol=stol, atol=stol)
