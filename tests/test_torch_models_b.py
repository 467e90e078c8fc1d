"""Continued from test_torch_models.py: The port's generator and discriminator
against `dcgan_tpu`'s on shared weights and inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcgan_tpu.config import ModelConfig as JModelConfig
from dcgan_tpu.config import load_config
from dcgan_tpu.models import dcgan as jdcgan
from dcgan_tpu_torch import convert
from dcgan_tpu_torch.config import ModelConfig
from dcgan_tpu_torch.models import dcgan as tdcgan
from torch_jax_draws import one_torch_thread  # noqa: F401
from test_torch_models import (  # noqa: F401
    ROUTES, _check_generator_train, _gan_numpy, _mk, _paths, _to_t)


class TestTrainMode:
    @pytest.mark.parametrize("route", sorted(ROUTES))
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_generator_matches_jax(self, route, dtype):
        """Images: f32 1e-4, bf16 2e-2; new BN state: f32 1e-5, bf16 1e-3
        (f32 moments of activations rounded at other points)."""
        _check_generator_train(route, dtype)

    @pytest.mark.parametrize("route", sorted(ROUTES))
    @pytest.mark.parametrize("train", [True, False])
    def test_discriminator_matches_jax(self, route, train):
        """D on tanh-range images, f32: logits 1e-4, probabilities 1e-5,
        new BN state 1e-5; the state is passed through at train=False."""
        params, bn = _gan_numpy(seed=1)
        img = np.tanh(np.random.default_rng(10).normal(
            size=(4, 16, 16, 3))).astype(np.float32)
        jcfg = JModelConfig(**_mk(route, "float32"))
        tcfg = ModelConfig(**_mk(route, "float32"))
        jp, jl, js = jdcgan.discriminator_apply(
            params["disc"], bn["disc"], jnp.asarray(img), cfg=jcfg,
            train=train)
        tp, tl, ts = tdcgan.discriminator_apply(
            _to_t(params["disc"]), _to_t(bn["disc"]), torch.from_numpy(img),
            cfg=tcfg, train=train)
        assert tl.dtype == torch.float32 and tuple(tl.shape) == (4, 1)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                                   atol=1e-5)
        assert sorted(ts) == sorted(js) == ["bn1"]
        for key in ("mean", "var"):
            np.testing.assert_allclose(ts["bn1"][key].numpy(),
                                       np.asarray(js["bn1"][key]),
                                       rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("route", sorted(ROUTES))
    def test_gradients_match_jax(self, route):
        """d/d(params) of a scalar through G then D (train mode, BN state
        chaining from a real batch as in the D step), f32, against
        jax.grad, for both nets: rtol 1e-3 of each leaf's largest
        gradient plus 1e-5 (sums through two BN backwards in another
        order; the pre-BN biases' gradients are 0 in exact arithmetic,
        rounding noise on both sides)."""
        params, bn = _gan_numpy(seed=2)
        rng = np.random.default_rng(11)
        z = rng.uniform(-1, 1, (4, 8)).astype(np.float32)
        img = np.tanh(rng.normal(size=(4, 16, 16, 3))).astype(np.float32)
        jcfg = JModelConfig(**_mk(route, "float32"))
        tcfg = ModelConfig(**_mk(route, "float32"))

        def jloss(p):
            fake, _ = jdcgan.generator_apply(p["gen"], bn["gen"],
                                             jnp.asarray(z), cfg=jcfg,
                                             train=True)
            _, real_l, d_bn = jdcgan.discriminator_apply(
                p["disc"], bn["disc"], jnp.asarray(img), cfg=jcfg,
                train=True)
            _, fake_l, _ = jdcgan.discriminator_apply(
                p["disc"], d_bn, fake, cfg=jcfg, train=True)
            return jnp.mean(real_l) - jnp.mean(fake_l * fake_l)

        want = jax.grad(jloss)(jax.tree_util.tree_map(jnp.asarray, params))
        tparams = convert._to_torch(params, torch.device("cpu"))
        flat = convert.flatten(tparams)
        for t in flat.values():
            t.requires_grad_(True)
        fake, _ = tdcgan.generator_apply(tparams["gen"], _to_t(bn["gen"]),
                                         torch.from_numpy(z), cfg=tcfg,
                                         train=True)
        _, real_l, d_bn = tdcgan.discriminator_apply(
            tparams["disc"], _to_t(bn["disc"]), torch.from_numpy(img),
            cfg=tcfg, train=True)
        _, fake_l, _ = tdcgan.discriminator_apply(
            tparams["disc"], d_bn, fake, cfg=tcfg, train=True)
        loss = real_l.mean() - (fake_l * fake_l).mean()
        grads = torch.autograd.grad(loss, list(flat.values()))
        wflat = convert.flatten(jax.tree_util.tree_map(np.asarray, want))
        assert sorted(wflat) == sorted(flat)
        for (path, _), g in zip(flat.items(), grads):
            w = wflat[path]
            err = np.abs(g.numpy() - w).max()
            assert err <= 1e-3 * np.abs(w).max() + 1e-5, (path, err)


class TestParameterTree:
    @pytest.mark.parametrize("output_size", [16, 64])
    def test_discriminator_names_and_shapes_equal_jax(self, output_size):
        jcfg = JModelConfig(output_size=output_size, df_dim=8)
        jp, js = jax.eval_shape(lambda k: jdcgan.discriminator_init(k, jcfg),
                                jax.random.key(0))
        tp, ts = tdcgan.discriminator_init(
            ModelConfig(output_size=output_size, df_dim=8), device="cpu")
        assert _paths(tp) == _paths(jp)
        assert _paths(ts) == _paths(js)
        assert "bn0" not in tp and "head" in tp

    def test_gan_init_tree_equals_jax(self):
        jcfg = JModelConfig(output_size=16, gf_dim=8, df_dim=8)
        jp, js = jax.eval_shape(lambda k: jdcgan.gan_init(k, jcfg),
                                jax.random.key(0))
        tp, ts = tdcgan.gan_init(ModelConfig(output_size=16, gf_dim=8,
                                             df_dim=8), device="cpu")
        assert _paths(tp) == _paths(jp) and _paths(ts) == _paths(js)
        assert not torch.equal(tp["disc"]["conv1"]["w"][0, 0, :4, :4],
                               tp["gen"]["deconv2"]["w"][0, 0, :4, :4])

    @pytest.mark.parametrize("output_size", [16, 64])
    def test_names_and_shapes_equal_jax(self, output_size):
        jcfg = JModelConfig(output_size=output_size, gf_dim=8)
        jp, js = jax.eval_shape(lambda k: jdcgan.generator_init(k, jcfg),
                                jax.random.key(0))
        tp, ts = tdcgan.generator_init(
            ModelConfig(output_size=output_size, gf_dim=8), device="cpu")
        assert _paths(tp) == _paths(jp)
        assert _paths(ts) == _paths(js)

    def test_init_is_seeded(self):
        cfg = ModelConfig(output_size=8, gf_dim=4)
        a, _ = tdcgan.generator_init(cfg, seed=5, device="cpu")
        b, _ = tdcgan.generator_init(cfg, seed=5, device="cpu")
        c, _ = tdcgan.generator_init(cfg, seed=6, device="cpu")
        torch.testing.assert_close(a["proj"]["w"], b["proj"]["w"])
        assert not torch.equal(a["proj"]["w"], c["proj"]["w"])
        assert a["deconv1"]["w"].dtype == torch.float32


class TestWeightsFile:
    def test_save_load_round_trip(self, tmp_path):
        cfg = ModelConfig(output_size=16, gf_dim=8, use_pallas=True,
                          pallas_fused=True)
        params, state = tdcgan.generator_init(cfg, seed=1, device="cpu")
        state["bn1"]["mean"] += 0.25
        path = convert.save_weights(str(tmp_path / "g.npz"), cfg, params,
                                    state)
        cfg2, p2, s2 = convert.load_weights(path, device="cpu")
        assert cfg2 == cfg
        for a, b in ((params, p2), (state, s2)):
            fa, fb = convert.flatten(a), convert.flatten(b)
            assert sorted(fa) == sorted(fb)
            for k in fa:
                torch.testing.assert_close(fa[k], fb[k], rtol=0, atol=0)
        keys = sorted(np.load(path).files)
        assert "params/deconv1/w" in keys and "state/bn0/mean" in keys

    def test_config_json_is_the_trainers_format(self, tmp_path):
        """The JAX package's own load_config reads the config.json that
        save_weights writes."""
        cfg = ModelConfig(output_size=16, gf_dim=8)
        params, state = tdcgan.generator_init(cfg, device="cpu")
        convert.save_weights(str(tmp_path / "g.npz"), cfg, params, state)
        jcfg = load_config(str(tmp_path)).model
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
