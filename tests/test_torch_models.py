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

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcgan_tpu.config import ModelConfig as JModelConfig
from dcgan_tpu.config import config_to_dict, load_config
from dcgan_tpu.config import TrainConfig as JTrainConfig
from dcgan_tpu.models import dcgan as jdcgan
from dcgan_tpu.presets import celeba64 as j_celeba64
from dcgan_tpu_torch import convert
from dcgan_tpu_torch.config import ModelConfig, celeba64, \
    model_config_from_dict
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


class TestConfig:
    def test_same_fields_and_defaults_as_jax(self):
        assert dataclasses.asdict(ModelConfig()) == \
            dataclasses.asdict(JModelConfig())

    def test_celeba64_is_the_presets_model(self):
        assert dataclasses.asdict(celeba64()) == \
            dataclasses.asdict(j_celeba64().model)
        assert celeba64(use_pallas=True).use_pallas

    def test_reads_a_trainer_config_json(self):
        d = json.loads(json.dumps(config_to_dict(JTrainConfig(
            model=JModelConfig(output_size=32, gf_dim=16)))))
        cfg = model_config_from_dict(d)
        assert cfg.output_size == 32 and cfg.gf_dim == 16
        assert cfg.num_up_layers == 3

    @pytest.mark.parametrize("kw", [
        {"arch": "resnet"}, {"arch": "resnet", "num_classes": 10},
        {"arch": "stylegan"}, {"arch": "stylegan", "num_classes": 10},
        {"arch": "resnet", "quant": "fp8"}])
    def test_unserved_fields_raise(self, kw):
        """The model families the port once refused are served: each
        config equals the JAX ModelConfig field for field. What raises is
        the JAX package's own check, with its message: no attention site
        in the stylegan family."""
        assert dataclasses.asdict(ModelConfig(**kw)) == \
            dataclasses.asdict(JModelConfig(**kw))
        bad = dict(kw, arch="stylegan", attn_res=8)
        with pytest.raises(ValueError):
            JModelConfig(**bad)
        with pytest.raises(ValueError, match="no attention site"):
            ModelConfig(**bad)

    def test_fp8_quant_is_served(self):
        """quant="fp8" (set by the fp8 precision policy) constructs, equal
        to the JAX ModelConfig."""
        assert dataclasses.asdict(ModelConfig(quant="fp8")) == \
            dataclasses.asdict(JModelConfig(quant="fp8"))

    @pytest.mark.parametrize("kw", [
        {"output_size": 48}, {"arch": "vit"}, {"pallas_fused": True},
        {"bn_pallas": True}, {"quant": "int4"}])
    def test_jax_validation_kept(self, kw):
        with pytest.raises(ValueError):
            JModelConfig(**kw)
        with pytest.raises(ValueError):
            ModelConfig(**kw)
