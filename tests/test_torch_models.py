"""The port's generator against `dcgan_tpu`'s on shared weights and z.

Weights come from the JAX package's own init and are carried over with
`convert.generator_from_jax`; BN running statistics are the moments of one
batch (a JAX train-mode pass at momentum 0) perturbed with numpy noise, and
the BN betas and deconv biases are drawn from numpy, so every scale and
shift of the sampler path is nontrivial. z rows are numpy draws.

Tolerances on the tanh outputs: f32 1e-4 (summation order only); bf16 2e-2
(the frameworks round bf16 at different points through every stage).
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
        cfg = ModelConfig(output_size=8, gf_dim=4)
        p, s = tdcgan.generator_init(cfg, device="cpu")
        with pytest.raises(NotImplementedError):
            tdcgan.generator_apply(p, s, torch.zeros(1, 100), cfg=cfg,
                                   train=True)


class TestParameterTree:
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
        {"arch": "resnet"}, {"num_classes": 10}, {"attn_res": 32},
        {"spectral_norm": "d"}, {"quant": "fp8"}])
    def test_unserved_fields_raise(self, kw):
        with pytest.raises(NotImplementedError, match="not ported"):
            ModelConfig(**kw)

    @pytest.mark.parametrize("kw", [
        {"output_size": 48}, {"arch": "vit"}, {"pallas_fused": True},
        {"bn_pallas": True}, {"quant": "int4"}])
    def test_jax_validation_kept(self, kw):
        with pytest.raises(ValueError):
            JModelConfig(**kw)
        with pytest.raises(ValueError):
            ModelConfig(**kw)
