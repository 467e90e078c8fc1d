"""Continued from test_torch_attention.py: The port's SAGAN pieces against
`dcgan_tpu`'s on the CPU."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcgan_tpu.config import ModelConfig as JModelConfig
from dcgan_tpu.models import dcgan as jdcgan
from dcgan_tpu.presets import sagan64 as j_sagan64
from dcgan_tpu.train import steps as jsteps
from dcgan_tpu_torch import convert
from dcgan_tpu_torch.config import ModelConfig, TrainConfig
from dcgan_tpu_torch.models import dcgan as tdcgan
from dcgan_tpu_torch.presets import sagan64
from dcgan_tpu_torch.train import steps as tsteps
from dcgan_tpu_torch.train.trainer import METRIC_KEYS
from torch_jax_draws import one_torch_thread  # noqa: F401
from test_torch_attention import (  # noqa: F401
    DTYPES, GAMMA, ROUTES, STEPS, TINY, _close, _jax_nets, _np,
    _state_close, _tiny, _train_both)


class TestTinySagan:
    @pytest.mark.parametrize("route", sorted(ROUTES))
    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_generator_and_sampler_match_jax(self, route, dtype):
        kw = _tiny(route, dtype)
        (gp, gs), _ = _jax_nets()
        z = np.random.default_rng(60).uniform(-1, 1, (4, 8)).astype(
            np.float32)
        jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
        tp, ts = convert.generator_from_jax(gp, gs, device="cpu")
        # images as test_torch_models holds them: f32 1e-4, bf16 2e-2; BN
        # moments f32 1e-5, bf16 1e-3 (f32 moments of activations rounded
        # at other points)
        tol, bn_tol = (1e-4, 1e-5) if dtype == "float32" else (2e-2, 1e-3)
        for train in (True, False):
            want, want_state = jax.jit(functools.partial(
                jdcgan.generator_apply, cfg=jcfg, train=train))(
                    gp, gs, jnp.asarray(z))
            got, got_state = tdcgan.generator_apply(
                tp, ts, torch.from_numpy(z), cfg=cfg, train=train)
            _close(got, want, tol)
            _state_close(got_state, want_state, bn_tol)
        # JAX's sampler_apply is its generator_apply(train=False)
        _close(tdcgan.sampler_apply(tp, ts, torch.from_numpy(z), cfg=cfg),
               want, tol)

    @pytest.mark.parametrize("route", sorted(ROUTES))
    def test_discriminator_matches_jax(self, route):
        kw = _tiny(route)
        _, (dp, ds) = _jax_nets()
        x = np.tanh(_np(61, (4, 16, 16, 3)))
        jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
        tp, ts = convert.generator_from_jax(dp, ds, device="cpu")
        for train in (True, False):
            _, want, want_state = jax.jit(functools.partial(
                jdcgan.discriminator_apply, cfg=jcfg, train=train))(
                    dp, ds, jnp.asarray(x))
            _, got, got_state = tdcgan.discriminator_apply(
                tp, ts, torch.from_numpy(x), cfg=cfg, train=train)
            _close(got, want, 1e-4)
            _state_close(got_state, want_state, 1e-5)

    @pytest.mark.parametrize("kw", [
        {"attn_res": 4}, {"attn_res": 8, "spectral_norm": "d"},
        {"attn_res": 0, "spectral_norm": "gd"}, {"attn_heads": 2}])
    def test_trees_equal_jax(self, kw):
        cfg_kw = dict(TINY, **kw)
        jcfg, cfg = JModelConfig(**cfg_kw), ModelConfig(**cfg_kw)
        for jinit, tinit in ((jdcgan.generator_init, tdcgan.generator_init),
                             (jdcgan.discriminator_init,
                              tdcgan.discriminator_init)):
            jtrees = jax.device_get(jinit(jax.random.key(0), jcfg))
            ttrees = tinit(cfg, device="cpu")
            for jt, tt in zip(jtrees, ttrees):
                assert {k: tuple(v.shape) for k, v in
                        convert.flatten(tt).items()} == \
                    {k: tuple(np.shape(v)) for k, v in
                     convert.flatten(jt).items()}

    def test_sn_layers_are_unchanged_by_the_flag(self):
        """The u vectors are drawn after every layer: switching spectral
        norm on leaves the seeded weights as they were."""
        a, _ = tdcgan.generator_init(ModelConfig(**TINY), device="cpu")
        b, _ = tdcgan.generator_init(ModelConfig(**dict(
            TINY, spectral_norm="none")), device="cpu")
        for path, x in convert.flatten(a).items():
            assert torch.equal(x, convert.flatten(b)[path]), path


class TestTrainStep:
    @pytest.mark.parametrize("route", sorted(ROUTES))
    def test_matches_jax(self, route):
        """Losses at every step within 1e-5; after 4 steps every leaf of
        params, state (BN moments, sn_* vectors), both Adam states and
        the EMA copy within 1e-5 + 1e-5 of its scale, except the biases
        that feed a BatchNorm and the running means they shift, whose true
        gradient is 0, and the attention's key bias, whose true gradient is
        0 too (it shifts each row's scores by a constant, which the softmax
        drops): Adam (beta1 0) steps them by +-lr on the sign of f32
        rounding noise, so they are held to 2 * d_lr * steps."""
        import re

        jl, tl, jstate, tstate, tstate0 = _train_both(route)
        for j, t in zip(jl, tl):
            for k in METRIC_KEYS:
                assert abs(j[k] - t[k]) <= 1e-5, (k, j[k], t[k])
        pre_bn = re.compile(
            r"(proj|deconv[1-9]|conv[1-9]|attn/key)/b$|bn[0-9]+/mean$")
        want = convert.train_state_from_jax(jstate, device="cpu")
        for group in ("params", "bn", "ema_gen"):
            fw, fg = convert.flatten(want[group]), convert.flatten(
                tstate[group])
            assert sorted(fw) == sorted(fg)
            for path, w in fw.items():
                bound = 2 * 4e-4 * STEPS if pre_bn.search(path) \
                    else 1e-5 + 1e-5 * float(w.abs().max())
                err = float((fg[path] - w).abs().max())
                assert err <= bound, (group, path, err, bound)
        for net in ("gen", "disc"):
            for m in ("mu", "nu"):
                fw = convert.flatten(want["opt"][net][m])
                fg = convert.flatten(tstate["opt"][net][m])
                for path, w in fw.items():
                    if pre_bn.search(path):
                        continue
                    err = float((fg[path] - w).abs().max())
                    assert err <= 1e-5 + 1e-4 * float(w.abs().max()), \
                        (net, m, path, err)
        # every SN vector advanced and both gammas moved off their start
        for net in ("gen", "disc"):
            for name, u in tstate["bn"][net].items():
                # (a unit vector of one element, the head's, stays +-1)
                if name.startswith("sn_") and u.numel() > 1:
                    assert not torch.equal(u, tstate0["bn"][net][name]), \
                        (net, name)
            assert float(tstate["params"][net]["attn"]["gamma"]) != GAMMA

    def test_preset_equals_jax(self):
        jt, t = j_sagan64(), sagan64()
        for f in dataclasses.fields(TrainConfig):
            if f.name != "model":
                assert getattr(t, f.name) == getattr(jt, f.name), f.name
        assert dataclasses.asdict(t.model) == dataclasses.asdict(jt.model)

    def test_hinge_and_sagan_fields_accepted(self):
        cfg = TrainConfig(loss="hinge", model=ModelConfig(
            attn_res=32, attn_heads=2, spectral_norm="d"))
        assert cfg.loss == "hinge" and cfg.model.attn_res == 32

    @pytest.mark.parametrize("kw", [{"attn_res": 48}, {"attn_heads": 0},
                                    {"spectral_norm": "g"}])
    def test_jax_validation_kept(self, kw):
        with pytest.raises(ValueError):
            JModelConfig(**kw)
        with pytest.raises(ValueError):
            ModelConfig(**kw)


class TestConvert:
    def test_generator_round_trip(self, tmp_path):
        (gp, gs), _ = _jax_nets()
        cfg = ModelConfig(**TINY)
        tp, ts = convert.generator_from_jax(gp, gs, device="cpu")
        assert tp["attn"]["gamma"].shape == ()
        assert float(tp["attn"]["gamma"]) == GAMMA
        np.testing.assert_array_equal(ts["sn_attn_value"].numpy(),
                                      gs["sn_attn_value"])
        path = convert.save_weights(str(tmp_path / "g.npz"), cfg, tp, ts)
        cfg2, p2, s2 = convert.load_weights(path, device="cpu")
        assert cfg2 == cfg
        for a, b in ((tp, p2), (ts, s2)):
            fa, fb = convert.flatten(a), convert.flatten(b)
            assert sorted(fa) == sorted(fb)
            for k in fa:
                assert torch.equal(fa[k], fb[k]), k
        keys = set(np.load(path).files)
        assert {"params/attn/query/w", "params/attn/gamma",
                "state/sn_attn_out", "state/sn_proj"} <= keys

    def test_train_state_carries_attn_and_sn(self):
        jcfg = j_sagan64(model=JModelConfig(**TINY), batch_size=2)
        js = jax.device_get(jsteps.init_train_state(jax.random.key(0),
                                                    jcfg))
        ts = convert.train_state_from_jax(js, device="cpu")
        port = tsteps.init_train_state(
            sagan64(model=ModelConfig(**TINY), batch_size=2), device="cpu")
        for group in ("params", "bn", "ema_gen"):
            assert sorted(convert.flatten(ts[group])) == \
                sorted(convert.flatten(port[group])), group
        assert sorted(convert.flatten(ts["opt"]["gen"]["mu"])) == \
            sorted(convert.flatten(port["opt"]["gen"]["mu"]))
        np.testing.assert_array_equal(
            ts["bn"]["disc"]["sn_attn_key"].numpy(),
            js["bn"]["disc"]["sn_attn_key"])
