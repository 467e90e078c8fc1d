"""Continued from test_torch_precision.py: The bf16 and fp8 precision policies
in the port against `dcgan_tpu`'s on the CPU, and bfloat16 state through
the port's checkpoints and the JAX state."""

import dataclasses
import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_jax_draws as D
from dcgan_tpu.config import ModelConfig as JModelConfig
from dcgan_tpu.config import TrainConfig as JTrainConfig
from dcgan_tpu.models import dcgan as jdcgan
from dcgan_tpu.train import steps as jsteps
from dcgan_tpu_torch import convert
from dcgan_tpu_torch.config import ModelConfig, TrainConfig, save_config
from dcgan_tpu_torch.models import dcgan as tdcgan
from dcgan_tpu_torch.train import steps
from dcgan_tpu_torch.utils.checkpoint import Checkpointer
from torch_jax_draws import one_torch_thread  # noqa: F401
from test_torch_precision import (  # noqa: F401
    ROOT, SMALL, _bits, _check_dtypes)


class TestStageGate:
    def test_64px_quantizes_nothing(self):
        cfg = ModelConfig(output_size=64, quant="fp8")
        k = cfg.num_up_layers
        assert [tdcgan._stage_quant(cfg, 4 * 2 ** i)
                for i in range(1, k)] == ["", "", ""]
        assert [tdcgan._stage_quant(cfg, 64 >> i)
                for i in range(1, k)] == ["", "", ""]
        c128 = ModelConfig(output_size=128, quant="fp8")
        assert tdcgan._stage_quant(c128, 64) == "fp8"

    @pytest.mark.parametrize("route", ["plain", "fused"])
    @pytest.mark.parametrize("transpose", [False, True])
    def test_quantized_stage_matches_jax(self, route, transpose):
        """One quantized conv (D) or deconv (G) stage on the same inputs:
        the plain layer, or the fused stage (train=True: the patch matrix
        and W quantized before gemm_bias_moments), against the jitted JAX
        one."""
        from dcgan_tpu.ops import layers as jlayers
        from dcgan_tpu.ops import pallas_fused as jfused
        from dcgan_tpu_torch.ops import fused as tfused
        from dcgan_tpu_torch.ops import layers as tlayers

        rng = np.random.default_rng(6)
        x = rng.normal(size=(2, 16, 16, 8)).astype(np.float32)
        w = (rng.normal(size=(5, 5, 8, 16)) * 0.02).astype(np.float32)
        b = (rng.normal(size=(16,)) * 0.1).astype(np.float32)
        jp = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
        tp = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
        if route == "plain":
            jf = jlayers.deconv2d_apply if transpose else \
                jlayers.conv2d_apply
            tf = tlayers.deconv2d_apply if transpose else \
                tlayers.conv2d_apply
            want = jax.jit(lambda p, a: jf(p, a, quant="fp8"))(
                jp, jnp.asarray(x))
            got = tf(tp, torch.from_numpy(x), quant="fp8")
            unq = tf(tp, torch.from_numpy(x))
        else:
            bnp = {"scale": np.linspace(0.5, 1.5, 16).astype(np.float32),
                   "bias": np.zeros(16, np.float32)}
            bns = {"mean": np.zeros(16, np.float32),
                   "var": np.ones(16, np.float32)}
            kw = dict(transpose=transpose, kernel=5, stride=2, train=True,
                      act="relu")
            want, _ = jax.jit(lambda p, a: jfused.fused_conv_bn_act(
                p, jax.tree_util.tree_map(jnp.asarray, bnp),
                jax.tree_util.tree_map(jnp.asarray, bns), a, quant="fp8",
                **kw))(jp, jnp.asarray(x))
            tb = {k: torch.from_numpy(v) for k, v in bnp.items()}
            ts = {k: torch.from_numpy(v) for k, v in bns.items()}
            got, _ = tfused.fused_conv_bn_act(tp, tb, ts,
                                              torch.from_numpy(x),
                                              quant="fp8", **kw)
            unq, _ = tfused.fused_conv_bn_act(tp, tb, ts,
                                              torch.from_numpy(x), **kw)
        want = np.asarray(want)
        err = float(np.abs(got.detach().numpy() - want).max())
        assert err <= 1e-5 * float(np.abs(want).max()), err
        assert float((got - unq).abs().max()) > 1e-3 * float(
            np.abs(want).max())

    def test_quantized_model_matches_jax(self):
        """G and D at 128 px on the fused route with f32 compute, against
        the jitted JAX ones: within 1e-3 in relative L2. Not elementwise:
        f32 summation-order noise ahead of a quantized operand can move
        one element across an fp8 rounding boundary (one e4m3 step, 6 %);
        the stage test above pins the quantized stages elementwise. The
        quantization moves the images by far more."""
        mk = dict(output_size=128, gf_dim=4, df_dim=4, z_dim=8,
                  compute_dtype="float32", use_pallas=True,
                  pallas_fused=True)
        jm, tm = JModelConfig(quant="fp8", **mk), ModelConfig(quant="fp8",
                                                              **mk)
        params, bn = jdcgan.gan_init(jax.random.key(2), jm)
        tp = convert._to_torch(jax.device_get(params), torch.device("cpu"))
        tb = convert._to_torch(jax.device_get(bn), torch.device("cpu"))
        z = np.random.default_rng(3).uniform(-1, 1, (2, 8)).astype(
            np.float32)
        jimg, _ = jax.jit(lambda p, b, zz: jdcgan.generator_apply(
            p, b, zz, cfg=jm, train=True))(params["gen"], bn["gen"],
                                           jnp.asarray(z))
        timg, _ = tdcgan.generator_apply(tp["gen"], tb["gen"],
                                         torch.from_numpy(z), cfg=tm,
                                         train=True)
        plain_img, _ = tdcgan.generator_apply(
            tp["gen"], tb["gen"], torch.from_numpy(z),
            cfg=dataclasses.replace(tm, quant=""), train=True)
        jimg = np.asarray(jimg)
        timg = timg.detach().numpy()
        rel = np.linalg.norm(timg - jimg) / np.linalg.norm(jimg)
        assert rel <= 1e-3, rel
        assert np.linalg.norm(plain_img.detach().numpy() - jimg) \
            / np.linalg.norm(jimg) > 10 * max(rel, 1e-4)
        _, jlogit, _ = jax.jit(lambda p, b, x: jdcgan.discriminator_apply(
            p, b, x, cfg=jm, train=True))(params["disc"], bn["disc"],
                                          jnp.asarray(jimg))
        _, tlogit, _ = tdcgan.discriminator_apply(
            tp["disc"], tb["disc"], torch.from_numpy(jimg), cfg=tm,
            train=True)
        tl, jl = tlogit.detach().numpy(), np.asarray(jlogit)
        assert np.linalg.norm(tl - jl) / np.linalg.norm(jl) <= 1e-3


class TestPolicySteps:
    def test_bf16_fused_matches_jax(self):
        jm, tm, js, ts, _ = D.run_both({"precision": "bf16"}, "fused",
                                       steps=2)
        _check_dtypes(ts)
        for j, t in zip(jm, tm):
            for k in j:
                assert abs(j[k] - t[k]) <= 3e-3, (k, j[k], t[k])
        want = convert.train_state_from_jax(js, device="cpu")
        for net in ("gen", "disc"):
            wmu = convert.flatten(want["opt"][net]["mu"])
            for path, a in convert.flatten(ts["opt"][net]["mu"]).items():
                if path.endswith("/w"):
                    b = wmu[path]
                    rel = float((a - b).norm() / b.norm())
                    assert rel <= 0.15, (net, path, rel)
            for name, s in ts["bn"][net].items():
                w = want["bn"][net][name]["var"].float()
                err = float((s["var"].float() - w).abs().max())
                assert err <= 1e-4 * float(w.abs().max()), (net, name, err)

    def test_fp8_fused_at_128px(self):
        kw = dict(route="fused", steps=1, batch=2, size=128, dim=4)
        jm, tm, _, ts, _ = D.run_both({"precision": "fp8"}, **kw)
        _check_dtypes(ts)
        assert ts is not None
        for k in jm[0]:
            assert np.isfinite(tm[0][k])
            assert abs(jm[0][k] - tm[0][k]) <= 0.03 * abs(jm[0][k]), \
                (k, jm[0][k], tm[0][k])
        # the same state and draws under the bf16 policy: the quantized
        # stages move the losses
        cfg = TrainConfig(model=ModelConfig(
            output_size=128, gf_dim=4, df_dim=4, z_dim=8, use_pallas=True,
            pallas_fused=True), batch_size=2, precision="bf16")
        jcfg = JTrainConfig(model=JModelConfig(
            output_size=128, gf_dim=4, df_dim=4, z_dim=8, use_pallas=True,
            pallas_fused=True), batch_size=2, precision="fp8")
        state = convert.train_state_from_jax(jax.device_get(
            jsteps.init_train_state(jax.random.key(0), jcfg)), device="cpu")
        images = np.tanh(np.random.default_rng(1).normal(
            size=(2, 128, 128, 3))).astype(np.float32)
        z, _ = D.step_draws(jcfg, jax.random.fold_in(jax.random.key(5), 0),
                            2)
        _, bm = steps.make_train_step(cfg).train_step(
            state, torch.from_numpy(images), torch.from_numpy(z.copy()))
        assert abs(float(bm["g_loss"]) - tm[0]["g_loss"]) > 1e-3


class TestBf16State:
    def _bf16_state(self):
        cfg = TrainConfig(model=ModelConfig(**SMALL), precision="bf16")
        state = steps.init_train_state(cfg, seed=0, device="cpu")
        flat = convert.flatten(state)
        gen = torch.Generator().manual_seed(1)
        for k, v in flat.items():
            if v.is_floating_point():
                flat[k] = (v.float() + torch.randn(
                    v.shape, generator=gen)).to(v.dtype)
        return cfg, convert.unflatten(flat)

    def test_checkpoint_round_trip_bit_for_bit(self, tmp_path):
        cfg, state = self._bf16_state()
        ckpt = Checkpointer(str(tmp_path), async_save=False)
        ckpt.save(3, state)
        back = Checkpointer(str(tmp_path)).restore_latest(
            steps.init_train_state(cfg, device="cpu"))
        fa, fb = convert.flatten(state), convert.flatten(back)
        assert sorted(fa) == sorted(fb)
        for k in fa:
            assert fa[k].dtype == fb[k].dtype, k
            np.testing.assert_array_equal(_bits(fa[k]), _bits(fb[k]))
        assert any(v.dtype == torch.bfloat16 for v in fa.values())
        path = convert.save_weights(str(tmp_path / "w" / "G.npz"),
                                    cfg.model, state["params"]["gen"],
                                    state["bn"]["gen"])
        _, p, s = convert.load_weights(path, device="cpu")
        for a, b in ((p, state["params"]["gen"]), (s, state["bn"]["gen"])):
            for k, t in convert.flatten(b).items():
                assert convert.flatten(a)[k].dtype == t.dtype
                np.testing.assert_array_equal(
                    _bits(convert.flatten(a)[k]), _bits(t))

    def test_jax_bf16_state_crosses_both_ways(self, tmp_path):
        """JAX's bf16 state (ml_dtypes arrays) into the port and back
        through the checkpoint tool's graft, every leaf's bits equal."""
        jcfg = JTrainConfig(model=JModelConfig(**SMALL), precision="bf16")
        jstate = jax.device_get(jsteps.init_train_state(jax.random.key(0),
                                                        jcfg))
        ts = convert.train_state_from_jax(jstate, device="cpu")
        _check_dtypes(ts)
        jflat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
                 jax.tree_util.tree_flatten_with_path(jstate)[0]}
        cfg = TrainConfig(model=ModelConfig(**SMALL), precision="bf16",
                          checkpoint_dir=str(tmp_path))
        save_config(cfg, str(tmp_path))
        Checkpointer(str(tmp_path), async_save=False).save(0, ts)
        spec = importlib.util.spec_from_file_location(
            "export_torch_checkpoint",
            ROOT / "tools" / "export_torch_checkpoint.py")
        tool = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tool)
        back = tool.port_to_jax_state(str(tmp_path), jstate)
        bflat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
                 jax.tree_util.tree_flatten_with_path(back)[0]}
        assert sorted(bflat) == sorted(jflat)
        n_bf16 = 0
        for k, w in jflat.items():
            g = bflat[k]
            assert g.dtype == w.dtype, k
            if w.dtype.name == "bfloat16":
                n_bf16 += 1
                np.testing.assert_array_equal(g.view(np.uint16),
                                              w.view(np.uint16))
            else:
                np.testing.assert_array_equal(g, w)
        assert n_bf16 > 0
