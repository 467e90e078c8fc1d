"""The port's gradient penalties against `dcgan_tpu`'s on the CPU.

WGAN-GP's penalty and R1 take the critic's input gradient and are then
differentiated again for D's update: double backward. The port runs them
on the plain route (cuDNN convolutions, torch BatchNorm), where the JAX
package runs them; both packages refuse or fail them on a kernel route.
Both sides start from the JAX package's init carried over with
`convert.train_state_from_jax`, on the same numpy images, the JAX step's
draws recomputed from its key (tests/torch_jax_draws.py).

Tolerances (f32):
- a penalty's value: 1e-6 relative; its gradient in each D leaf 1e-5 of
  the net's largest leaf gradient (summation order only);
- steps: losses and the penalty metric 1e-5 at every step, each step
  from JAX's state (resync), and the state leaves after it as in
  tests/test_torch_train.py (1e-5 abs + 1e-5 rel; the biases that feed a
  BatchNorm held to Adam's bound 2 * lr, their true gradient being 0);
- WGAN-GP at n_critic 2, 8 px (a D of one stage, without BatchNorm):
  no leaf of D moves by rounding noise, so both critic updates and G's
  update are pinned: every metric 1e-5 and every state leaf as above,
  over 2 steps.
- WGAN-GP at n_critic 2, 16 px: the second critic iteration runs from the
  first one's update, in which D's BN-feeding biases moved by +-lr with
  the sign of rounding noise. The penalty critic runs D at train=False,
  where such a bias shifts the pre-activations and flips the lrelu masks
  of those within ~lr of 0, so the second iteration's penalty differs by
  ~1e-4 (measured 1.4e-5 on gp, 1.4e-4 on d_loss at gp weight 10) and
  D's second update by up to 4e-3 of a leaf's largest value (conv1/w):
  the losses are held to 1e-3 relative; G's params, BN state and EMA
  (Adam's first update of each element is lr times the sign of its
  gradient) as above, with G's BN-feeding biases at 2 * lr; D's
  BN-feeding biases and running means at 2 * lr * n_critic; D's other
  leaves and both nets' Adam moments (G's gradient is taken through the
  updated D) are pinned by the 8 px case.
Kernel 5's backward (`_GemmBiasScaleAct`) against `jax.grad` of the JAX
`gemm_bias_scale_act` (its custom VJP): f32 1e-5 relative to the largest
value, bf16 one bf16 ulp (2^-7) of the largest value.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_jax_draws as D

from dcgan_tpu.config import ModelConfig as JModelConfig
from dcgan_tpu.config import TrainConfig as JTrainConfig
from dcgan_tpu.models import dcgan as jdcgan
from dcgan_tpu.ops import pallas_fused as jfused
from dcgan_tpu.train import losses as jlosses
from dcgan_tpu.train import steps as jsteps
from dcgan_tpu_torch import convert
from dcgan_tpu_torch.config import ModelConfig, TrainConfig
from dcgan_tpu_torch.models import dcgan as tdcgan
from dcgan_tpu_torch.ops import fused as tfused
from dcgan_tpu_torch.train import losses as tlosses
from dcgan_tpu_torch.train import steps as tsteps
from torch_jax_draws import one_torch_thread  # noqa: F401

MODEL = dict(output_size=16, gf_dim=8, df_dim=8, z_dim=8,
             compute_dtype="float32")
BATCH = 4


def _images(seed):
    rng = np.random.default_rng(seed)
    return np.tanh(rng.normal(size=(BATCH, 16, 16, 3))).astype(np.float32)


class TestPenaltyGradients:
    @pytest.mark.parametrize("penalty", ["gp", "r1"])
    @pytest.mark.parametrize("sn", ["none", "d"])
    def test_value_and_d_grads_match_jax(self, penalty, sn):
        """The penalty on D at train=False (running BN statistics, stored
        spectral-norm vectors), and its gradient in every D leaf: the
        second derivative through the convolutions, lrelu's maximum, BN
        and spectral norm."""
        jm = JModelConfig(spectral_norm=sn, **MODEL)
        tm = ModelConfig(spectral_norm=sn, **MODEL)
        jparams, jbn = jdcgan.gan_init(jax.random.key(3), jm)
        d_np = jax.device_get(jparams["disc"])
        bn_np = jax.device_get(jbn["disc"])
        real, fake = _images(1), _images(2)
        key = jax.random.key(9)
        eps = D.uniform(key, (BATCH, 1, 1, 1)).reshape(-1)

        def jcritic(dp):
            return lambda x: jdcgan.discriminator_apply(
                dp, jbn["disc"], x, cfg=jm, train=False)[1][:, 0]

        def jloss(dp):
            if penalty == "gp":
                return jlosses.gradient_penalty(
                    jcritic(dp), jnp.asarray(real), jnp.asarray(fake), key)
            return jlosses.r1_penalty(jcritic(dp), jnp.asarray(real))

        jval, jgrad = jax.value_and_grad(jloss)(jax.device_get(d_np))
        dp = convert._to_torch(d_np, torch.device("cpu"))
        bn = convert._to_torch(bn_np, torch.device("cpu"))
        leaves = {k: v.requires_grad_(True) for k, v in
                  convert.flatten(dp).items()}
        dp = convert.unflatten(leaves)

        def tcritic(x):
            return tdcgan.discriminator_apply(dp, bn, x, cfg=tm,
                                              train=False)[1][:, 0]
        if penalty == "gp":
            tval = tlosses.gradient_penalty(
                tcritic, torch.from_numpy(real), torch.from_numpy(fake),
                torch.from_numpy(eps.copy()))
        else:
            tval = tlosses.r1_penalty(tcritic, torch.from_numpy(real))
        names = sorted(leaves)
        # the head's bias is a constant of the input gradient: JAX's
        # gradient there is 0, torch's unused
        tgrad = {n: torch.zeros_like(leaves[n]) if g is None else g
                 for n, g in zip(names, torch.autograd.grad(
                     tval, [leaves[n] for n in names], allow_unused=True))}
        assert abs(float(tval) - float(jval)) <= 1e-6 * abs(float(jval))
        want = convert.flatten(jax.device_get(jgrad))
        scale = max(float(np.abs(w).max()) for w in want.values())
        assert sorted(want) == names
        for n in names:
            err = float(np.abs(tgrad[n].numpy() - want[n]).max())
            assert err <= 1e-5 * scale, (n, err, scale)


class TestPenaltySteps:
    @pytest.mark.parametrize("kw", [
        {"loss": "wgan-gp"},
        {"loss": "wgan-gp", "gp_weight": 3.0, "diffaug": "color"},
        {"r1_gamma": 10.0},
        {"loss": "hinge", "r1_gamma": 4.0}])
    def test_steps_match_jax(self, kw):
        """Two steps, each from JAX's state: losses and the penalty
        metric, then every state leaf."""
        jm, tm, js, ts, _ = D.run_both(kw, steps=2, resync=True)
        key = "gp" if kw.get("loss") == "wgan-gp" else "r1"
        for j, t in zip(jm, tm):
            assert set(j) == set(t) and key in t
            for k in j:
                assert abs(j[k] - t[k]) <= 1e-5 * max(1.0, abs(j[k])), \
                    (k, j[k], t[k])
            assert t[key] > 0
        D.assert_f32_state(js, ts)

    @pytest.mark.parametrize("flags", [None, (True, False, True)])
    def test_lazy_r1_runs_on_schedule(self, flags):
        """r1_interval 2 from state step 0: the penalty (weighted gamma *
        k / 2) on steps 0 and 2, r1 = 0 and no penalty on step 1; the port
        reads the state's step (flags None) or takes the host's flags, as
        the captured runner passes them."""
        jm, tm, js, ts, _ = D.run_both(
            {"r1_gamma": 10.0, "r1_interval": 2}, steps=3, resync=True,
            penalties=flags)
        for i, (j, t) in enumerate(zip(jm, tm)):
            for k in j:
                assert abs(j[k] - t[k]) <= 1e-5 * max(1.0, abs(j[k])), \
                    (i, k, j[k], t[k])
            assert (t["r1"] > 0) == (i % 2 == 0), (i, t["r1"])
        D.assert_f32_state(js, ts)

    @pytest.mark.parametrize("size", [8, 16])
    def test_wgan_gp_n_critic(self, size):
        """The wgan-gp preset's shape, a penalty critic updated twice per
        step, then G's update through the updated critic."""
        jm, tm, js, ts, _ = D.run_both({"loss": "wgan-gp", "n_critic": 2},
                                       steps=2 if size == 8 else 1,
                                       size=size)
        rtol = 1e-5 if size == 8 else 1e-3
        for j, t in zip(jm, tm):
            assert set(j) == set(t)
            for k in j:
                assert abs(j[k] - t[k]) <= rtol * max(1.0, abs(j[k])), \
                    (size, k, j[k], t[k])
        assert int(ts["opt"]["disc"]["count"]) == 2 * len(jm)
        assert int(ts["opt"]["gen"]["count"]) == len(jm)
        if size == 8:
            assert "disc" in ts["bn"] and not ts["bn"]["disc"]
            D.assert_f32_state(js, ts, steps=2)
            return
        want = D.flat_state(convert.train_state_from_jax(js, device="cpu"))
        got = D.flat_state(ts)
        lr = 2e-4
        held = 0
        for path, w in want.items():
            pre_bn = D.PRE_BN.search(path)
            if "/gen/" in path or path.startswith("ema_gen/"):
                if path.startswith("opt/"):
                    continue
                bound = 2 * lr if pre_bn else 1e-5 + 1e-5 * np.abs(w).max()
            elif "/disc/" in path and pre_bn and not path.startswith("opt/"):
                bound = 2 * lr * 2
            else:
                continue
            err = float(np.abs(got[path].astype(np.float64) - w).max())
            assert err <= bound, (path, err, bound)
            held += 1
        assert held == 26


class TestKernelRouteRefusal:
    @pytest.mark.parametrize("route", [
        {"use_pallas": True, "pallas_fused": True}, {"use_pallas": True}])
    @pytest.mark.parametrize("kw", [{"loss": "wgan-gp"},
                                    {"r1_gamma": 10.0}])
    def test_reference_fails_and_port_refuses(self, route, kw):
        """The JAX package's penalty step fails on its kernel routes (a
        pallas_call has no second derivative; the bn_pallas route fails
        its linearization), so the port refuses the combination by name.
        If the reference ever trains it, this test fails and says so."""
        jcfg = JTrainConfig(model=JModelConfig(**MODEL, **route),
                            batch_size=BATCH, **kw)
        fns = jsteps.make_train_step(jcfg)
        state = jax.eval_shape(fns.init, jax.random.key(0))
        images = jax.ShapeDtypeStruct((BATCH, 16, 16, 3), jnp.float32)
        try:
            jax.eval_shape(fns.train_step, state, images,
                           jax.random.key(1))
        except (AssertionError, ValueError, NotImplementedError,
                TypeError):
            pass
        else:
            pytest.fail("the JAX package now traces a penalty through its "
                        f"kernel route {route}: the port's refusal can go")
        with pytest.raises(NotImplementedError,
                           match="second derivative"):
            TrainConfig(model=ModelConfig(**MODEL, **route),
                        batch_size=BATCH, **kw)

    @staticmethod
    def _jax_traces(model, kw):
        """Whether the JAX package's train step traces (eval_shape: the
        penalty's second derivative is taken while tracing)."""
        jcfg = JTrainConfig(model=JModelConfig(**MODEL, **model),
                            batch_size=BATCH, **kw)
        fns = jsteps.make_train_step(jcfg)
        state = jax.eval_shape(fns.init, jax.random.key(0))
        images = jax.ShapeDtypeStruct((BATCH, 16, 16, 3), jnp.float32)
        try:
            jax.eval_shape(fns.train_step, state, images, jax.random.key(1))
        except (AssertionError, ValueError, NotImplementedError,
                TypeError):
            return False
        return True

    @pytest.mark.parametrize("arch", ["resnet", "dcgan"])
    @pytest.mark.parametrize("kw", [{"loss": "wgan-gp"},
                                    {"r1_gamma": 10.0}])
    def test_attention_on_flash_is_refused_in_any_family(self, arch, kw):
        """A penalty through an attention block on the flash kernels
        (the JAX package's Pallas attention) fails in JAX whatever the
        family; BatchNorm on plain ops (bn_pallas False) does not help."""
        model = {"arch": arch, "attn_res": 8, "use_pallas": True,
                 "bn_pallas": False}
        assert not self._jax_traces(model, kw)
        with pytest.raises(NotImplementedError,
                           match="second derivative"):
            TrainConfig(model=ModelConfig(**MODEL, **model),
                        batch_size=BATCH, **kw)

    @pytest.mark.parametrize("arch,kw", [
        ("resnet", {"loss": "wgan-gp"}), ("resnet", {"r1_gamma": 10.0}),
        ("stylegan", {"r1_gamma": 10.0})])
    def test_norm_free_critic_trains_the_penalty(self, arch, kw):
        """The residual critic is norm-free and G's images reach D
        detached, so the penalty's double backward meets no kernel: the
        JAX package traces resnet (G's BatchNorm on its kernels) with
        WGAN-GP or R1 and stylegan with R1 under use_pallas, and the port
        builds the step and takes it, the penalty finite and positive."""
        model = {"arch": arch, "use_pallas": True}
        assert self._jax_traces(model, kw)
        cfg = TrainConfig(model=ModelConfig(**MODEL, **model),
                          batch_size=BATCH, **kw)
        fns = tsteps.make_train_step(cfg)
        state = fns.init(seed=0, device="cpu")
        z = torch.rand((BATCH, 8), generator=torch.Generator().manual_seed(
            1)) * 2 - 1
        draws = tsteps.draw_step(cfg, torch.Generator().manual_seed(2))
        state, m = fns.train_step(state, torch.from_numpy(_images(3)), z,
                                  draws)
        key = "gp" if cfg.loss == "wgan-gp" else "r1"
        assert 0 < float(m[key]) < float("inf")
        assert int(state["step"]) == 1


class TestKernel5Backward:
    @pytest.mark.parametrize("dtype,act", [
        ("float32", "relu"), ("float32", "lrelu"), ("bfloat16", "relu"),
        ("bfloat16", "lrelu")])
    def test_grad_matches_jax(self, dtype, act):
        """gemm_bias_scale_act's five cotangents, the port's autograd
        Function against jax.grad of the JAX custom VJP (Pallas in
        interpret mode), at a G stage's shape of the small model."""
        rng = np.random.default_rng(4)
        m, k, c = 128, 200, 16
        arrs = [rng.normal(size=s).astype(np.float32) for s in
                [(m, k), (k, c), (c,), (c,), (c,), (m, c)]]
        p2d, w2d, b, scale, shift, g = arrs
        jdt = jnp.dtype(dtype)
        tdt = getattr(torch, dtype)

        def jf(p, w, bb, s, t):
            y = jfused.gemm_bias_scale_act(p, w, bb, s, t, act, 0.2, jdt)
            return jnp.sum(y.astype(jnp.float32) * g)
        jin = [jnp.asarray(p2d, jdt), jnp.asarray(w2d, jdt),
               jnp.asarray(b), jnp.asarray(scale), jnp.asarray(shift)]
        jgrads = jax.grad(jf, argnums=(0, 1, 2, 3, 4))(*jin)
        tin = [torch.from_numpy(p2d).to(tdt), torch.from_numpy(w2d).to(tdt),
               torch.from_numpy(b), torch.from_numpy(scale),
               torch.from_numpy(shift)]
        tin = [t.requires_grad_(True) for t in tin]
        y = tfused.gemm_bias_scale_act(*tin, act, 0.2, tdt)
        assert y.grad_fn is not None
        tgrads = torch.autograd.grad((y.float() * torch.from_numpy(g)).sum(),
                                     tin)
        for name, jg, tg in zip(("p2d", "w2d", "b", "scale", "shift"),
                                jgrads, tgrads):
            want = np.asarray(jg.astype(jnp.float32))
            assert tg.dtype == tin[["p2d", "w2d", "b", "scale",
                                    "shift"].index(name)].dtype
            got = tg.float().numpy()
            tol = (1e-5 if dtype == "float32" else 2.0 ** -7) \
                * float(np.abs(want).max())
            assert float(np.abs(got - want).max()) <= tol, name

    def test_plain_autograd_agrees(self):
        """On the CPU the Function's backward equals autograd through the
        plain version's own ops (f64 inputs to take rounding out)."""
        rng = np.random.default_rng(5)
        t = [torch.from_numpy(rng.normal(size=s)).float().requires_grad_()
             for s in [(64, 40), (40, 8), (8,), (8,), (8,)]]
        g = torch.from_numpy(rng.normal(size=(64, 8))).float()
        y = tfused.gemm_bias_scale_act(*t, "lrelu", 0.2, torch.float32)
        got = torch.autograd.grad((y * g).sum(), t)
        y2 = tfused.gemm_bias_scale_act_plain(*t, "lrelu", 0.2,
                                              torch.float32)
        want = torch.autograd.grad((y2 * g).sum(), t)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_wgan_gp_preset_equals_jax():
    from dcgan_tpu.presets import wgan_gp as j_wgan_gp
    from dcgan_tpu_torch.presets import get_preset

    jt, t = j_wgan_gp(), get_preset("wgan-gp")
    for f in dataclasses.fields(TrainConfig):
        if f.name != "model":
            assert getattr(t, f.name) == getattr(jt, f.name), f.name
    assert dataclasses.asdict(t.model) == dataclasses.asdict(jt.model)
