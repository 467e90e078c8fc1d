"""The port's SAGAN pieces against `dcgan_tpu`'s on the CPU: spectral norm,
the flash-attention plain versions, the attention block on both routes,
a tiny SAGAN's G, D and sampler, 4 hinge/TTUR/SN/EMA training steps, and
the weights' round trips.

The port's flash wrappers take their plain versions on CPU tensors; the JAX
side runs its Pallas flash kernels in interpret mode. gamma, the block's
residual gate, starts at 0, where every gradient into q, k and v is
multiplied by 0, so every case here sets it to 0.5.

Tolerances are JAX's own test tolerances unless a case states another:
f32 2e-6 on forward values and 2e-5 on gradients (summation order only);
bf16 1e-2 (the two frameworks round bf16 at different points).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcgan_tpu.config import ModelConfig as JModelConfig
from dcgan_tpu.models import dcgan as jdcgan
from dcgan_tpu.ops import attention as jattn
from dcgan_tpu.ops import spectral as jspectral
from dcgan_tpu.ops.pallas_attention import _fwd_impl as j_fwd_impl
from dcgan_tpu.ops.pallas_attention import flash_attention as j_flash
from dcgan_tpu.presets import sagan64 as j_sagan64
from dcgan_tpu.train import steps as jsteps
from dcgan_tpu_torch import convert
from dcgan_tpu_torch.config import ModelConfig
from dcgan_tpu_torch.ops import attention as tattn
from dcgan_tpu_torch.ops import flash_attention as tflash
from dcgan_tpu_torch.ops import spectral as tspectral
from dcgan_tpu_torch.presets import sagan64
from dcgan_tpu_torch.train import steps as tsteps
from dcgan_tpu_torch.train.trainer import METRIC_KEYS
from torch_jax_draws import one_torch_thread  # noqa: F401

F32_FWD, F32_GRAD, BF16 = 2e-6, 2e-5, 1e-2
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
GAMMA = 0.5
# the tiny SAGAN: attention at 8x8 (S = 64) in both nets, 16 channels there
TINY = dict(output_size=16, gf_dim=16, df_dim=16, z_dim=8, attn_res=8,
            spectral_norm="gd")
ROUTES = {"dense": {}, "flash": {"use_pallas": True, "bn_pallas": False}}


def _np(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)) \
        .astype(np.float32)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def _j(x, dtype=jnp.float32):
    return jnp.asarray(np.asarray(x, np.float32)).astype(dtype)


def _close(got, want, tol):
    g = got.detach().float().numpy() if torch.is_tensor(got) \
        else np.asarray(got, np.float32)
    w = np.asarray(jnp.asarray(want, jnp.float32)) \
        if not isinstance(want, np.ndarray) else want
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=0, atol=tol)


def _with_gamma(tree):
    """The params tree with every attention block's gamma set to GAMMA."""
    return {k: ({**v, "gamma": np.float32(GAMMA)} if k == "attn"
                else _with_gamma(v) if isinstance(v, dict) else v)
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# spectral norm
# ---------------------------------------------------------------------------

class TestSpectralNorm:
    @pytest.mark.parametrize("shape", [(24, 10), (5, 5, 6, 4), (3, 1)])
    @pytest.mark.parametrize("train", [True, False])
    def test_matches_jax(self, shape, train):
        w, r = _np(0, shape), _np(1, shape)
        u = jspectral.spectral_u_init(jax.random.key(2), shape[-1])
        jw, ju = jspectral.spectral_normalize(_j(w), u, train=train)
        wt = _t(w).requires_grad_(True)
        tw, tu = tspectral.spectral_normalize(wt, _t(u), train=train)
        _close(tw, jw, F32_FWD)
        _close(tu, ju, F32_FWD)
        assert not tu.requires_grad
        # the gradient through sigma (the -W dsigma/dW / sigma^2 term)
        jg = jax.grad(lambda x: jnp.sum(jspectral.spectral_normalize(
            x, u, train=train)[0] * _j(r)))(_j(w))
        (tg,) = torch.autograd.grad((tw * _t(r)).sum(), wt)
        _close(tg, jg, F32_GRAD)

    def test_sigma_gradient_term_is_kept(self):
        """Through a detached sigma the gradient would be r / sigma alone;
        the live sigma changes it."""
        w, r = _np(3, (12, 6)), _np(4, (12, 6))
        u = _t(jspectral.spectral_u_init(jax.random.key(5), 6))
        wt = _t(w).requires_grad_(True)
        tw, _ = tspectral.spectral_normalize(wt, u, train=True)
        (g,) = torch.autograd.grad((tw * _t(r)).sum(), wt)
        sigma = float((_t(w) / tw.detach()).mean())
        assert float((g - _t(r) / sigma).abs().max()) > 1e-3

    def test_eval_keeps_u_and_train_advances_it(self):
        w = _t(_np(6, (16, 8)))
        u = tspectral.spectral_u_init(torch.Generator().manual_seed(0), 8)
        assert abs(float(u.norm()) - 1.0) < 1e-6
        _, u_eval = tspectral.spectral_normalize(w, u, train=False)
        _, u_train = tspectral.spectral_normalize(w, u, train=True)
        assert torch.equal(u_eval, u)
        assert not torch.equal(u_train, u)


# ---------------------------------------------------------------------------
# flash attention, plain versions
# ---------------------------------------------------------------------------

def _qkv(dtype_name, b=2, s=64, dk=8, dv=32, seed=10):
    arrs = [_np(seed + i, (b, s, d)) for i, d in enumerate((dk, dk, dv))]
    tdt, jdt = DTYPES[dtype_name]
    return arrs, [_t(a, tdt) for a in arrs], [_j(a, jdt) for a in arrs]


class TestFlashPlain:
    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_forward_matches_jax(self, dtype):
        _, (q, k, v), (jq, jk, jv) = _qkv(dtype)
        scale = 8 ** -0.5
        tol = F32_FWD if dtype == "float32" else BF16
        out, lse = tflash.flash_fwd(q, k, v, scale)
        j_out, j_lse = j_fwd_impl(jq, jk, jv, scale)
        _close(out, j_out, tol)
        _close(lse, j_lse[..., 0], tol)
        assert out.dtype == torch.float32 and lse.shape == (2, 64)
        _close(tflash.flash_attention(q, k, v, scale),
               j_flash(jq, jk, jv, scale), tol)

    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_backward_matches_jax(self, dtype):
        arrs, tq, jq = _qkv(dtype)
        r = _np(20, (2, 64, 32))
        scale = 8 ** -0.5
        tol = F32_GRAD if dtype == "float32" else BF16
        jg = jax.grad(lambda q, k, v: jnp.sum(
            j_flash(q, k, v, scale) * _j(r)), argnums=(0, 1, 2))(*jq)
        leaves = [t.requires_grad_(True) for t in tq]
        tg = torch.autograd.grad(
            (tflash.flash_attention(*leaves, scale) * _t(r)).sum(), leaves)
        for name, a, b_, t in zip("qkv", tg, jg, tq):
            assert a.dtype == t.dtype, name
            _close(a, b_, tol)

    def test_plain_forward_is_dense_attention(self):
        """In f32 the single-block form is softmax attention: it equals
        the port's full_attention (and JAX's)."""
        arrs, (q, k, v), (jq, jk, jv) = _qkv("float32", s=100)
        out, _ = tflash.flash_fwd_plain(q, k, v, 0.3)
        _close(out, tattn.full_attention(q, k, v, scale=0.3), F32_FWD)
        _close(out, jattn.full_attention(jq, jk, jv, scale=0.3), F32_FWD)

    def test_error_bounds_cover_the_bf16_rounding_of_p_and_ds(self):
        """kernel_error_bounds, the card checks' tolerance, covers one bf16
        rounding of each p and ds: the bf16 plain versions stay within it
        of the same functions on the same (bf16-valued) inputs in f32."""
        _, (q, k, v), _ = _qkv("bfloat16", s=48)
        g = _t(_np(21, (2, 48, 32)))
        scale = 8 ** -0.5
        qf, kf, vf = q.float(), k.float(), v.float()
        out, lse = tflash.flash_fwd_plain(q, k, v, scale)
        do, delta = tflash.bwd_stats(q, out, g)
        bounds = tflash.kernel_error_bounds(q, k, v, do, lse, delta, scale)
        out32, _ = tflash.flash_fwd_plain(qf, kf, vf, scale)
        assert bool(((out - out32).abs() <= bounds["out"]).all())
        args = (do.float(), lse, delta, scale)
        for got, want, name in (
                (tflash.flash_dq_plain(q, k, v, do, lse, delta, scale),
                 tflash.flash_dq_plain(qf, kf, vf, *args), "dq"),
                *zip(tflash.flash_dkv_plain(q, k, v, do, lse, delta, scale),
                     tflash.flash_dkv_plain(qf, kf, vf, *args),
                     ("dk", "dv"))):
            ulp = 2.0 ** -7 * want.abs()
            assert bool(((got.float() - want).abs()
                         <= bounds[name] + ulp).all()), name

    def test_bwd_stats(self):
        q = _t(_np(30, (2, 5, 8)), torch.bfloat16)
        out, g = _t(_np(31, (2, 5, 4))), _t(_np(32, (2, 5, 4)))
        do, delta = tflash.bwd_stats(q, out, g)
        assert do.dtype == torch.bfloat16 and delta.shape == (2, 5)
        torch.testing.assert_close(delta, (g * out).sum(-1))

    def test_wrappers_take_the_plain_versions_on_the_cpu(self):
        _, (q, k, v), _ = _qkv("bfloat16")
        before = (tflash.flash_fwd.launches, tflash.flash_dq.launches,
                  tflash.flash_dkv.launches)
        out, lse = tflash.flash_fwd(q, k, v, 0.5)
        want_out, want_lse = tflash.flash_fwd_plain(q, k, v, 0.5)
        assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
        do, delta = tflash.bwd_stats(q, out, torch.ones_like(out))
        assert torch.equal(
            tflash.flash_dq(q, k, v, do, lse, delta, 0.5),
            tflash.flash_dq_plain(q, k, v, do, lse, delta, 0.5))
        for a, b in zip(tflash.flash_dkv(q, k, v, do, lse, delta, 0.5),
                        tflash.flash_dkv_plain(q, k, v, do, lse, delta,
                                               0.5)):
            assert torch.equal(a, b)
        assert (tflash.flash_fwd.launches, tflash.flash_dq.launches,
                tflash.flash_dkv.launches) == before


# ---------------------------------------------------------------------------
# the attention block
# ---------------------------------------------------------------------------

def _block_params(ch, seed=40):
    p = jattn.attn_init(jax.random.key(seed), ch)
    p = jax.tree_util.tree_map(np.asarray, p)
    for sub in tattn.SUBLAYERS:
        p[sub]["b"] = _np(seed + 1, p[sub]["b"].shape, 0.05)
    p["gamma"] = np.float32(GAMMA)
    return p


class TestAttnApply:
    @pytest.mark.parametrize("route", sorted(ROUTES))
    @pytest.mark.parametrize("heads", [1, 2])
    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_matches_jax(self, route, heads, dtype):
        use_pallas = route == "flash"
        params = _block_params(16)
        x = _np(50, (2, 8, 8, 16))
        r = _np(51, (2, 8, 8, 16))
        tdt, jdt = DTYPES[dtype]

        def jfn(p, x):
            return jattn.attn_apply(p, x, compute_dtype=jdt,
                                    num_heads=heads, use_pallas=use_pallas)

        def jloss(p, x):
            out = jfn(p, x)
            return jnp.sum(out.astype(jnp.float32) * _j(r)), out

        jp = jax.tree_util.tree_map(jnp.asarray, params)
        (_, want), (jgp, jgx) = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True))(jp, _j(x, jdt))

        tp = convert._to_torch(params, torch.device("cpu"))
        tp = tsteps.tree_map(lambda t: t.requires_grad_(True), tp)
        tx = _t(x, tdt).requires_grad_(True)
        got = tattn.attn_apply(tp, tx, compute_dtype=tdt, num_heads=heads,
                               use_pallas=use_pallas)
        assert got.dtype == tdt and got.shape == tx.shape
        leaves = tsteps.tree_leaves(tp)
        grads = torch.autograd.grad((got.float() * _t(r)).sum(),
                                    leaves + [tx])
        fwd_tol = F32_FWD * 10 if dtype == "float32" else BF16
        _close(got, want, fwd_tol)
        grad_tol = F32_GRAD if dtype == "float32" else BF16
        flat_j = convert.flatten(jax.device_get(jgp))
        for (path, _), g in zip(convert.flatten(tp).items(), grads):
            if dtype == "bfloat16" and not path.endswith("/w"):
                # the bias and gamma gradients are sums over the B * S
                # rows that the two frameworks round in bf16 at different
                # points (gamma's measured up to twice its value); in f32
                # they are held below
                continue
            w = np.asarray(jnp.asarray(flat_j[path], jnp.float32))
            tol = grad_tol * max(1.0, np.abs(w).max())
            _close(g, w, tol)
        _close(grads[-1], jgx, grad_tol)

    def test_routes_agree_in_f32(self):
        params = convert._to_torch(_block_params(32), torch.device("cpu"))
        x = _t(_np(52, (2, 6, 6, 32)))
        a = tattn.attn_apply(params, x, use_pallas=True)
        b = tattn.attn_apply(params, x, use_pallas=False)
        torch.testing.assert_close(a, b, rtol=0, atol=F32_FWD)
        assert not torch.equal(a, x)

    def test_identity_at_init(self):
        p = tattn.attn_init(torch.Generator().manual_seed(0), 16)
        x = _t(_np(53, (1, 4, 4, 16)))
        assert float(p["gamma"]) == 0.0
        assert torch.equal(tattn.attn_apply(p, x), x)

    def test_init_tree_matches_jax(self):
        jp = jattn.attn_init(jax.random.key(0), 64)
        tp = tattn.attn_init(torch.Generator().manual_seed(0), 64)
        assert {k: tuple(v.shape) for k, v in convert.flatten(tp).items()} \
            == {k: tuple(v.shape) for k, v in convert.flatten(
                jax.device_get(jp)).items()}

    def test_refusals(self):
        with pytest.raises(ValueError, match=">= 8 channels"):
            tattn.attn_init(torch.Generator(), 4)
        p = tattn.attn_init(torch.Generator().manual_seed(0), 16)
        x = torch.zeros((1, 2, 2, 16))
        with pytest.raises(ValueError, match="num_heads"):
            tattn.attn_apply(p, x, num_heads=3)
        # over a sequence mesh (since PR 20): JAX's refusals of an unknown
        # strategy and of heads that do not divide over the axis
        from dcgan_tpu_torch.parallel.collectives import LocalRing

        with pytest.raises(ValueError, match="unknown seq_strategy"):
            tattn.attn_apply(p, x, seq_mesh=LocalRing(2),
                             seq_strategy="zigzag")
        with pytest.raises(ValueError, match="divisible"):
            tattn.attn_apply(p, x, seq_mesh=LocalRing(2),
                             seq_strategy="ulysses")


# ---------------------------------------------------------------------------
# a tiny SAGAN: G, D and the sampler
# ---------------------------------------------------------------------------

def _tiny(route, dtype="float32", **kw):
    return dict(TINY, compute_dtype=dtype, **ROUTES[route], **kw)


@functools.lru_cache(maxsize=1)
def _jax_nets():
    """numpy (params, state) of both tiny nets from the JAX init, gamma
    set, BN betas and conv biases nonzero (the same for every route and
    compute dtype; callers copy before changing them)."""
    jcfg = JModelConfig(**TINY)
    rng = np.random.default_rng(0)
    out = []
    for init, key in ((jdcgan.generator_init, 1),
                      (jdcgan.discriminator_init, 2)):
        p, s = init(jax.random.key(key), jcfg)
        p = _with_gamma(jax.tree_util.tree_map(np.asarray, p))
        for name, leaf in p.items():
            if name.startswith(("deconv", "conv")):
                leaf["b"] = rng.normal(0, 0.02, leaf["b"].shape) \
                    .astype(np.float32)
            elif name.startswith("bn"):
                leaf["bias"] = rng.normal(0, 0.1, leaf["bias"].shape) \
                    .astype(np.float32)
        out.append((p, jax.tree_util.tree_map(np.asarray, s)))
    return out


def _state_close(got, want, bn_tol):
    """SN vectors (f32 power iteration on f32 weights) within 1e-5; BN
    moments within bn_tol."""
    fj = convert.flatten(jax.device_get(want))
    fg = convert.flatten(got)
    assert sorted(fg) == sorted(fj)
    for path, w in fj.items():
        _close(fg[path], np.asarray(w, np.float32),
               1e-5 if path.startswith("sn_") else bn_tol)


# ---------------------------------------------------------------------------
# training: hinge, TTUR, SN and EMA
# ---------------------------------------------------------------------------

STEPS, BATCH = 4, 4


def _train_both(route):
    """Per-step JAX and port losses and both final states after STEPS
    steps of the sagan64 recipe at the tiny size from one state with
    gamma = GAMMA in both nets and in the EMA copy."""
    mk = _tiny(route)
    jcfg = j_sagan64(model=JModelConfig(**mk), batch_size=BATCH)
    tcfg = sagan64(model=ModelConfig(**mk), batch_size=BATCH)
    jfns = jsteps.make_train_step(jcfg)
    jstate = jax.device_get(jfns.init(jax.random.key(0)))
    jstate = {**jstate, "params": _with_gamma(jstate["params"]),
              "ema_gen": _with_gamma(jstate["ema_gen"])}
    tstate = convert.train_state_from_jax(jstate, device="cpu")
    tstate0 = tstate
    jstate = jax.tree_util.tree_map(jnp.asarray, jstate)
    jstep = jax.jit(jfns.train_step)
    tstep = tsteps.make_train_step(tcfg).train_step
    rng = np.random.default_rng(1)
    jl, tl = [], []
    for i in range(STEPS):
        images = np.tanh(rng.normal(size=(BATCH, 16, 16, 3))).astype(
            np.float32)
        key = jax.random.fold_in(jax.random.key(5), i)
        z_key, _ = jax.random.split(key)
        z = np.array(jax.random.uniform(z_key, (BATCH, 8), minval=-1.0,
                                        maxval=1.0, dtype=jnp.float32))
        jstate, jm = jstep(jstate, jnp.asarray(images), key)
        tstate, tm = tstep(tstate, torch.from_numpy(images),
                           torch.from_numpy(z))
        jl.append({k: float(jm[k]) for k in METRIC_KEYS})
        tl.append({k: float(tm[k]) for k in METRIC_KEYS})
    return jl, tl, jax.device_get(jstate), tstate, tstate0


# ---------------------------------------------------------------------------
# weights in and out
# ---------------------------------------------------------------------------
