"""The two ported kernels: plain versions against the JAX kernels on the
CPU, and the CUDA kernels against their plain versions on the card.

On the CPU the wrappers take the plain PyTorch versions (a CPU tensor is
the only thing that selects them); the JAX side runs the Pallas kernels in
interpret mode, as the JAX package's own tests do. Tolerances:
- f32: 1e-5 (summation order only);
- bf16 outputs: one bf16 ulp of each value, |a - b| <= 2^-7 |b| + 1e-6,
  since both compute in f32 and round once, possibly to neighbours.

The `cuda`-marked tests need the card and skip without one; on a GPU
machine run them with
    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels.py
(--noconftest: the suite's conftest imports JAX, which the GPU machine
does not need). This module imports JAX only inside the fixture that needs
it, so those runs collect it without JAX.
"""

import types

import numpy as np
import pytest
import torch

from dcgan_tpu_torch.ops import fused, kernels
from dcgan_tpu_torch.ops.activations import ACTS

BF16_ULP = 2.0 ** -7
ACT_LIST = list(ACTS)


@pytest.fixture(scope="module")
def jref():
    """The JAX package's kernels (Pallas interpret mode on the CPU)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from dcgan_tpu.ops import pallas_fused, pallas_kernels

    return types.SimpleNamespace(jax=jax, jnp=jnp, fused=pallas_fused,
                                 kernels=pallas_kernels)


@pytest.fixture
def cuda():
    """The card, with TF32 off for the f32 comparisons (cuDNN defaults to
    it; the plain versions' f32 matmuls must stay full f32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
        saved


def _np(seed, shape, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape) \
        .astype(np.float32)


def _assert_close(got, want, dtype):
    g = got.detach().float().cpu().numpy() if torch.is_tensor(got) else got
    w = want.detach().float().cpu().numpy() if torch.is_tensor(want) \
        else want
    if dtype == torch.bfloat16:
        bad = np.abs(g - w) > BF16_ULP * np.abs(w) + 1e-6
        assert not bad.any(), f"{bad.sum()} elements beyond one bf16 ulp"
    else:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def _j2np(jnp, x):
    return np.asarray(jnp.asarray(x, jnp.float32))


DTYPES = [(torch.float32, "float32"), (torch.bfloat16, "bfloat16")]


class TestScaleShiftActPlain:
    @pytest.mark.parametrize("act", ACT_LIST)
    @pytest.mark.parametrize("tdt,jname", DTYPES)
    @pytest.mark.parametrize("shape", [(24, 40), (7, 13)])
    def test_matches_jax(self, jref, act, tdt, jname, shape):
        jnp = jref.jnp
        x = _np(0, shape, -2, 2)
        scale, shift = _np(1, shape[1:], 0.5, 1.5), _np(2, shape[1:])
        got = kernels.scale_shift_act(torch.from_numpy(x).to(tdt),
                                      torch.from_numpy(scale),
                                      torch.from_numpy(shift), act)
        want = jref.kernels.scale_shift_act(
            jnp.asarray(x, jnp.dtype(jname)), jnp.asarray(scale),
            jnp.asarray(shift), act)
        assert got.dtype == tdt
        _assert_close(got, _j2np(jnp, want), tdt)

    def test_fused_bn_act_matches_jax(self, jref):
        jnp = jref.jnp
        x = _np(3, (2, 4, 4, 8), -2, 2)
        g, b, m = _np(4, (8,), 0.5, 1.5), _np(5, (8,)), _np(6, (8,))
        v = _np(7, (8,), 0.2, 2.0)
        got = kernels.fused_bn_act(*(torch.from_numpy(a)
                                     for a in (x, g, b, m, v)),
                                   eps=1e-5, act="relu")
        want = jref.kernels.fused_bn_act(*(jnp.asarray(a)
                                           for a in (x, g, b, m, v)),
                                         eps=1e-5, act="relu")
        assert tuple(got.shape) == x.shape
        _assert_close(got, _j2np(jnp, want), torch.float32)

    def test_cpu_takes_plain_version_without_counting(self):
        before = kernels.scale_shift_act.launches
        x = torch.from_numpy(_np(8, (4, 6)))
        y = kernels.scale_shift_act(x, torch.ones(6), torch.zeros(6), "relu")
        assert kernels.scale_shift_act.launches == before
        torch.testing.assert_close(y, torch.relu(x))

    def test_rejects_bad_arguments(self):
        with pytest.raises(ValueError, match="unknown act"):
            kernels.scale_shift_act(torch.zeros(2, 3), torch.ones(3),
                                    torch.zeros(3), "gelu")
        with pytest.raises(ValueError, match="2-D"):
            kernels.scale_shift_act(torch.zeros(2, 3, 4), torch.ones(4),
                                    torch.zeros(4))


class TestGemmBiasScaleActPlain:
    @pytest.mark.parametrize("act", ACT_LIST)
    @pytest.mark.parametrize("tdt,jname", DTYPES)
    @pytest.mark.parametrize("mkc", [(37, 29, 11), (64, 96, 16), (5, 1, 3)])
    def test_matches_jax_ragged(self, jref, act, tdt, jname, mkc):
        jnp = jref.jnp
        m, k, c = mkc
        p, w = _np(10, (m, k)), _np(11, (k, c), -0.3, 0.3)
        b, scale, shift = _np(12, (c,)), _np(13, (c,), 0.5, 1.5), \
            _np(14, (c,))
        jdt = jnp.dtype(jname)
        got = fused.gemm_bias_scale_act(
            torch.from_numpy(p).to(tdt), torch.from_numpy(w).to(tdt),
            torch.from_numpy(b), torch.from_numpy(scale),
            torch.from_numpy(shift), act, 0.2, tdt)
        want = jref.fused.gemm_bias_scale_act(
            jnp.asarray(p, jdt), jnp.asarray(w, jdt), jnp.asarray(b),
            jnp.asarray(scale), jnp.asarray(shift), act, 0.2, jdt)
        assert got.dtype == tdt and tuple(got.shape) == (m, c)
        _assert_close(got, _j2np(jnp, want), tdt)

    @pytest.mark.parametrize("tdt,jname", DTYPES)
    def test_fused_stage_matches_jax(self, jref, tdt, jname):
        """fused_conv_bn_act(train=False), the whole interior G stage."""
        jnp = jref.jnp
        x = _np(20, (2, 4, 4, 6), 0, 1)
        w, b = _np(21, (5, 5, 6, 10), -0.1, 0.1), _np(22, (10,), -0.1, 0.1)
        gamma, beta = _np(23, (10,), 0.5, 1.5), _np(24, (10,))
        mean, var = _np(25, (10,), -0.2, 0.2), _np(26, (10,), 0.1, 0.5)
        jdt = jnp.dtype(jname)
        got, state = fused.fused_conv_bn_act(
            {"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
            {"scale": torch.from_numpy(gamma), "bias": torch.from_numpy(beta)},
            {"mean": torch.from_numpy(mean), "var": torch.from_numpy(var)},
            torch.from_numpy(x), transpose=True, kernel=5, train=False,
            act="relu", compute_dtype=tdt)
        want, _ = jref.fused.fused_conv_bn_act(
            {"w": jnp.asarray(w), "b": jnp.asarray(b)},
            {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)},
            {"mean": jnp.asarray(mean), "var": jnp.asarray(var)},
            jnp.asarray(x), transpose=True, kernel=5, train=False,
            act="relu", compute_dtype=jdt)
        assert got.dtype == tdt and tuple(got.shape) == (2, 8, 8, 10)
        _assert_close(got, _j2np(jnp, want), tdt)
        assert state["mean"] is not None

    def test_fused_train_mode_not_ported_yet(self):
        with pytest.raises(NotImplementedError):
            fused.fused_conv_bn_act({}, {}, {}, torch.zeros(1, 2, 2, 1),
                                    transpose=True, kernel=5, train=True,
                                    act="relu")

    def test_rejects_bad_arguments(self):
        p, w = torch.zeros(4, 3), torch.zeros(5, 2)
        v = torch.zeros(2)
        with pytest.raises(ValueError, match="p2d"):
            fused.gemm_bias_scale_act(p, w, v, v, v)
        with pytest.raises(TypeError, match="dtypes differ"):
            fused.gemm_bias_scale_act(torch.zeros(4, 5), w.bfloat16(), v, v,
                                      v)
        with pytest.raises(TypeError, match="out_dtype"):
            fused.gemm_bias_scale_act(torch.zeros(4, 5), w, v, v, v,
                                      out_dtype=torch.float16)


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version, same tensors
# ---------------------------------------------------------------------------

@pytest.mark.cuda
class TestKernelsOnCard:
    @pytest.mark.parametrize("act", ACT_LIST)
    @pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape", [(1024, 512), (37, 70), (5, 3)])
    def test_scale_shift_act(self, cuda, act, tdt, shape):
        x = torch.from_numpy(_np(30, shape, -2, 2)).to(cuda, tdt)
        scale = torch.from_numpy(_np(31, shape[1:], 0.5, 1.5)).to(cuda)
        shift = torch.from_numpy(_np(32, shape[1:])).to(cuda)
        before = kernels.scale_shift_act.launches
        got = kernels.scale_shift_act(x, scale, shift, act)
        torch.cuda.synchronize()
        assert kernels.scale_shift_act.launches == before + 1
        _assert_close(got, kernels.scale_shift_act_plain(x, scale, shift,
                                                         act), tdt)

    @pytest.mark.parametrize("act", ACT_LIST)
    @pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("mkc", [(37, 29, 11), (100, 40, 72),
                                     (300, 800, 256), (1024, 3200, 64),
                                     (64, 12800, 256), (200, 3000, 40)])
    def test_gemm_bias_scale_act(self, cuda, act, tdt, mkc):
        m, k, c = mkc
        p = torch.from_numpy(_np(40, (m, k))).to(cuda, tdt)
        w = torch.from_numpy(_np(41, (k, c), -0.05, 0.05)).to(cuda, tdt)
        b, scale, shift = (torch.from_numpy(a).to(cuda) for a in (
            _np(42, (c,)), _np(43, (c,), 0.5, 1.5), _np(44, (c,))))
        before = fused.gemm_bias_scale_act.launches
        got = fused.gemm_bias_scale_act(p, w, b, scale, shift, act,
                                        out_dtype=tdt)
        torch.cuda.synchronize()
        assert fused.gemm_bias_scale_act.launches == before + 1
        want = fused.gemm_bias_scale_act_plain(p, w, b, scale, shift, act,
                                               out_dtype=tdt)
        g, wnt = got.float(), want.float()
        # f32 sums of <= 12800 products in another order (split-K for the
        # small-M bf16 cases): 1e-4 absolute
        tol = BF16_ULP * wnt.abs() + 1e-4 if tdt == torch.bfloat16 \
            else 1e-5 * wnt.abs() + 1e-4
        assert bool(((g - wnt).abs() <= tol).all())

    def test_bf16_operands_f32_output(self, cuda):
        p = torch.from_numpy(_np(50, (64, 48))).to(cuda, torch.bfloat16)
        w = torch.from_numpy(_np(51, (48, 16), -0.1, 0.1)).to(
            cuda, torch.bfloat16)
        v = torch.ones(16, device=cuda)
        got = fused.gemm_bias_scale_act(p, w, 0 * v, v, 0 * v, "none",
                                        out_dtype=torch.float32)
        want = fused.gemm_bias_scale_act_plain(p, w, 0 * v, v, 0 * v, "none",
                                               out_dtype=torch.float32)
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)

    def test_wrappers_raise_instead_of_falling_back(self, cuda):
        x = torch.zeros(8, 6, device=cuda).t()   # not contiguous
        with pytest.raises(ValueError, match="contiguous"):
            kernels.scale_shift_act(x, torch.ones(8, device=cuda),
                                    torch.zeros(8, device=cuda))
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            kernels.scale_shift_act(torch.zeros(4, 4, device=cuda,
                                                dtype=torch.float16),
                                    torch.ones(4, device=cuda),
                                    torch.zeros(4, device=cuda))
        with pytest.raises(ValueError, match="is on"):
            fused.gemm_bias_scale_act(torch.zeros(4, 4, device=cuda),
                                      torch.zeros(4, 2, device=cuda),
                                      torch.zeros(2), torch.zeros(2),
                                      torch.zeros(2))
