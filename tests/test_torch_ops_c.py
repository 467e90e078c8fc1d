"""Continued from test_torch_ops.py: Ops of the PyTorch port against the JAX
package on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcgan_tpu.ops import activations as j_act
from dcgan_tpu.ops import layers as j_layers
from dcgan_tpu.ops import pallas_fused as j_fused
from dcgan_tpu_torch.ops import activations as t_act
from dcgan_tpu_torch.ops import fused as t_fused
from dcgan_tpu_torch.ops import layers as t_layers
from torch_jax_draws import one_torch_thread  # noqa: F401
from test_torch_ops import _assert_bf16_close, _j2np, _np, _t2np  # noqa: F401


class TestConv2d:
    @pytest.mark.parametrize("kernel", [3, 5])
    @pytest.mark.parametrize("hw", [(8, 8), (7, 10)])
    def test_f32_matches_jax(self, kernel, hw):
        """F.pad by XLA's SAME pads, then an unpadded conv2d ==
        lax.conv_general_dilated(SAME): f32, 1e-5."""
        x = _np(60, (2, *hw, 6))
        w, b = _np(61, (kernel, kernel, 6, 10), 0.1), _np(62, (10,), 0.1)
        got = t_layers.conv2d_apply(
            {"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
            torch.from_numpy(x))
        want = j_layers.conv2d_apply({"w": jnp.asarray(w),
                                      "b": jnp.asarray(b)}, jnp.asarray(x))
        assert got.shape == want.shape
        np.testing.assert_allclose(_t2np(got), _j2np(want), rtol=1e-5,
                                   atol=1e-5)

    def test_bf16_matches_jax(self):
        """bf16 conv output, then the bias added in bf16: two roundings."""
        x, w = _np(63, (2, 8, 8, 8)), _np(64, (5, 5, 8, 4), 0.1)
        b = _np(65, (4,), 0.1)
        got = t_layers.conv2d_apply(
            {"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
            torch.from_numpy(x), compute_dtype=torch.bfloat16)
        want = j_layers.conv2d_apply(
            {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
            compute_dtype=jnp.bfloat16)
        assert got.dtype == torch.bfloat16
        _assert_bf16_close(_t2np(got), _j2np(want), 2)

    def test_symmetric_padding_is_a_different_function(self):
        """The trap: SAME at stride 2 pads (1, 2) on an even input, so
        conv2d(padding=2) is off."""
        import torch.nn.functional as F

        x, w = _np(66, (1, 8, 8, 3)), _np(67, (5, 5, 3, 2))
        want = _j2np(j_layers.conv2d_apply(
            {"w": jnp.asarray(w), "b": jnp.zeros(2)}, jnp.asarray(x)))
        naive = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                         torch.from_numpy(w).permute(3, 2, 0, 1), stride=2,
                         padding=2).permute(0, 2, 3, 1)
        assert naive.shape == want.shape
        assert np.abs(_t2np(naive) - want).max() > 1e-2

    def test_patches_of_d_stage_are_exact(self):
        """conv_patches(transpose=False) at a D stage's geometry (16x16 in,
        5x5 stride 2) equals lax.conv_general_dilated_patches exactly, and
        its GEMM is the conv (f32, 1e-5)."""
        x = _np(68, (2, 16, 16, 8))
        jp, jshape = j_fused.conv_patches(jnp.asarray(x), 5, 2, False)
        tp, tshape = t_fused.conv_patches(torch.from_numpy(x), 5, 2, False)
        assert tuple(tshape) == tuple(jshape) == (2, 8, 8)
        np.testing.assert_array_equal(_t2np(tp), _j2np(jp))
        w = torch.from_numpy(_np(69, (5, 5, 8, 4), 0.1))
        y = (tp @ t_fused.w_to_gemm(w)).reshape(2, 8, 8, 4)
        ref = t_layers.conv2d_apply({"w": w, "b": torch.zeros(4)},
                                    torch.from_numpy(x))
        np.testing.assert_allclose(_t2np(y), _t2np(ref), rtol=1e-5,
                                   atol=1e-5)

    def test_init_is_truncated_at_two_sigma(self):
        import jax

        tp = t_layers.conv2d_init(torch.Generator().manual_seed(0), 16, 32)
        jp = j_layers.conv2d_init(jax.random.key(0), 16, 32)
        assert {k: tuple(v.shape) for k, v in tp.items()} == \
            {k: tuple(v.shape) for k, v in jp.items()}
        w = _t2np(tp["w"])
        assert np.abs(w).max() <= 2 * 0.02 + 1e-7
        assert 0.01 < w.std() < 0.02   # 2-sigma truncation: 0.88 sigma
        np.testing.assert_array_equal(_t2np(tp["b"]), np.zeros(32))

    def test_lrelu_matches_jax(self):
        u = _np(70, (64,))
        np.testing.assert_allclose(
            _t2np(t_layers.lrelu(torch.from_numpy(u), 0.2)),
            _j2np(j_layers.lrelu(jnp.asarray(u), 0.2)), rtol=1e-6,
            atol=1e-6)


class TestActGrad:
    @pytest.mark.parametrize("act", ["none", "relu", "lrelu", "tanh"])
    def test_matches_jax(self, act):
        u = _np(71, (64,))
        u[:3] = 0.0   # the tie: relu 0, lrelu leak
        np.testing.assert_allclose(
            _t2np(t_act.act_grad(torch.from_numpy(u), act, 0.2)),
            _j2np(j_act.act_grad(jnp.asarray(u), act, 0.2)), rtol=1e-6,
            atol=1e-6)
