"""Ops of the PyTorch port against the JAX package on the CPU.

The same numpy inputs (seeded) go through `dcgan_tpu.ops.*` and
`dcgan_tpu_torch.ops.*`. Tolerances are stated per test:
- data movement (im2col patches, the GEMM weight reshape) must be exact;
- float32 arithmetic agrees to 1e-5 (summation order only);
- bfloat16 results agree to a few bf16 ulps of the output's magnitude:
  the two frameworks round at different points (PyTorch after every op,
  XLA may keep f32 across a fused elementwise chain).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcgan_tpu.ops import activations as j_act
from dcgan_tpu.ops import layers as j_layers
from dcgan_tpu.ops import norm as j_norm
from dcgan_tpu.ops import pallas_fused as j_fused
from dcgan_tpu_torch.ops import activations as t_act
from dcgan_tpu_torch.ops import fused as t_fused
from dcgan_tpu_torch.ops import layers as t_layers
from dcgan_tpu_torch.ops import norm as t_norm

BF16_ULP = 2.0 ** -7   # bf16 keeps 8 significant bits

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def _j2np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t2np(x):
    return x.detach().float().cpu().numpy()


def _assert_bf16_close(got, want, ulps):
    """max |got - want| within `ulps` bf16 ulps of the output's scale."""
    err = np.abs(got - want).max()
    assert err <= ulps * BF16_ULP * np.abs(want).max(), err


class TestActivations:
    @pytest.mark.parametrize("act", ["none", "relu", "lrelu", "tanh"])
    def test_matches_jax(self, act):
        u = _np(0, (64,))
        got = _t2np(t_act.act_fwd(torch.from_numpy(u), act, 0.2))
        want = _j2np(j_act.act_fwd(jnp.asarray(u), act, 0.2))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    def test_table_order_is_the_kernels_contract(self):
        assert t_act.ACTS == j_act.ACTS
        assert [t_act.ACT_CODES[a] for a in t_act.ACTS] == [0, 1, 2, 3]

    def test_nan_propagates_through_relu(self):
        u = torch.tensor([float("nan"), -1.0, 2.0])
        out = t_act.act_fwd(u, "relu")
        assert torch.isnan(out[0]) and out[1] == 0 and out[2] == 2

    def test_unknown_act_raises(self):
        with pytest.raises(ValueError, match="unknown act"):
            t_act.check_act("gelu")


class TestConvPatches:
    """im2col rows: pure data movement, so exact in both dtypes."""

    @pytest.mark.parametrize("transpose", [True, False])
    @pytest.mark.parametrize("kernel", [3, 5])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_exact(self, transpose, kernel, dtype):
        jdt, tdt = _DT[dtype]
        x = _np(1, (2, 4, 6, 3))
        jp, jshape = j_fused.conv_patches(jnp.asarray(x, jdt), kernel, 2,
                                          transpose)
        tp, tshape = t_fused.conv_patches(torch.from_numpy(x).to(tdt),
                                          kernel, 2, transpose)
        assert tuple(tshape) == tuple(jshape)
        assert tp.dtype == tdt and tp.is_contiguous()
        np.testing.assert_array_equal(_t2np(tp), _j2np(jp))

    def test_transpose_pads(self):
        for k in (3, 4, 5, 7):
            for s in (1, 2, 3):
                assert t_fused._transpose_pads(k, s) == \
                    j_fused._transpose_pads(k, s)


class TestWToGemm:
    def test_exact(self):
        w = _np(2, (5, 5, 6, 4))
        got = t_fused.w_to_gemm(torch.from_numpy(w))
        want = j_fused.w_to_gemm(jnp.asarray(w))
        np.testing.assert_array_equal(_t2np(got), _j2np(want))

    def test_gemm_of_patches_is_the_deconv(self):
        """The fused formulation (patches @ reshaped kernel) is the deconv
        itself: f32, 1e-5."""
        x = torch.from_numpy(_np(3, (2, 4, 4, 6)))
        params = {"w": torch.from_numpy(_np(4, (5, 5, 6, 10), 0.1)),
                  "b": torch.zeros(10)}
        p2d, (n, ho, wo) = t_fused.conv_patches(x, 5, 2, transpose=True)
        y = (p2d @ t_fused.w_to_gemm(params["w"])).reshape(n, ho, wo, 10)
        ref = t_layers.deconv2d_apply(params, x)
        np.testing.assert_allclose(_t2np(y), _t2np(ref), rtol=1e-5,
                                   atol=1e-5)


class TestLinear:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_jax(self, dtype):
        jdt, tdt = _DT[dtype]
        x, w, b = _np(5, (4, 20)), _np(6, (20, 12), 0.1), _np(7, (12,), 0.1)
        got = t_layers.linear_apply(
            {"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
            torch.from_numpy(x), compute_dtype=tdt)
        want = j_layers.linear_apply({"w": jnp.asarray(w),
                                      "b": jnp.asarray(b)},
                                     jnp.asarray(x), compute_dtype=jdt)
        assert got.dtype == tdt
        if dtype == "float32":
            np.testing.assert_allclose(_t2np(got), _j2np(want), rtol=1e-5,
                                       atol=1e-5)
        else:   # bias added in bf16 after a bf16 product: two roundings
            _assert_bf16_close(_t2np(got), _j2np(want), 2)

    def test_init_shapes_match_jax(self):
        import jax

        jp = j_layers.linear_init(jax.random.key(0), 20, 12)
        tp = t_layers.linear_init(torch.Generator().manual_seed(0), 20, 12)
        assert {k: tuple(v.shape) for k, v in tp.items()} == \
            {k: tuple(v.shape) for k, v in jp.items()}


class TestDeconv:
    @pytest.mark.parametrize("kernel", [3, 5])
    def test_f32_matches_jax(self, kernel):
        """conv_transpose2d over the flipped kernel, padding (k-1)//2 - 1,
        last row/col cropped == lax.conv_transpose SAME: f32, 1e-5."""
        x = _np(8, (2, 4, 4, 6))
        w = _np(9, (kernel, kernel, 6, 10), 0.1)
        b = _np(10, (10,), 0.1)
        got = t_layers.deconv2d_apply(
            {"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
            torch.from_numpy(x))
        want = j_layers.deconv2d_apply({"w": jnp.asarray(w),
                                        "b": jnp.asarray(b)},
                                       jnp.asarray(x))
        assert got.shape == want.shape == (2, 8, 8, 10)
        np.testing.assert_allclose(_t2np(got), _j2np(want), rtol=1e-5,
                                   atol=1e-5)

    def test_bf16_matches_jax(self):
        """bf16 conv output, then the bias added in bf16: two roundings."""
        x, w = _np(11, (2, 4, 4, 8)), _np(12, (5, 5, 8, 4), 0.1)
        b = _np(13, (4,), 0.1)
        got = t_layers.deconv2d_apply(
            {"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
            torch.from_numpy(x), compute_dtype=torch.bfloat16)
        want = j_layers.deconv2d_apply({"w": jnp.asarray(w),
                                        "b": jnp.asarray(b)},
                                       jnp.asarray(x),
                                       compute_dtype=jnp.bfloat16)
        assert got.dtype == torch.bfloat16
        _assert_bf16_close(_t2np(got), _j2np(want), 2)

    def test_textbook_padding_is_a_different_function(self):
        """The trap the formulation avoids: padding=2, output_padding=1 on
        the unflipped kernel does not give lax.conv_transpose's result."""
        import torch.nn.functional as F

        x, w = _np(14, (1, 4, 4, 3)), _np(15, (5, 5, 3, 2))
        want = _j2np(j_layers.deconv2d_apply(
            {"w": jnp.asarray(w), "b": jnp.zeros(2)}, jnp.asarray(x)))
        naive = F.conv_transpose2d(
            torch.from_numpy(x).permute(0, 3, 1, 2),
            torch.from_numpy(w).permute(2, 3, 0, 1), stride=2, padding=2,
            output_padding=1).permute(0, 2, 3, 1)
        assert np.abs(_t2np(naive) - want).max() > 1e-2


def _bn_inputs(c, seed):
    params = {"scale": 1.0 + _np(seed, (c,), 0.1),
              "bias": _np(seed + 1, (c,), 0.2)}
    state = {"mean": _np(seed + 2, (c,), 0.3),
             "var": np.abs(_np(seed + 3, (c,))) + 0.5}
    return params, state


class TestBatchNormInference:
    @pytest.mark.parametrize("use_pallas", [False, True])
    @pytest.mark.parametrize("act", ["relu", "lrelu", "none"])
    def test_f32_matches_jax(self, use_pallas, act):
        """Both routes, f32: 1e-5."""
        params, state = _bn_inputs(12, 20)
        x = _np(21, (2, 4, 4, 12))
        got, got_state = t_norm.batch_norm_apply(
            {k: torch.from_numpy(v) for k, v in params.items()},
            {k: torch.from_numpy(v) for k, v in state.items()},
            torch.from_numpy(x), train=False, act=act, use_pallas=use_pallas)
        want, _ = j_norm.batch_norm_apply(
            {k: jnp.asarray(v) for k, v in params.items()},
            {k: jnp.asarray(v) for k, v in state.items()},
            jnp.asarray(x), train=False, act=act, use_pallas=use_pallas)
        np.testing.assert_allclose(_t2np(got), _j2np(want), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(_t2np(got_state["mean"]),
                                      state["mean"])

    def test_bf16_kernel_route_rounds_once(self):
        """use_pallas route: f32 math, one cast to bf16 in both packages:
        within one bf16 ulp of the output."""
        params, state = _bn_inputs(16, 30)
        x = _np(31, (4, 4, 4, 16))
        got, _ = t_norm.batch_norm_apply(
            {k: torch.from_numpy(v) for k, v in params.items()},
            {k: torch.from_numpy(v) for k, v in state.items()},
            torch.from_numpy(x).to(torch.bfloat16), train=False, act="relu",
            use_pallas=True)
        want, _ = j_norm.batch_norm_apply(
            {k: jnp.asarray(v) for k, v in params.items()},
            {k: jnp.asarray(v) for k, v in state.items()},
            jnp.asarray(x, jnp.bfloat16), train=False, act="relu",
            use_pallas=True)
        assert got.dtype == torch.bfloat16
        g, w = _t2np(got), _j2np(want)
        assert (np.abs(g - w) <= BF16_ULP * np.abs(w) + 1e-6).all()

    def test_bf16_plain_route_computes_in_bf16(self):
        """Plain route: the normalization runs in bf16 (x's dtype), as the
        JAX package's does; op-by-op rounding vs XLA's fused chain stays
        within 4 bf16 ulps of the output's scale."""
        params, state = _bn_inputs(16, 40)
        x = _np(41, (4, 4, 4, 16))
        got, _ = t_norm.batch_norm_apply(
            {k: torch.from_numpy(v) for k, v in params.items()},
            {k: torch.from_numpy(v) for k, v in state.items()},
            torch.from_numpy(x).to(torch.bfloat16), train=False, act="relu")
        want, _ = j_norm.batch_norm_apply(
            {k: jnp.asarray(v) for k, v in params.items()},
            {k: jnp.asarray(v) for k, v in state.items()},
            jnp.asarray(x, jnp.bfloat16), train=False, act="relu")
        assert got.dtype == torch.bfloat16
        _assert_bf16_close(_t2np(got), _j2np(want), 4)

    def test_init_matches_jax_layout(self):
        import jax

        jp, js = j_norm.batch_norm_init(jax.random.key(0), 7)
        tp, ts = t_norm.batch_norm_init(torch.Generator().manual_seed(0), 7)
        assert sorted(tp) == sorted(jp) and sorted(ts) == sorted(js)
        np.testing.assert_array_equal(_t2np(ts["mean"]), np.zeros(7))
        np.testing.assert_array_equal(_t2np(ts["var"]), np.ones(7))

    def test_train_mode_not_ported_yet(self):
        params, state = _bn_inputs(4, 50)
        with pytest.raises(NotImplementedError):
            t_norm.batch_norm_apply(
                {k: torch.from_numpy(v) for k, v in params.items()},
                {k: torch.from_numpy(v) for k, v in state.items()},
                torch.zeros(2, 4), train=True)
