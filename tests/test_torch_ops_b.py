"""Continued from test_torch_ops.py: Ops of the PyTorch port against the JAX
package on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcgan_tpu.ops import norm as j_norm
from dcgan_tpu_torch.ops import norm as t_norm
from torch_jax_draws import one_torch_thread  # noqa: F401
from test_torch_ops import (  # noqa: F401
    BF16_ULP, _assert_bf16_close, _bn_inputs, _check_bn_train, _j2np, _np,
    _t2np)


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
        """batch_norm_apply(train=True) on the plain route, f32, against
        JAX: output, new state and gradients (the name dates from before
        the train half was ported; TestBatchNormTrain covers the rest)."""
        _check_bn_train(use_pallas=False, act="relu", dtype="float32")


class TestBatchNormTrain:
    @pytest.mark.parametrize("use_pallas", [False, True])
    @pytest.mark.parametrize("act", ["relu", "lrelu"])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_jax(self, use_pallas, act, dtype):
        _check_bn_train(use_pallas=use_pallas, act=act, dtype=dtype)

    def test_finish_batch_moments_matches_jax(self):
        """The variance clamp and the EMA, f32 1e-6: a channel whose
        E[x^2] - E[x]^2 cancels below 0 gets variance 0."""
        state = {"mean": _np(53, (5,)), "var": np.abs(_np(54, (5,)))}
        mean = _np(55, (5,))
        mean_sq = mean * mean + np.abs(_np(56, (5,)))
        mean_sq[2] = mean[2] * mean[2] - 1e-3
        got = t_norm.finish_batch_moments(
            {k: torch.from_numpy(v) for k, v in state.items()},
            torch.from_numpy(mean), torch.from_numpy(mean_sq), momentum=0.9)
        want = j_norm.finish_batch_moments(
            {k: jnp.asarray(v) for k, v in state.items()},
            jnp.asarray(mean), jnp.asarray(mean_sq), momentum=0.9)
        assert float(got[1][2]) == 0.0
        for a, b in ((got[0], want[0]), (got[1], want[1]),
                     (got[2]["mean"], want[2]["mean"]),
                     (got[2]["var"], want[2]["var"])):
            np.testing.assert_allclose(_t2np(a), _j2np(b), rtol=1e-6,
                                       atol=1e-6)

    def test_routes_agree_in_f32(self):
        """The kernel route (channel_moments + scale_shift_act) and the
        plain route are the same function: f32, 1e-5 apart."""
        params, state = _bn_inputs(8, 57)
        x = torch.from_numpy(_np(58, (3, 4, 4, 8)))
        outs = [t_norm.batch_norm_apply(
            {k: torch.from_numpy(v) for k, v in params.items()},
            {k: torch.from_numpy(v) for k, v in state.items()}, x,
            train=True, act="relu", use_pallas=up) for up in (False, True)]
        torch.testing.assert_close(outs[1][0], outs[0][0], rtol=1e-5,
                                   atol=1e-5)
        for key in ("mean", "var"):
            torch.testing.assert_close(outs[1][1][key], outs[0][1][key],
                                       rtol=1e-6, atol=1e-6)
