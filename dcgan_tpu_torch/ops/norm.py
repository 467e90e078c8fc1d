"""BatchNorm with explicit running statistics, inference half (the
counterpart of `dcgan_tpu/ops/norm.py:37-55,124-205`).

    params = {"scale": gamma, "bias": beta}     # gamma ~ N(1, 0.02), beta = 0
    state  = {"mean": m, "var": v}              # running statistics

Two routes, each rounding where the JAX package rounds:
- plain: the normalization computes in `x.dtype` (bf16 under the default
  policy), op by op;
- `use_pallas`: `fused_bn_act` folds the statistics into f32 scale/shift
  vectors and runs the `scale_shift_act` kernel, which computes in f32 and
  casts back to `x.dtype` once.
The train half (batch moments, EMA update) comes with the training slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dcgan_tpu_torch.ops.activations import LEAK, act_fwd, check_act

Pytree = dict


def batch_norm_init(gen: torch.Generator, num_features: int, *,
                    dtype=torch.float32, scale_stddev: float = 0.02
                    ) -> Tuple[Pytree, Pytree]:
    """Returns (params, state): gamma ~ N(1, scale_stddev), beta = 0,
    running mean 0 and var 1."""
    scale = 1.0 + scale_stddev * torch.randn((num_features,), generator=gen,
                                             dtype=torch.float32)
    params = {"scale": scale.to(dtype),
              "bias": torch.zeros((num_features,), dtype=dtype)}
    state = {"mean": torch.zeros((num_features,), dtype=dtype),
             "var": torch.ones((num_features,), dtype=dtype)}
    return params, state


def batch_norm_apply(params: Pytree, state: Pytree, x: torch.Tensor, *,
                     train: bool, eps: float = 1e-5, act: str = "none",
                     leak: float = LEAK, use_pallas: bool = False
                     ) -> Tuple[torch.Tensor, Pytree]:
    """Normalize `x` over every axis but the last (channel) axis with the
    running statistics, then apply `act`; returns (y, state) with the state
    unchanged."""
    if train:
        raise NotImplementedError(
            "batch_norm_apply(train=True) comes with the training slice")
    check_act(act)
    mean, var = state["mean"], state["var"]
    if params["scale"].ndim != 1:
        raise NotImplementedError("conditional BN is not ported yet")
    if use_pallas:
        from dcgan_tpu_torch.ops.kernels import fused_bn_act

        return fused_bn_act(x, params["scale"], params["bias"], mean, var,
                            eps=eps, act=act, leak=leak), state
    dt = x.dtype
    scale, bias = params["scale"].to(dt), params["bias"].to(dt)
    inv = torch.rsqrt(var.to(dt) + torch.tensor(eps, dtype=dt,
                                                device=x.device))
    y = (x - mean.to(dt)) * inv * scale + bias
    return act_fwd(y, act, leak), state
