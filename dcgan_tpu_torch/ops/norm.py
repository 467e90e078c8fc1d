"""BatchNorm with explicit running statistics (the counterpart of
`dcgan_tpu/ops/norm.py:37-78,124-205`).

    params = {"scale": gamma, "bias": beta}     # gamma ~ N(1, 0.02), beta = 0
    state  = {"mean": m, "var": v}              # running statistics

    y, new_state = batch_norm_apply(params, state, x, train=True)

train=True normalizes with the batch moments (over every axis but the last)
and returns the EMA-updated state; train=False uses the running statistics
and returns the state unchanged. The new state is returned detached: in JAX
it is an auxiliary output, never differentiated.

Synced BN (`dcgan_tpu/ops/norm.py:81-100, 150-175`): with a process
`group`, the batch moments (plain, or kernel 1's) are averaged over its
ranks before `finish_batch_moments` (parallel/collectives.py's
`synced_moments`, whose backward all-reduces their cotangents), so every
rank normalizes with the global batch's statistics and keeps the same
running statistics.

Two routes, each rounding where the JAX package rounds:
- plain: the moments in f32, the normalization in `x.dtype` (bf16 under
  the default policy), op by op;
- `use_pallas`: the moments from the `channel_moments` kernel, then
  `fused_bn_act` folds them into f32 scale/shift vectors and runs the
  `scale_shift_act` kernel, which computes in f32 and casts back to
  `x.dtype` once.

Conditional BN (`batch_norm_init(..., num_classes=K)`): scale and bias
are [K, C] tables and each example takes its class's rows
(ops/labels.py::class_rows, JAX's clamped gather); the running moments
stay shared. A per-example affine is not the kernel's per-channel
scale/shift, so its epilogue is always the plain one, as in the JAX
package; under `use_pallas` the train moments still come from
`channel_moments`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dcgan_tpu_torch.ops.activations import LEAK, act_fwd, check_act
from dcgan_tpu_torch.ops.labels import class_rows
from dcgan_tpu_torch.parallel.collectives import synced_moments

Pytree = dict


def batch_norm_init(gen: torch.Generator, num_features: int, *,
                    dtype=torch.float32, scale_stddev: float = 0.02,
                    num_classes: int = 0) -> Tuple[Pytree, Pytree]:
    """Returns (params, state): gamma ~ N(1, scale_stddev), beta = 0,
    running mean 0 and var 1. num_classes > 0 makes the affine
    conditional: scale and bias are [num_classes, C] tables."""
    shape = (num_classes, num_features) if num_classes else (num_features,)
    scale = 1.0 + scale_stddev * torch.randn(shape, generator=gen,
                                             dtype=torch.float32)
    params = {"scale": scale.to(dtype),
              "bias": torch.zeros(shape, dtype=dtype)}
    state = {"mean": torch.zeros((num_features,), dtype=dtype),
             "var": torch.ones((num_features,), dtype=dtype)}
    return params, state


def finish_batch_moments(state: Pytree, mean: torch.Tensor,
                         mean_sq: torch.Tensor, *, momentum: float = 0.9
                         ) -> Tuple[torch.Tensor, torch.Tensor, Pytree]:
    """The train-path arithmetic after the raw moments, shared with the
    fused stages (ops/fused.py): the biased variance E[x^2] - E[x]^2
    clamped at 0 (f32 cancellation can go slightly negative), and the EMA
    state update in the stored statistics' dtype. Returns (mean, var,
    new_state) with mean and var f32 and differentiable, new_state
    detached."""
    mean = mean.float()
    # torch.maximum, not clamp_min: like jnp.maximum it splits the gradient
    # at a tie
    var = torch.maximum(mean_sq.float() - torch.square(mean),
                        torch.zeros((), dtype=torch.float32,
                                    device=mean.device))
    with torch.no_grad():
        stat_dtype = state["mean"].dtype
        new_state = {
            "mean": momentum * state["mean"]
                    + (1.0 - momentum) * mean.to(stat_dtype),
            "var": momentum * state["var"]
                   + (1.0 - momentum) * var.to(stat_dtype),
        }
    return mean, var, new_state


def batch_norm_apply(params: Pytree, state: Pytree, x: torch.Tensor, *,
                     train: bool, momentum: float = 0.9, eps: float = 1e-5,
                     act: str = "none", leak: float = LEAK,
                     use_pallas: bool = False,
                     labels: Optional[torch.Tensor] = None, group=None
                     ) -> Tuple[torch.Tensor, Pytree]:
    """Normalize `x` over every axis but the last (channel) axis, then
    apply `act`; returns (y, state) — the EMA-updated state when
    train=True, `state` itself otherwise. Conditional BN (params of
    [K, C] tables) needs `labels` [B]."""
    check_act(act)
    conditional = params["scale"].ndim == 2
    if conditional and labels is None:
        raise ValueError("conditional BN requires labels")
    if train:
        if use_pallas:
            from dcgan_tpu_torch.ops.kernels import channel_moments

            mean, mean_sq = channel_moments(x.reshape(-1, x.shape[-1]))
        else:
            # f32 moments even under bf16 activations, as the JAX package
            # takes them
            axes = tuple(range(x.ndim - 1))
            xf = x.float()
            mean = xf.mean(dim=axes)
            mean_sq = torch.square(xf).mean(dim=axes)
        mean, mean_sq = synced_moments(group, mean, mean_sq)
        mean, var, new_state = finish_batch_moments(state, mean, mean_sq,
                                                    momentum=momentum)
    else:
        mean, var, new_state = state["mean"], state["var"], state
    if use_pallas and not conditional:
        from dcgan_tpu_torch.ops.kernels import fused_bn_act

        return fused_bn_act(x, params["scale"], params["bias"], mean, var,
                            eps=eps, act=act, leak=leak), new_state
    dt = x.dtype
    if conditional:
        # each example's class rows, broadcast over the spatial axes
        bshape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
        scale = class_rows(params["scale"], labels).reshape(bshape).to(dt)
        bias = class_rows(params["bias"], labels).reshape(bshape).to(dt)
    else:
        scale, bias = params["scale"].to(dt), params["bias"].to(dt)
    # eps rounded to x's dtype first, as JAX's weak-typed scalar is;
    # torch.full fills on the device (torch.tensor would copy from the
    # host and wait for the stream)
    inv = torch.rsqrt(var.to(dt) + torch.full((), eps, dtype=dt,
                                              device=x.device))
    y = (x - mean.to(dt)) * inv * scale + bias
    return act_fwd(y, act, leak), new_state
