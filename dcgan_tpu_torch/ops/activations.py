"""Activation dispatch shared by the plain BN route and the kernels' plain
versions, forward and derivative (the counterpart of
`dcgan_tpu/ops/activations.py`).

The CUDA kernels encode the same table as an integer (`ACT_CODES`): the
order of `ACTS` is the contract between this module and `csrc/*.cu`.
"""

from __future__ import annotations

import torch

ACTS = ("none", "relu", "lrelu", "tanh")
ACT_CODES = {name: i for i, name in enumerate(ACTS)}
LEAK = 0.2  # lrelu slope


def check_act(act: str) -> None:
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r}")


def act_fwd(u: torch.Tensor, act: str, leak: float = LEAK) -> torch.Tensor:
    """act(u) in u's dtype. relu and lrelu are written as maxima, as the
    JAX package writes them, so a NaN propagates instead of clamping."""
    if act == "relu":
        return torch.maximum(u, torch.zeros((), dtype=u.dtype,
                                            device=u.device))
    if act == "lrelu":
        return torch.maximum(u, leak * u)
    if act == "tanh":
        return torch.tanh(u)
    return u


def act_grad(u: torch.Tensor, act: str, leak: float = LEAK) -> torch.Tensor:
    """act'(u) in u's dtype, the JAX package's `act_grad`: relu and lrelu
    take the u > 0 branch's slope only for u > 0 (so 0 and leak at u = 0),
    the kernels' backward uses the same table (csrc/common.cuh)."""
    if act == "relu":
        return (u > 0).to(u.dtype)
    if act == "lrelu":
        return torch.where(u > 0, torch.ones((), dtype=u.dtype,
                                             device=u.device),
                           torch.full((), leak, dtype=u.dtype,
                                      device=u.device))
    if act == "tanh":
        t = torch.tanh(u)
        return 1.0 - t * t
    return torch.ones_like(u)
