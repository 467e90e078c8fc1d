"""Activation dispatch shared by the plain BN route and the kernels' plain
versions (the counterpart of `dcgan_tpu/ops/activations.py`).

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
