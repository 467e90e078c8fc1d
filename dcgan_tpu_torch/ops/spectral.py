"""Spectral normalization (Miyato et al. 2018) with the power-iteration
vector as explicit state (the counterpart of `dcgan_tpu/ops/spectral.py`).

Every normalized weight carries one unit vector `u` of its output size,
kept as an `sn_*` leaf of the net's state beside BatchNorm's moments. The
weight reshapes to `[N, out]` with its last axis kept (HWIO kernels and
`[in, out]` linear weights both end in the output axis), the power
iteration runs on the detached weight, and sigma = v . (W u) is taken
through the live weight, so the gradient of W / sigma keeps its
-W (dsigma/dW) / sigma^2 term.

`torch.nn.utils.spectral_norm` is a different function here: it reshapes
to `[out, in]`, keeps hidden buffers and changes behaviour in eval mode.
`_l2n` divides by (norm + eps) as the JAX package does, where
`F.normalize` would clamp the norm instead.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _l2n(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x) + eps)


def spectral_u_init(gen: torch.Generator, out_dim: int, *,
                    dtype=torch.float32) -> torch.Tensor:
    """Unit-norm power-iteration start vector, drawn on the CPU from
    `gen`."""
    return _l2n(torch.randn((out_dim,), generator=gen,
                            dtype=torch.float32), 1e-12).to(dtype)


def spectral_normalize(w: torch.Tensor, u: torch.Tensor, *, train: bool,
                       n_iter: int = 1, eps: float = 1e-12
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w / sigma_max estimate, u for the state).

    Both modes run `n_iter` power-iteration steps from the stored u to
    estimate sigma; train=True returns the advanced u, train=False the
    stored one (repeated eval applies are idempotent). The returned u is
    detached."""
    out_dim = w.shape[-1]
    w2d = w.float().reshape(-1, out_dim)                # [N, out]
    w_sg = w2d.detach()
    u_new = u.detach().float()
    for _ in range(n_iter):
        v_i = _l2n(w_sg @ u_new, eps)                   # [N]
        u_new = _l2n(w_sg.T @ v_i, eps)                 # [out]
    v = _l2n(w_sg @ u_new, eps)
    # sigma through the live weight: the normalization's own gradient term
    sigma = v @ (w2d @ u_new)
    w_sn = (w2d / sigma).reshape(w.shape).to(w.dtype)
    u_out = u_new if train else u.detach().float()
    return w_sn, u_out.to(u.dtype)
