"""Linear and transposed conv as init/apply pairs on plain tensors (the
counterpart of `dcgan_tpu/ops/layers.py:46-115`).

Layouts are the JAX package's at the boundary: NHWC activations, `[in, out]`
linear weights, HWIO conv kernels. Inside `deconv2d_apply` the activation is
viewed as NCHW with channels-last memory, the layout cuDNN prefers, so the
views in and out cost no copy.

`lax.conv_transpose` (the JAX deconv) does NOT flip the kernel taps and pads
the dilated input asymmetrically, (3, 2) for k=5, s=2. Its PyTorch
equivalent is `conv_transpose2d` over the kernel flipped in h and w and
permuted to (Cin, Cout, kh, kw), with padding (k-1)//2 - 1 (1 for k=5) and
the last row and column cropped; the textbook `padding=2, output_padding=1`
is a different function (off by O(1) on random weights).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

Pytree = dict


def _normal(gen: torch.Generator, shape, stddev: float, dtype) -> torch.Tensor:
    return (stddev * torch.randn(shape, generator=gen,
                                 dtype=torch.float32)).to(dtype)


# ---------------------------------------------------------------------------
# linear
# ---------------------------------------------------------------------------

def linear_init(gen: torch.Generator, in_dim: int, out_dim: int, *,
                stddev: float = 0.02, dtype=torch.float32) -> Pytree:
    """W ~ N(0, stddev) [in, out], b = 0, drawn on the CPU from `gen`."""
    return {"w": _normal(gen, (in_dim, out_dim), stddev, dtype),
            "b": torch.zeros((out_dim,), dtype=dtype)}


def linear_apply(params: Pytree, x: torch.Tensor, *,
                 compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    w, b = params["w"], params["b"]
    if compute_dtype is not None:
        x, w = x.to(compute_dtype), w.to(compute_dtype)
    # the bias is added in the compute dtype, as the JAX package does
    return torch.matmul(x, w) + b.to(x.dtype)


# ---------------------------------------------------------------------------
# deconv2d (transposed conv, SAME, output = input * stride)
# ---------------------------------------------------------------------------

def deconv2d_init(gen: torch.Generator, in_ch: int, out_ch: int, *,
                  kernel: int = 5, stddev: float = 0.02,
                  dtype=torch.float32) -> Pytree:
    """HWIO W ~ N(0, stddev), b = 0."""
    return {"w": _normal(gen, (kernel, kernel, in_ch, out_ch), stddev, dtype),
            "b": torch.zeros((out_ch,), dtype=dtype)}


def deconv2d_apply(params: Pytree, x: torch.Tensor, *, stride: int = 2,
                   compute_dtype: Optional[torch.dtype] = None
                   ) -> torch.Tensor:
    """NHWC [N, H, W, Cin] -> NHWC [N, H*s, W*s, Cout], the JAX
    `lax.conv_transpose(..., padding="SAME")` followed by the bias."""
    w, b = params["w"], params["b"]
    if compute_dtype is not None:
        x, w = x.to(compute_dtype), w.to(compute_dtype)
    k = w.shape[0]
    if k % 2 != 1 or stride != 2:
        # the crop below is derived for odd kernels at stride 2, the only
        # geometry the model uses
        raise NotImplementedError(
            f"deconv2d_apply supports odd kernels at stride 2, got "
            f"kernel={k} stride={stride}")
    w_t = w.flip(0, 1).permute(2, 3, 0, 1)          # [Cin, Cout, kh, kw]
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w_t, stride=stride,
                           padding=(k - 1) // 2 - 1)
    y = y[..., :-1, :-1].permute(0, 2, 3, 1)
    return y + b.to(y.dtype)
