"""Linear, conv, transposed conv and leaky relu as init/apply pairs on
plain tensors (the counterpart of `dcgan_tpu/ops/layers.py:46-123`).

Layouts are the JAX package's at the boundary: NHWC activations, `[in, out]`
linear weights, HWIO conv kernels. Inside `deconv2d_apply` the activation is
viewed as NCHW with channels-last memory, the layout cuDNN prefers, so the
views in and out cost no copy.

`lax.conv_general_dilated` with SAME padding at stride 2 pads an even input
asymmetrically, (1, 2) for k=5, so `conv2d_apply` pads explicitly and then
convolves unpadded; the symmetric `padding=2` is a different function.

`lax.conv_transpose` (the JAX deconv) does NOT flip the kernel taps and pads
the dilated input asymmetrically, (3, 2) for k=5, s=2. Its PyTorch
equivalent is `conv_transpose2d` over the kernel flipped in h and w and
permuted to (Cin, Cout, kh, kw), with padding (k-1)//2 - 1 (1 for k=5) and
the last row and column cropped; the textbook `padding=2, output_padding=1`
is a different function (off by O(1) on random weights).

Under a spatial mesh (`spatial=`, parallel/spatial.py) x is the rank's
block of rows: the conv and the deconv take the rows their kernel reaches
above and below it from the neighbours (`spatial.halo`, zeros past the
image's edge, where the unsharded op pads) and convolve with no padding
in H, so each rank computes its rows of the unsharded output.

Under the fp8 precision policy a quantized stage (`quant="fp8"`, chosen by
models/dcgan.py::_stage_quant) passes both GEMM operands through
`fake_quant_fp8` first: fp8 numerics on any device, the products still in
the compute dtype, as the JAX package simulates them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

Pytree = dict


# the largest finite float8_e4m3fn value
FP8_E4M3_MAX = 448.0


def fake_quant_fp8_ops(x: torch.Tensor) -> torch.Tensor:
    """`fake_quant_fp8` as composed torch ops, differentiated by autograd
    op by op (which keeps f32 copies of x for the backward)."""
    xf = x.float()
    # amax times the f32 reciprocal of 448: the JAX function's `/ 448.0`
    # as XLA compiles it (a division by a constant becomes this product),
    # so a scale one ulp apart cannot move the fp8 roundings
    scale = torch.maximum(xf.abs().max() * (1.0 / FP8_E4M3_MAX),
                          torch.full((), 1e-12, device=x.device))
    q = (xf / scale).to(torch.float8_e4m3fn).float()
    return (q * scale).to(x.dtype)


# elements of the operand each pass of _FakeQuantFp8 takes at once
FP8_CHUNK = 1 << 24


def _fp8_chunks(n: int):
    return (slice(i, min(n, i + FP8_CHUNK)) for i in range(0, n, FP8_CHUNK))


def _memory_order(t: torch.Tensor) -> Optional[torch.Tensor]:
    """t's elements in memory order as a 1-D view (the order an
    elementwise op and a full reduction walk a dense tensor in), or None
    when t is not dense."""
    perm = sorted(range(t.dim()), key=lambda d: -t.stride(d))
    flat = t.permute(perm)
    return flat.view(-1) if flat.is_contiguous() else None


class _FakeQuantFp8(torch.autograd.Function):
    """fake_quant_fp8_ops with the same forward and cotangent bits, holding
    no f32 copy of x: it saves x (in its own dtype), amax and the scale,
    and walks x in FP8_CHUNK pieces. Each elementwise step is autograd's
    own formula for the composed op, so a piece gives the bits the whole
    tensor gives. The scale's gradient is two sums over the whole tensor
    (of g * q and of -g_u * (x / s) / s, autograd's products for the
    multiply and the divide), each reduced over one f32 buffer in x's
    memory order as autograd reduces it; it reaches the amax elements as
    torch's max backward spreads it (evenly over the ties). x may be any
    dense layout (the plain route quantizes a permuted view of the map);
    a cotangent in another layout than x's, or a double backward (a
    penalty through a quantized stage), recomputes the composed ops and
    differentiates them instead."""

    @staticmethod
    def forward(ctx, x):
        flat = _memory_order(x)
        if flat is None:
            ctx.save_for_backward(x, None, None)
            return fake_quant_fp8_ops(x)
        # max is exact in any order: the chunks' maxima give xf.abs().max()
        amax = torch.stack([flat[sl].float().abs().max()
                            for sl in _fp8_chunks(flat.numel())]).max()
        scale = torch.maximum(amax * (1.0 / FP8_E4M3_MAX),
                              torch.full((), 1e-12, device=x.device))
        # empty_like keeps a dense tensor's strides: the same memory order
        y = torch.empty_like(x)
        out = _memory_order(y)
        for sl in _fp8_chunks(flat.numel()):
            q = (flat[sl].float() / scale).to(torch.float8_e4m3fn).float()
            out[sl] = (q * scale).to(x.dtype)
        ctx.save_for_backward(x, amax, scale)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, amax, scale = ctx.saved_tensors
        if torch.is_grad_enabled() or amax is None \
                or gy.stride() != x.stride():
            twice = torch.is_grad_enabled()
            with torch.enable_grad():
                xr = x if twice else x.detach().requires_grad_(True)
                y = fake_quant_fp8_ops(xr)
            return torch.autograd.grad(y, xr, gy, create_graph=twice)[0]
        e4m3 = torch.float8_e4m3fn
        flat, gflat = _memory_order(x), _memory_order(gy)
        n = flat.numel()

        def tied(xc):
            # torch's max backward: the elements whose |x| equals the max
            # (x in its own dtype: amax is one of its values, so the
            # comparison is exact; a NaN amax makes every cotangent NaN)
            return (xc == amax) | (xc == -amax)

        # d/dscale of q * scale: sum(g * q); of xf / scale: sum(-g_u *
        # ((xf / scale) / scale)), g_u the cotangent through the casts,
        # kept in e4m3 (its exact value) for the last pass
        prod = torch.empty(n, dtype=torch.float32, device=x.device)
        g_u8 = torch.empty(n, dtype=e4m3, device=x.device)
        count = torch.zeros((), dtype=torch.int64, device=x.device)
        for sl in _fp8_chunks(n):
            count += tied(flat[sl]).sum()
            torch.mul(gflat[sl].float(),
                      (flat[sl].float() / scale).to(e4m3).float(),
                      out=prod[sl])
        g_scale = prod.sum()
        for sl in _fp8_chunks(n):
            g_u8[sl] = (gflat[sl].float() * scale).to(e4m3)
            torch.mul(-g_u8[sl].float(), (flat[sl].float() / scale) / scale,
                      out=prod[sl])
        g_scale = g_scale + prod.sum()
        del prod
        # through max(amax / 448, 1e-12) and the product with 1 / 448 to
        # amax, spread evenly over its ties
        m = amax * (1.0 / FP8_E4M3_MAX)
        eps = torch.full((), 1e-12, device=x.device)
        g_m = torch.where(m == eps, g_scale / 2, g_scale).masked_fill_(
            m < eps, 0)
        share = g_m * (1.0 / FP8_E4M3_MAX) / count
        gx = torch.empty_like(x)
        out = _memory_order(gx)
        for sl in _fp8_chunks(n):
            mask = tied(flat[sl])
            # max's backward on CUDA multiplies the mask by the share
            # (zeros keep the share's sign); on the CPU it scatters the
            # share into zeros
            g_abs = mask * share if x.is_cuda else torch.where(
                mask, share, torch.zeros((), device=x.device))
            out[sl] = (g_u8[sl].float() / scale
                       + g_abs * flat[sl].sgn()).to(x.dtype)
        return gx


def fake_quant_fp8(x: torch.Tensor) -> torch.Tensor:
    """x through float8_e4m3fn with per-tensor amax scaling, back in x's
    dtype (`dcgan_tpu/ops/layers.py:23-32`, as compiled): scale =
    max(amax / 448, 1e-12), q = fp8(x / scale) rounded to nearest even,
    q * scale. The
    scaling keeps x / scale within e4m3's range, where an unscaled cast
    would overflow. Differentiable as the JAX function is: the casts pass
    the gradient through (rounding it through e4m3), and the scale's own
    gradient reaches the amax element. An autograd Function that holds no
    f32 copy of x (`_FakeQuantFp8`); its bits are `fake_quant_fp8_ops`'."""
    if not (x.requires_grad and torch.is_grad_enabled()):
        return fake_quant_fp8_ops(x)
    return _FakeQuantFp8.apply(x)


def _normal(gen: torch.Generator, shape, stddev: float, dtype) -> torch.Tensor:
    return (stddev * torch.randn(shape, generator=gen,
                                 dtype=torch.float32)).to(dtype)


def _truncated_normal(gen: torch.Generator, shape, stddev: float,
                      dtype) -> torch.Tensor:
    """stddev * N(0, 1) truncated to [-2, 2], TF's and jax's
    truncated_normal for the conv kernels."""
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (stddev * t).to(dtype)


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's SAME padding (before, after) of one spatial dim: the output is
    ceil(size / s) and the odd pixel of padding goes after."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


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
# conv2d (strided, SAME)
# ---------------------------------------------------------------------------

def conv2d_init(gen: torch.Generator, in_ch: int, out_ch: int, *,
                kernel: int = 5, stddev: float = 0.02,
                dtype=torch.float32) -> Pytree:
    """HWIO W ~ TruncNormal(0, stddev) at 2 sigma, b = 0."""
    return {"w": _truncated_normal(gen, (kernel, kernel, in_ch, out_ch),
                                   stddev, dtype),
            "b": torch.zeros((out_ch,), dtype=dtype)}


def conv2d_apply(params: Pytree, x: torch.Tensor, *, stride: int = 2,
                 compute_dtype: Optional[torch.dtype] = None,
                 quant: str = "", spatial=None) -> torch.Tensor:
    """NHWC [N, H, W, Cin] -> NHWC [N, ceil(H/s), ceil(W/s), Cout], the JAX
    `lax.conv_general_dilated(..., padding="SAME")` followed by the bias;
    quant="fp8" quantizes both operands first; under `spatial` x and the
    output are the rank's rows."""
    w, b = params["w"], params["b"]
    if compute_dtype is not None:
        x, w = x.to(compute_dtype), w.to(compute_dtype)
    if quant == "fp8":
        x, w = fake_quant_fp8(x), fake_quant_fp8(w)
    y = conv2d(x, w, stride=stride, spatial=spatial)
    return y + b.to(y.dtype)


def conv2d(x: torch.Tensor, w: torch.Tensor, *,
           stride: int = 2, spatial=None) -> torch.Tensor:
    """The convolution of `conv2d_apply` without its bias: NHWC x HWIO ->
    NHWC, `lax.conv_general_dilated(..., padding="SAME")` in the operands'
    dtype (the modulated convs of models/stylegan.py add their bias after
    the demodulation). Under `spatial` the H padding is the halo of the
    rank's rows (rows a multiple of the stride, so the blocks' outputs
    tile the unsharded output)."""
    k = w.shape[0]
    if spatial is None:
        top, bottom = same_pads(x.shape[1], k, stride)
    else:
        if x.shape[1] % stride:
            raise ValueError(f"a {x.shape[1]}-row block does not tile a "
                             f"stride-{stride} conv's output")
        x = spatial.halo(x, *same_pads(x.shape[1] * spatial.n, k, stride))
        top = bottom = 0
    left, right = same_pads(x.shape[2], k, stride)
    xp = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom))
    y = F.conv2d(xp, w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# deconv2d (transposed conv, SAME, output = input * stride)
# ---------------------------------------------------------------------------

def deconv2d_init(gen: torch.Generator, in_ch: int, out_ch: int, *,
                  kernel: int = 5, stddev: float = 0.02,
                  dtype=torch.float32) -> Pytree:
    """HWIO W ~ N(0, stddev), b = 0."""
    return {"w": _normal(gen, (kernel, kernel, in_ch, out_ch), stddev, dtype),
            "b": torch.zeros((out_ch,), dtype=dtype)}


def deconv_halo(k: int) -> Tuple[int, int]:
    """(rows above, rows below) of a rank's block that a stride-2 SAME
    transposed conv of odd kernel k reaches: the dilated input is padded
    (k + 1) / 2 before, and output row o reads dilated rows o - (k + 1) / 2
    .. o + (k - 3) / 2 (at least one row below, so that the block's
    dilated rows span its 2h outputs)."""
    before = (k + 1) // 2
    return before // 2, max(1, (k - 2 - before) // 2 + 1)


def deconv2d_apply(params: Pytree, x: torch.Tensor, *, stride: int = 2,
                   compute_dtype: Optional[torch.dtype] = None,
                   quant: str = "", spatial=None) -> torch.Tensor:
    """NHWC [N, H, W, Cin] -> NHWC [N, H*s, W*s, Cout], the JAX
    `lax.conv_transpose(..., padding="SAME")` followed by the bias;
    quant="fp8" quantizes both operands first; under `spatial` x and the
    output are the rank's rows (`deconv_halo`'s rows around x, the
    dilated block padded by the rest of the SAME padding before and
    cropped to 2h rows)."""
    w, b = params["w"], params["b"]
    if compute_dtype is not None:
        x, w = x.to(compute_dtype), w.to(compute_dtype)
    if quant == "fp8":
        x, w = fake_quant_fp8(x), fake_quant_fp8(w)
    k = w.shape[0]
    if k % 2 != 1 or stride != 2:
        # the crop below is derived for odd kernels at stride 2, the only
        # geometry the model uses
        raise NotImplementedError(
            f"deconv2d_apply supports odd kernels at stride 2, got "
            f"kernel={k} stride={stride}")
    w_t = w.flip(0, 1).permute(2, 3, 0, 1)          # [Cin, Cout, kh, kw]
    pad = (k - 1) // 2 - 1
    if spatial is None:
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w_t, stride=stride,
                               padding=pad)
        y = y[..., :-1, :-1]
    else:
        h = x.shape[1]
        top, bottom = deconv_halo(k)
        x = spatial.halo(x, top, bottom)
        # the dilated block starts 2 * top rows above the rank's first
        # row; the unsharded op pads (k + 1) / 2 dilated rows before row 0
        pad_h = k - 1 - ((k + 1) // 2 - 2 * top)
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w_t, stride=stride,
                               padding=(pad_h, pad))
        y = y[..., :2 * h, :-1]
    y = y.permute(0, 2, 3, 1)
    return y + b.to(y.dtype)


# ---------------------------------------------------------------------------
# lrelu
# ---------------------------------------------------------------------------

def lrelu(x: torch.Tensor, leak: float = 0.2) -> torch.Tensor:
    """max(x, leak * x), a maximum as in JAX (ties split the gradient)."""
    return torch.maximum(x, leak * x)
