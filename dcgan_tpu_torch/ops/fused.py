"""Fused conv/deconv stage: im2col + one GEMM-epilogue kernel (the
counterpart of `dcgan_tpu/ops/pallas_fused.py`).

Formulation, as in the JAX package: patch extraction stays plain tensor
code (`conv_patches`, PyTorch's `unfold` over the zero-dilated, padded input
for a transposed conv), producing [M, Cin*k*k] rows whose GEMM against the
[Cin*k*k, Cout] reshaped kernel (`w_to_gemm`) IS the conv. Patch features are
channel-major (Cin slowest, then kh, kw), the order of
`lax.conv_general_dilated_patches`.

`gemm_bias_scale_act` then runs the whole inference stage,
act((P @ W + b) * scale + shift), in one pass: on a CUDA tensor the
`csrc/gemm_bias_scale_act.cu` kernel (which replaces the TPU kernel
`_gemm_bias_scale_act_kernel`), on a CPU tensor `gemm_bias_scale_act_plain`.

Only the inference half of `fused_conv_bn_act` is here; its train half
(`gemm_bias_moments` + the BN epilogue) comes with the training slice.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from dcgan_tpu_torch.ops.activations import ACT_CODES, LEAK, act_fwd, \
    check_act
from dcgan_tpu_torch.ops.kernels import DTYPE_CODES, c_function, \
    channel_vector, check_launch, check_matrix

Pytree = dict

_INT_MAX = 2 ** 31 - 1


def w_to_gemm(w: torch.Tensor) -> torch.Tensor:
    """[kh, kw, Cin, Cout] HWIO kernel -> [Cin*kh*kw, Cout] GEMM operand,
    rows in the patches' channel-major order."""
    kh, kw, cin, cout = w.shape
    return w.permute(2, 0, 1, 3).reshape(kh * kw * cin, cout)


def _transpose_pads(k: int, s: int) -> Tuple[int, int]:
    # lax.conv_transpose's SAME padding arithmetic: (3, 2) for k=5, s=2
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else int(math.ceil(pad_len / 2))
    return pad_a, pad_len - pad_a


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv_patches(x: torch.Tensor, kernel: int, stride: int,
                 transpose: bool) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """im2col rows of NHWC `x` for a strided (or transposed) SAME conv.

    Returns (patches2d [N*Ho*Wo, Cin*k*k], (N, Ho, Wo)). The patch matrix is
    materialized once, by the final reshape."""
    n, h, w, c = x.shape
    xc = x.permute(0, 3, 1, 2)
    if transpose:
        pa, pb = _transpose_pads(kernel, stride)
        hd, wd = (h - 1) * stride + 1, (w - 1) * stride + 1
        xp = x.new_zeros((n, c, hd + pa + pb, wd + pa + pb))
        xp[:, :, pa:pa + hd:stride, pa:pa + wd:stride] = xc
        step = 1
    else:
        (ht, hb), (wl, wr) = (_same_pads(h, kernel, stride),
                              _same_pads(w, kernel, stride))
        xp = F.pad(xc, (wl, wr, ht, hb))
        step = stride
    p = xp.unfold(2, kernel, step).unfold(3, kernel, step)  # N,C,Ho,Wo,kh,kw
    ho, wo = p.shape[2], p.shape[3]
    p2d = p.permute(0, 2, 3, 1, 4, 5).reshape(n * ho * wo,
                                              c * kernel * kernel)
    return p2d, (n, ho, wo)


# ---------------------------------------------------------------------------
# gemm_bias_scale_act: act((P @ W + b) * scale + shift), f32 accumulation
# ---------------------------------------------------------------------------

def gemm_bias_scale_act_plain(p2d: torch.Tensor, w2d: torch.Tensor,
                              b: torch.Tensor, scale: torch.Tensor,
                              shift: torch.Tensor, act: str = "none",
                              leak: float = LEAK,
                              out_dtype: torch.dtype = torch.float32
                              ) -> torch.Tensor:
    """The plain PyTorch version: f32 product of the operands (exact for
    bf16 inputs), f32 epilogue, one cast to `out_dtype`."""
    check_act(act)
    u = torch.matmul(p2d.float(), w2d.float()) + b.float()
    v = u * scale.float() + shift.float()
    return act_fwd(v, act, leak).to(out_dtype)


def gemm_bias_scale_act(p2d: torch.Tensor, w2d: torch.Tensor,
                        b: torch.Tensor, scale: torch.Tensor,
                        shift: torch.Tensor, act: str = "none",
                        leak: float = LEAK,
                        out_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """act((p2d @ w2d + b) * scale + shift) for p2d [M, K], w2d [K, C] and
    [C] vectors, accumulated in f32, returned in `out_dtype`.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and raises if it cannot). `gemm_bias_scale_act.launches` counts
    launches."""
    check_act(act)
    if p2d.dim() != 2 or w2d.dim() != 2 or p2d.shape[1] != w2d.shape[0]:
        raise ValueError(f"p2d [M, K] @ w2d [K, C] expected, got "
                         f"{tuple(p2d.shape)} @ {tuple(w2d.shape)}")
    if p2d.dtype != w2d.dtype:
        raise TypeError(f"operand dtypes differ: {p2d.dtype} vs "
                        f"{w2d.dtype}")
    if out_dtype not in DTYPE_CODES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    m, k = p2d.shape
    c = w2d.shape[1]
    if p2d.device.type == "cpu":
        return gemm_bias_scale_act_plain(p2d, w2d, b, scale, shift, act,
                                         leak, out_dtype)
    check_matrix("p2d", p2d)
    check_matrix("w2d", w2d)
    if w2d.device != p2d.device:
        raise ValueError(f"w2d is on {w2d.device}, p2d on {p2d.device}")
    if max(m, k, c) > _INT_MAX:
        raise ValueError(f"dimension too large for the kernel: "
                         f"M={m} K={k} C={c}")
    b = channel_vector("b", b, c, p2d.device)
    scale = channel_vector("scale", scale, c, p2d.device)
    shift = channel_vector("shift", shift, c, p2d.device)
    in_code = DTYPE_CODES[p2d.dtype]
    sms = torch.cuda.get_device_properties(p2d.device).multi_processor_count
    splits = c_function("gemm_bias_scale_act",
                        "dcgan_gemm_bias_scale_act_splits")(m, k, c, in_code,
                                                            sms)
    y = torch.empty((m, c), dtype=out_dtype, device=p2d.device)
    # split-K partial sums, summed in split order by the kernel's finish
    ws = torch.empty((splits, m, c), dtype=torch.float32,
                     device=p2d.device) if splits > 1 else None
    fn = c_function("gemm_bias_scale_act", "dcgan_gemm_bias_scale_act")
    with torch.cuda.device(p2d.device):
        err = fn(p2d.data_ptr(), w2d.data_ptr(), b.data_ptr(),
                 scale.data_ptr(), shift.data_ptr(), y.data_ptr(),
                 ws.data_ptr() if ws is not None else None, splits, m, k, c,
                 in_code, DTYPE_CODES[out_dtype], ACT_CODES[act],
                 float(leak), torch.cuda.current_stream().cuda_stream)
    check_launch("gemm_bias_scale_act", err)
    gemm_bias_scale_act.launches += 1
    return y


gemm_bias_scale_act.launches = 0


# ---------------------------------------------------------------------------
# The fused stage: deconv ⊕ bias ⊕ BN ⊕ act
# ---------------------------------------------------------------------------

def fused_conv_bn_act(conv_params: Pytree, bn_params: Pytree,
                      bn_state: Pytree, x: torch.Tensor, *, transpose: bool,
                      kernel: int, stride: int = 2, train: bool,
                      eps: float = 1e-5, act: str, leak: float = LEAK,
                      compute_dtype: Optional[torch.dtype] = None
                      ) -> Tuple[torch.Tensor, Pytree]:
    """One G (transpose=True) or D stage as one kernel pass, returning
    (y NHWC, bn_state) with `batch_norm_apply`'s state contract.

    train=False: the running statistics are known before the GEMM, so the
    whole stage is the single gemm_bias_scale_act kernel. The patch matrix
    lives only inside this call."""
    if train:
        raise NotImplementedError(
            "fused_conv_bn_act(train=True) comes with the training slice")
    cdt = compute_dtype if compute_dtype is not None else x.dtype
    w, b = conv_params["w"], conv_params["b"]
    w2d = w_to_gemm(w.to(cdt))
    p2d, (n, ho, wo) = conv_patches(x.to(cdt), kernel, stride, transpose)
    c = w2d.shape[1]
    inv = torch.rsqrt(bn_state["var"].float() + eps)
    scale = bn_params["scale"].float() * inv
    shift = bn_params["bias"].float() - bn_state["mean"].float() * scale
    y2d = gemm_bias_scale_act(p2d, w2d, b, scale, shift, act, leak, cdt)
    return y2d.reshape(n, ho, wo, c), bn_state
