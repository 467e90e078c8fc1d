"""Elementwise BN-epilogue kernel and its wrapper (the counterpart of
`dcgan_tpu/ops/pallas_kernels.py`).

- `scale_shift_act(x2d, scale, shift, act)`: y = act(x * scale + shift) over
  [N, C] with per-channel f32 vectors, one pass, f32 math, output in x's
  dtype. On a CUDA tensor it launches `csrc/scale_shift_act.cu` (which
  replaces the TPU kernel `_ssa_fwd_kernel`); on a CPU tensor it runs
  `scale_shift_act_plain`, the same function in plain PyTorch.
- `fused_bn_act`: inference BatchNorm + activation built on it.

The wrappers also hold the ctypes plumbing shared with `ops/fused.py`:
argument checks, the dtype codes of `csrc/common.cuh`, and raising on a
launch the runtime refused.
"""

from __future__ import annotations

import ctypes

import torch

from dcgan_tpu_torch.ops import _build
from dcgan_tpu_torch.ops.activations import ACT_CODES, LEAK, act_fwd, \
    check_act

# csrc/common.cuh::DType
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_SIGNATURES = {
    "dcgan_scale_shift_act": (
        # x, scale, shift, y, n, c, dtype, act, leak, stream
        [_P, _P, _P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_float, _P]),
    "dcgan_gemm_bias_scale_act": (
        # p, w, bias, scale, shift, y, ws, splits, m, k, c, in_dtype,
        # out_dtype, act, leak, stream
        [_P, _P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_float, _P]),
    "dcgan_gemm_bias_scale_act_splits": (
        # m, k, c, in_dtype, sm_count
        [ctypes.c_int] * 5),
}


def c_function(source: str, symbol: str):
    """`symbol` of the library built from `csrc/<source>.cu`, with its
    ctypes signature set (pointers and the stream as c_void_p)."""
    fn = getattr(_build.load(source), symbol)
    fn.argtypes = _SIGNATURES[symbol]
    fn.restype = ctypes.c_int
    return fn


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError_t {err}")


def check_matrix(name: str, t: torch.Tensor) -> None:
    """A kernel operand: 2-D, contiguous, f32 or bf16, on a CUDA device."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dim() != 2:
        raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def channel_vector(name: str, t: torch.Tensor, c: int,
                   device: torch.device) -> torch.Tensor:
    """A per-channel [c] vector as the kernels take it: f32, contiguous,
    on `device` (cast here, as the TPU wrappers cast to f32)."""
    if tuple(t.shape) != (c,):
        raise ValueError(f"{name} must have shape ({c},), got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, operands on {device}")
    return t.to(torch.float32).contiguous()


# ---------------------------------------------------------------------------
# scale_shift_act: y = act(x * scale + shift), per-channel scale/shift
# ---------------------------------------------------------------------------

def scale_shift_act_plain(x2d: torch.Tensor, scale: torch.Tensor,
                          shift: torch.Tensor, act: str = "none",
                          leak: float = LEAK) -> torch.Tensor:
    """The plain PyTorch version: f32 math, one cast back to x's dtype."""
    check_act(act)
    u = x2d.float() * scale.float() + shift.float()
    return act_fwd(u, act, leak).to(x2d.dtype)


def scale_shift_act(x2d: torch.Tensor, scale: torch.Tensor,
                    shift: torch.Tensor, act: str = "none",
                    leak: float = LEAK) -> torch.Tensor:
    """y = act(x * scale + shift) over [N, C] with [C] scale/shift.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and raises if it cannot). `scale_shift_act.launches` counts launches."""
    check_act(act)
    if x2d.dim() != 2:
        raise ValueError(f"x2d must be 2-D, got shape {tuple(x2d.shape)}")
    n, c = x2d.shape
    if x2d.device.type == "cpu":
        return scale_shift_act_plain(x2d, scale, shift, act, leak)
    check_matrix("x2d", x2d)
    scale = channel_vector("scale", scale, c, x2d.device)
    shift = channel_vector("shift", shift, c, x2d.device)
    y = torch.empty_like(x2d)
    fn = c_function("scale_shift_act", "dcgan_scale_shift_act")
    with torch.cuda.device(x2d.device):
        err = fn(x2d.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                 y.data_ptr(), n, c, DTYPE_CODES[x2d.dtype], ACT_CODES[act],
                 float(leak), torch.cuda.current_stream().cuda_stream)
    check_launch("scale_shift_act", err)
    scale_shift_act.launches += 1
    return y


scale_shift_act.launches = 0


# ---------------------------------------------------------------------------
# Fused BN + activation built on the kernel
# ---------------------------------------------------------------------------

def fused_bn_act(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 mean: torch.Tensor, var: torch.Tensor, *, eps: float,
                 act: str, leak: float = LEAK) -> torch.Tensor:
    """y = act((x - mean) * rsqrt(var + eps) * gamma + beta) for NHWC (or
    [N, C]) `x`: the statistics fold into f32 scale/shift vectors, then one
    scale_shift_act pass."""
    c = x.shape[-1]
    inv = torch.rsqrt(var.float() + eps)
    scale = gamma.float() * inv
    shift = beta.float() - mean.float() * scale
    y2d = scale_shift_act(x.reshape(-1, c), scale, shift, act, leak)
    return y2d.reshape(x.shape)
