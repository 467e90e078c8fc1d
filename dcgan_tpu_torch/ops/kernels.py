"""BatchNorm kernels and their wrappers (the counterpart of
`dcgan_tpu/ops/pallas_kernels.py`).

- `channel_moments(x2d)`: per-channel (E[x], E[x^2]) over [N, C] in f32,
  the batch statistics of BN's train path. On a CUDA tensor it launches
  `csrc/channel_moments.cu` (which replaces the TPU kernel `_moments_kernel`)
  once, in the plan `moments_plan` makes; its backward is the broadcast
  expression the JAX package leaves to XLA.
- `scale_shift_act(x2d, scale, shift, act)`: y = act(x * scale + shift)
  over [N, C] with per-channel f32 vectors, f32 math, output in x's dtype.
  Differentiable: its forward launches `csrc/scale_shift_act.cu`'s forward
  (replacing `_ssa_fwd_kernel`) in the design `ssa_fwd_design` picks, its
  backward `scale_shift_act_bwd`, the same file's backward kernel
  (replacing `_ssa_bwd_kernel`), which returns dx, dscale and dshift in one
  launch, in the design `ssa_bwd_design` picks.
- `fused_bn_act`: BatchNorm + activation built on `scale_shift_act`.

On a CPU tensor each wrapper runs its `*_plain` version, the same function
in plain PyTorch; on a CUDA tensor it launches the kernel or raises. Each
wrapper counts its launches in `.launches`.

The module also holds the ctypes plumbing shared with `ops/fused.py` and
`ops/flash_attention.py`:
argument checks, the dtype codes of `csrc/common.cuh`, and raising on a
launch the runtime refused.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from dcgan_tpu_torch.ops import _build
from dcgan_tpu_torch.ops.activations import ACT_CODES, LEAK, act_fwd, \
    act_grad, check_act

# csrc/common.cuh::DType
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float
_SIGNATURES = {
    "dcgan_scale_shift_act": (
        # x, scale, shift, y, n, c, dtype, act, leak, design, sm_count,
        # stream
        [_P, _P, _P, _P, _I64, _I, _I, _I, _F, _I, _I, _P]),
    "dcgan_scale_shift_act_bwd": (
        # x, scale, shift, g, dx, dscale, dshift, part, ticket, design,
        # chunks, n, c, dtype, act, leak, stream
        [_P] * 9 + [_I, _I, _I64, _I, _I, _I, _F, _P]),
    # n, c, dtype, design, sm_count
    "dcgan_scale_shift_act_bwd_chunks": [_I64, _I, _I, _I, _I],
    "dcgan_channel_moments": (
        # x, mean, mean_sq, part, ticket, design, strips, groups, n, c,
        # dtype, inv_n, stream
        [_P] * 5 + [_I, _I, _I, _I64, _I, _I, _F, _P]),
    "dcgan_gemm_bias_scale_act": (
        # p, w, bias, scale, shift, y, ws, design, bm, bn, stages, splits,
        # m, k, c, in_dtype, out_dtype, act, leak, stream
        [_P] * 7 + [_I] * 11 + [_F, _P]),
    "dcgan_gemm_bias_moments": (
        # p, w, bias, u, mean, mean_sq, ws, part, design, bm, bn, stages,
        # splits, parts, m, k, c, in_dtype, round_bf16, inv_m, stream
        [_P] * 8 + [_I] * 11 + [_F, _P]),
    "dcgan_gemm_bias_moments_parts": [_I] * 5,  # m, c, in_dtype, splits, sms
    # q, k, v, out, lse, b, s, dk, dv, dtype, scale, stream
    "dcgan_flash_fwd": [_P] * 5 + [_I] * 5 + [_F, _P],
    # q, k, v, do, lse, delta, dq, b, s, dk, dv, dtype, scale, stream
    "dcgan_flash_dq": [_P] * 7 + [_I] * 5 + [_F, _P],
    # q, k, v, do, lse, delta, dk, dv, b, s, dk, dv, dtype, scale, stream
    "dcgan_flash_dkv": [_P] * 8 + [_I] * 5 + [_F, _P],
}


def not_capturing(what: str) -> None:
    """Raise if the current stream is capturing a CUDA graph: `what` (a
    build, a ticket's allocation) must happen in the eager warm-up that
    precedes every capture (graphs.py), not inside it, where a build's
    host work would not be recorded and an allocation would come from the
    graph's pool, zeroed only at replay."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{what} inside a CUDA graph capture: run the "
                           "captured function once eagerly first")


def c_function(source: str, symbol: str):
    """`symbol` of the library built from `csrc/<source>.cu`, with its
    ctypes signature set (pointers and the stream as c_void_p)."""
    if not _build.is_loaded(source):
        not_capturing(f"the build of csrc/{source}.cu")
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
    if t.numel() == 0:
        raise ValueError(f"{name} is empty, shape {tuple(t.shape)}")


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


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# channel_moments: [N, C] -> (mean [C], mean_sq [C]), f32
# ---------------------------------------------------------------------------

def channel_moments_plain(x2d: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: f32 sums times 1/N."""
    xf = x2d.float()
    inv_n = 1.0 / x2d.shape[0]
    return xf.sum(0) * inv_n, (xf * xf).sum(0) * inv_n


# csrc/channel_moments.cu: the designs, the threads of a CTA, the CTAs of a
# cluster, the threads across a column strip (vector, scalar), the row
# steps whose loads go out together and the CTAs per SM the plan allows
MOMENTS_DESIGNS = {"scalar": 0, "vector": 1}
MOMENTS_THREADS = 256
MOMENTS_CLUSTER = 16
MOMENTS_STRIP = {"vector": 16, "scalar": 32}
MOMENTS_ROWS_PER_TURN = 4
MOMENTS_CTAS_PER_SM = 2


class MomentsPlan(NamedTuple):
    """A launch of the channel_moments kernel: its design, the column
    strips (one cluster row of the grid each; the launch refuses a count
    other than its build's strip width gives) and the clusters per strip
    (`groups`: 1, the cluster adds all of the strip's rows and writes the
    moments; more, each cluster writes a partial and the last adds them)."""
    design: str
    strips: int
    groups: int


def moments_plan(n: int, c: int, dtype: torch.dtype, aligned: bool,
                 sms: int) -> MomentsPlan:
    """The plan of channel_moments' kernel for an [n, c] input of `dtype`
    on a card of `sms` SMs: the "vector" design (16 bytes per load) where c
    is a multiple of the 16-byte width (8 bf16 or 4 f32 values) and x is
    16-byte `aligned`, else "scalar" (one element per load). One cluster per
    strip while each of its CTAs walks at most one turn of
    MOMENTS_ROWS_PER_TURN row steps; above that, as many clusters per strip
    as keep each CTA at a turn at least, with at most MOMENTS_CTAS_PER_SM
    CTAs per SM in all."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"dtype must be float32 or bfloat16, got {dtype}")
    if n < 1 or c < 1 or sms < 1:
        raise ValueError(f"moments_plan: n={n}, c={c}, sms={sms}")
    vec = 16 // (4 if dtype == torch.float32 else 2)
    design = "vector" if aligned and c % vec == 0 else "scalar"
    per_row = c // vec if design == "vector" else c
    sw = min(per_row, MOMENTS_STRIP[design])
    strips = -(-per_row // sw)
    cluster_rows = MOMENTS_CLUSTER * MOMENTS_ROWS_PER_TURN \
        * (MOMENTS_THREADS // sw)
    cap = MOMENTS_CTAS_PER_SM * sms // (strips * MOMENTS_CLUSTER)
    return MomentsPlan(design, strips,
                       max(1, min(-(-n // cluster_rows), cap)))


def channel_moments_launch(x2d: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on a CUDA tensor (raises if it cannot launch), one launch
    in the plan `moments_plan` makes."""
    check_matrix("x2d", x2d)
    n, c = x2d.shape
    dev = x2d.device
    plan = moments_plan(n, c, x2d.dtype, x2d.data_ptr() % 16 == 0,
                        sm_count(dev))
    mean = torch.empty(c, dtype=torch.float32, device=dev)
    mean_sq = torch.empty(c, dtype=torch.float32, device=dev)
    part = torch.empty((2, plan.groups, c), dtype=torch.float32,
                       device=dev) if plan.groups > 1 else None
    fn = c_function("channel_moments", "dcgan_channel_moments")
    with torch.cuda.device(dev):
        err = fn(x2d.data_ptr(), mean.data_ptr(), mean_sq.data_ptr(),
                 None if part is None else part.data_ptr(),
                 _ticket(dev, "channel_moments").data_ptr(),
                 MOMENTS_DESIGNS[plan.design], plan.strips, plan.groups, n, c,
                 DTYPE_CODES[x2d.dtype], 1.0 / n, stream_of(dev))
    check_launch("channel_moments", err)
    channel_moments.launches += 1
    channel_moments.launches_by_design[plan.design] += 1
    return mean, mean_sq


class _ChannelMoments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d):
        ctx.save_for_backward(x2d)
        if x2d.device.type == "cpu":
            return channel_moments_plain(x2d)
        return channel_moments_launch(x2d)

    @staticmethod
    def backward(ctx, g_mean, g_msq):
        # d mean/dx = 1/N, d mean_sq/dx = 2x/N: `_moments_vjp_bwd`'s
        # broadcast expression, which XLA fuses; no kernel
        (x2d,) = ctx.saved_tensors
        n = x2d.shape[0]
        dx = (g_mean.float()[None, :]
              + 2.0 * x2d.float() * g_msq.float()[None, :]) / n
        return dx.to(x2d.dtype)


def channel_moments(x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (E[x], E[x^2]) over axis 0 of [N, C], f32, one pass;
    differentiable. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (and raises if it cannot) in the plan
    `moments_plan` makes. `channel_moments.launches` counts launches,
    `.launches_by_design` them by design. Above one cluster per strip the
    launch draws on this kernel's ticket (`_ticket`), so launches on one
    device must not overlap: launch on one stream."""
    if x2d.dim() != 2:
        raise ValueError(f"x2d must be 2-D, got shape {tuple(x2d.shape)}")
    return _ChannelMoments.apply(x2d)


channel_moments.launches = 0
channel_moments.launches_by_design = dict.fromkeys(MOMENTS_DESIGNS, 0)


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


def scale_shift_act_launch(x2d: torch.Tensor, scale: torch.Tensor,
                           shift: torch.Tensor, act: str = "none",
                           leak: float = LEAK) -> torch.Tensor:
    """The forward kernel on a CUDA tensor (raises if it cannot launch), in
    the design `ssa_fwd_design` picks."""
    check_act(act)
    check_matrix("x2d", x2d)
    n, c = x2d.shape
    dev = x2d.device
    scale = channel_vector("scale", scale, c, dev)
    shift = channel_vector("shift", shift, c, dev)
    y = torch.empty_like(x2d)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x2d, y, scale, shift))
    design = ssa_fwd_design(c, x2d.dtype, aligned)
    fn = c_function("scale_shift_act", "dcgan_scale_shift_act")
    with torch.cuda.device(dev):
        err = fn(x2d.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                 y.data_ptr(), n, c, DTYPE_CODES[x2d.dtype], ACT_CODES[act],
                 float(leak), SSA_FWD_DESIGNS[design], sm_count(dev),
                 stream_of(dev))
    check_launch("scale_shift_act", err)
    scale_shift_act.launches += 1
    scale_shift_act.launches_by_design[design] += 1
    return y


def scale_shift_act_bwd_plain(x2d: torch.Tensor, scale: torch.Tensor,
                              shift: torch.Tensor, g: torch.Tensor,
                              act: str = "none", leak: float = LEAK
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The backward's plain version: (dx in x's dtype, dscale f32,
    dshift f32), `_ssa_bwd_kernel`'s arithmetic."""
    check_act(act)
    xf, s, t = x2d.float(), scale.float(), shift.float()
    du = g.float() * act_grad(xf * s + t, act, leak)
    return ((du * s).to(x2d.dtype), (du * xf).sum(0), du.sum(0))


# csrc/scale_shift_act.cu::FwdDesign and BwdDesign, and each direction's
# threads per block
SSA_FWD_DESIGNS = {"scalar": 0, "vector": 1}
SSA_FWD_THREADS = 256
SSA_BWD_DESIGNS = {"scalar": 0, "vector": 1}
SSA_BWD_THREADS = 256


def _row_design(c: int, dtype: torch.dtype, aligned: bool,
                threads: int) -> str:
    """"vector" where c is a multiple of the 16-byte width (8 bf16 or 4 f32
    values), one row takes at most `threads` such widths and the operands
    are 16-byte `aligned`; "scalar" otherwise."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"dtype must be float32 or bfloat16, got {dtype}")
    vec = 16 // (4 if dtype == torch.float32 else 2)
    if aligned and c % vec == 0 and c // vec <= threads:
        return "vector"
    return "scalar"


def ssa_fwd_design(c: int, dtype: torch.dtype, aligned: bool) -> str:
    """The design of scale_shift_act's forward kernel for [N, c] operands
    of `dtype`, a dispatch by shape and alignment: "vector" (each thread
    owns 16 bytes of columns, keeps their scale and shift in registers and
    walks rows) where c is a multiple of the 16-byte width, one row takes
    at most SSA_FWD_THREADS such widths, and x, y, scale and shift are
    16-byte `aligned`; "scalar" (a grid-stride loop over elements)
    otherwise."""
    return _row_design(c, dtype, aligned, SSA_FWD_THREADS)


def ssa_bwd_design(c: int, dtype: torch.dtype, aligned: bool) -> str:
    """The design of scale_shift_act's backward kernel for [N, c] operands
    of `dtype`, a dispatch by shape and alignment: "vector" (each thread
    moves 16 bytes of a row per load and store) where c is a multiple of
    the 16-byte width (8 bf16 or 4 f32 values), one row takes at most
    SSA_BWD_THREADS such widths, and x, g and dx are 16-byte `aligned`;
    "scalar" (one element per thread, 32-column strips) otherwise."""
    return _row_design(c, dtype, aligned, SSA_BWD_THREADS)


# one int32 per (device, kernel) for the last-block tickets of
# channel_moments and scale_shift_act's backward, zeroed once; every launch
# leaves its ticket at 0 again, so a fault in one kernel's launch cannot
# leave the other's count wrong
_TICKETS: Dict[Tuple[int, str], torch.Tensor] = {}


def _ticket(device: torch.device, kernel: str) -> torch.Tensor:
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    ticket = _TICKETS.get((index, kernel))
    if ticket is None:
        not_capturing(f"the first {kernel} ticket")
        ticket = _TICKETS[index, kernel] = torch.zeros(
            1, dtype=torch.int32, device=torch.device("cuda", index))
    return ticket


def scale_shift_act_bwd(x2d: torch.Tensor, scale: torch.Tensor,
                        shift: torch.Tensor, g: torch.Tensor,
                        act: str = "none", leak: float = LEAK
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dscale, dshift) of y = act(x * scale + shift) for the cotangent
    g of y: dx in x's dtype, dscale and dshift f32. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel (and raises if it
    cannot) in the design `ssa_bwd_design` picks.
    `scale_shift_act_bwd.launches` counts launches, `.launches_by_design`
    them by design. Every launch draws on this kernel's ticket (`_ticket`),
    so launches on one device must not overlap: launch on one stream."""
    check_act(act)
    if x2d.device.type == "cpu":
        return scale_shift_act_bwd_plain(x2d, scale, shift, g, act, leak)
    check_matrix("x2d", x2d)
    check_matrix("g", g)
    if g.shape != x2d.shape or g.dtype != x2d.dtype \
            or g.device != x2d.device:
        raise ValueError(f"g {tuple(g.shape)}/{g.dtype}/{g.device} must "
                         f"match x2d {tuple(x2d.shape)}/{x2d.dtype}/"
                         f"{x2d.device}")
    n, c = x2d.shape
    dev = x2d.device
    scale = channel_vector("scale", scale, c, dev)
    shift = channel_vector("shift", shift, c, dev)
    dx = torch.empty_like(x2d)
    aligned = (x2d.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0
               and dx.data_ptr() % 16 == 0)
    design = ssa_bwd_design(c, x2d.dtype, aligned)
    code = DTYPE_CODES[x2d.dtype]
    chunks = c_function("scale_shift_act",
                        "dcgan_scale_shift_act_bwd_chunks")(
        n, c, code, SSA_BWD_DESIGNS[design], sm_count(dev))
    dscale = torch.empty(c, dtype=torch.float32, device=dev)
    dshift = torch.empty(c, dtype=torch.float32, device=dev)
    part = torch.empty((2, chunks, c), dtype=torch.float32, device=dev)
    fn = c_function("scale_shift_act", "dcgan_scale_shift_act_bwd")
    with torch.cuda.device(dev):
        err = fn(x2d.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                 g.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
                 dshift.data_ptr(), part.data_ptr(),
                 _ticket(dev, "scale_shift_act_bwd").data_ptr(),
                 SSA_BWD_DESIGNS[design],
                 chunks, n, c, code, ACT_CODES[act], float(leak),
                 stream_of(dev))
    check_launch("scale_shift_act_bwd", err)
    scale_shift_act_bwd.launches += 1
    scale_shift_act_bwd.launches_by_design[design] += 1
    return dx, dscale, dshift


scale_shift_act_bwd.launches = 0
scale_shift_act_bwd.launches_by_design = dict.fromkeys(SSA_BWD_DESIGNS, 0)


class _ScaleShiftAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, scale, shift, act, leak):
        ctx.save_for_backward(x2d, scale, shift)
        ctx.act, ctx.leak = act, leak
        if x2d.device.type == "cpu":
            return scale_shift_act_plain(x2d, scale, shift, act, leak)
        return scale_shift_act_launch(x2d, scale, shift, act, leak)

    @staticmethod
    def backward(ctx, g):
        x2d, scale, shift = ctx.saved_tensors
        dx, dscale, dshift = scale_shift_act_bwd(
            x2d, scale, shift, g.contiguous(), ctx.act, ctx.leak)
        return (dx, dscale.to(scale.dtype), dshift.to(shift.dtype), None,
                None)


def scale_shift_act(x2d: torch.Tensor, scale: torch.Tensor,
                    shift: torch.Tensor, act: str = "none",
                    leak: float = LEAK) -> torch.Tensor:
    """y = act(x * scale + shift) over [N, C] with [C] scale/shift;
    differentiable in x, scale and shift.

    A CPU tensor takes the plain versions; a CUDA tensor launches the
    kernels (and raises if it cannot). `scale_shift_act.launches` counts
    forward launches (`.launches_by_design` by design),
    `scale_shift_act_bwd.launches` backward ones."""
    check_act(act)
    if x2d.dim() != 2:
        raise ValueError(f"x2d must be 2-D, got shape {tuple(x2d.shape)}")
    return _ScaleShiftAct.apply(x2d, scale, shift, act, leak)


scale_shift_act.launches = 0
scale_shift_act.launches_by_design = dict.fromkeys(SSA_FWD_DESIGNS, 0)


# ---------------------------------------------------------------------------
# Fused BN + activation built on the kernel
# ---------------------------------------------------------------------------

def bn_scale_shift(gamma: torch.Tensor, beta: torch.Tensor,
                   mean: torch.Tensor, var: torch.Tensor, eps: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """BN's affine folded into f32 per-channel vectors, differentiably:
    scale = gamma * rsqrt(var + eps), shift = beta - mean * scale."""
    inv = torch.rsqrt(var.float() + eps)
    scale = gamma.float() * inv
    return scale, beta.float() - mean.float() * scale


def fused_bn_act(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 mean: torch.Tensor, var: torch.Tensor, *, eps: float,
                 act: str, leak: float = LEAK) -> torch.Tensor:
    """y = act((x - mean) * rsqrt(var + eps) * gamma + beta) for NHWC (or
    [N, C]) `x`: the statistics fold into f32 scale/shift vectors, then one
    scale_shift_act pass. mean/var may be batch moments (train) or running
    statistics; gradients flow through them either way."""
    c = x.shape[-1]
    scale, shift = bn_scale_shift(gamma, beta, mean, var, eps)
    y2d = scale_shift_act(x.reshape(-1, c), scale, shift, act, leak)
    return y2d.reshape(x.shape)
