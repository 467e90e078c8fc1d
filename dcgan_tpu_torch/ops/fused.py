"""Fused conv/deconv stage: im2col + GEMM-epilogue kernels (the
counterpart of `dcgan_tpu/ops/pallas_fused.py`).

Formulation, as in the JAX package: patch extraction stays plain tensor
code (`conv_patches`, PyTorch's `unfold` over the zero-dilated, padded input
for a transposed conv), producing [M, Cin*k*k] rows whose GEMM against the
[Cin*k*k, Cout] reshaped kernel (`w_to_gemm`) IS the conv. Patch features are
channel-major (Cin slowest, then kh, kw), the order of
`lax.conv_general_dilated_patches`.

Two GEMM kernels, each with its plain version for CPU tensors:
- `gemm_bias_scale_act` runs the whole inference stage,
  act((P @ W + b) * scale + shift), in one pass: on a CUDA tensor the
  `csrc/gemm_bias_scale_act.cu` kernel (which replaces the TPU kernel
  `_gemm_bias_scale_act_kernel`), in the design and tiles that
  `gbsa_plan` picks. It is differentiable; its backward is
  `_gbsa_vjp_bwd`'s (`dcgan_tpu/ops/pallas_fused.py:250-287`): u
  recomputed with one f32 matmul, then f32 products in torch ops, as the
  JAX package takes them in XLA;
- `gemm_bias_moments` is the train stage's forward, u = P @ W + b in f32
  with the per-channel (E[v], E[v^2]) of v = u in the compute dtype: on a
  CUDA tensor `csrc/gemm_bias_moments.cu` (replacing
  `_gemm_bias_moments_kernel`), in the design and tiles that the same
  `gbsa_plan` picks. It is differentiable; its backward is
  `_gbm_vjp_bwd`'s two matmuls, which the JAX package leaves to XLA and
  this port to `torch.matmul`.
`fused_conv_bn_act(train=True)` follows it with BN's batch arithmetic and
the `scale_shift_act` epilogue (ops/kernels.py). Under the fp8 policy a
quantized stage passes the patch matrix and W through `fake_quant_fp8`
before either kernel: one more elementwise pass over the patches, outside
the kernel, as in the JAX package.

Under a CUDA graph capture (graphs.py): the v2 design of both kernels
encodes its TMA descriptors on the host, from the operands' addresses, at
every launch (`csrc/gemm_wgmma.cuh`'s `encode_tiled`), and passes them as
kernel parameters, so a capture bakes them into the graph. That is right
only because every operand of a captured program keeps its address from
replay to replay: the static inputs are the owner's, and the
intermediates come from the graph's private pool at the addresses the
capture gave them.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from dcgan_tpu_torch.ops.activations import ACT_CODES, LEAK, act_fwd, \
    act_grad, check_act
from dcgan_tpu_torch.ops.kernels import DTYPE_CODES, bn_scale_shift, \
    c_function, channel_vector, check_launch, check_matrix, \
    scale_shift_act, sm_count, stream_of
from dcgan_tpu_torch.ops.layers import fake_quant_fp8, same_pads
from dcgan_tpu_torch.ops.norm import finish_batch_moments
from dcgan_tpu_torch.parallel.collectives import synced_moments

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
        (ht, hb), (wl, wr) = (same_pads(h, kernel, stride),
                              same_pads(w, kernel, stride))
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


def _check_gemm(p2d: torch.Tensor, w2d: torch.Tensor,
                out_dtype: torch.dtype) -> None:
    if p2d.dim() != 2 or w2d.dim() != 2 or p2d.shape[1] != w2d.shape[0]:
        raise ValueError(f"p2d [M, K] @ w2d [K, C] expected, got "
                         f"{tuple(p2d.shape)} @ {tuple(w2d.shape)}")
    if p2d.dtype != w2d.dtype:
        raise TypeError(f"operand dtypes differ: {p2d.dtype} vs "
                        f"{w2d.dtype}")
    if out_dtype not in DTYPE_CODES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")


def _check_gemm_operands(p2d: torch.Tensor, w2d: torch.Tensor) -> None:
    """The CUDA kernels' operand contract, past `_check_gemm`."""
    check_matrix("p2d", p2d)
    check_matrix("w2d", w2d)
    if w2d.device != p2d.device:
        raise ValueError(f"w2d is on {w2d.device}, p2d on {p2d.device}")
    m, k = p2d.shape
    c = w2d.shape[1]
    if max(m, k, c) > _INT_MAX:
        raise ValueError(f"dimension too large for the kernel: "
                         f"M={m} K={k} C={c}")


# csrc/gemm_bias_scale_act.cu::Design
GBSA_DESIGNS = {"simt": 0, "v1": 1, "v2": 2}
# The v2 kernel's tile constants (csrc/gemm_wgmma.cuh: kBM, kMaxStages,
# kBK, kSmemBudget); the launch refuses a plan that disagrees with them
GBSA_V2_BM = 128
GBSA_V2_MAX_STAGES = 6
GBSA_V2_BK = 64
GBSA_V2_SMEM_BUDGET = 200 * 1024
# v2: at least this many 64-deep K blocks per split
GBSA_V2_MIN_KB_PER_SPLIT = 8


class GbsaPlan(NamedTuple):
    """A launch of the gemm_bias_scale_act kernel: the design, the output
    tile (bm rows, bn columns), the depth of its shared-memory ring, and
    how many split-K groups sum disjoint K ranges (1: none)."""
    design: str
    bm: int
    bn: int
    stages: int
    splits: int

    def ctas(self, m: int, c: int) -> int:
        """CTAs of the main kernel for an [m, c] output."""
        return (-(-m // self.bm)) * (-(-c // self.bn)) * self.splits


def gbsa_plan(m: int, k: int, c: int, in_dtype: torch.dtype, aligned: bool,
              sm_count: int) -> GbsaPlan:
    """The launch plan of gemm_bias_scale_act for P [m, k] @ W [k, c] with
    operands of `in_dtype`. A dispatch by shape and alignment:

    - float32 operands: "simt", 64 x 64 f32 FMA tiles, no split;
    - bfloat16 with `aligned` (k and c multiples of 8, P and W 16-byte
      aligned: TMA's rule for global strides and base): "v2", TMA-fed
      wgmma on GBSA_V2_BM-row tiles whose columns are all of c up to 256
      (bn 64, 128 or 256), so P is read once; the ring as deep as
      GBSA_V2_MAX_STAGES and the CTA's share of the shared memory allow
      (two CTAs per SM at bn 64, one otherwise);
    - other bfloat16 shapes: "v1", 128 x 128 WMMA tiles (128 x 64 when
      c <= 64) behind a two-stage ring.

    Both bf16 designs split K (in powers of 2) while the doubled CTA count
    still fits on the card at once (two CTAs per SM for v1 and for v2 at
    bn 64, one otherwise) and each split keeps enough of K: 256 for v1,
    GBSA_V2_MIN_KB_PER_SPLIT 64-deep blocks for v2."""
    if min(m, k, c) < 1 or sm_count < 1:
        raise ValueError(f"gbsa_plan needs positive m, k, c and sm_count, "
                         f"got {m}, {k}, {c}, {sm_count}")
    if in_dtype == torch.float32:
        return GbsaPlan("simt", 64, 64, 1, 1)
    if in_dtype != torch.bfloat16:
        raise TypeError(f"in_dtype must be float32 or bfloat16, got "
                        f"{in_dtype}")
    if aligned and (k % 8 or c % 8):
        raise ValueError(f"aligned operands need k and c multiples of 8, "
                         f"got k={k}, c={c}")
    if aligned:
        bn = 64 if c <= 64 else 128 if c <= 128 else 256
        per_sm = 2 if bn == 64 else 1
        stage_bytes = (GBSA_V2_BM + bn) * GBSA_V2_BK * 2
        stages = min(GBSA_V2_MAX_STAGES,
                     GBSA_V2_SMEM_BUDGET // per_sm // stage_bytes)
        plan = GbsaPlan("v2", GBSA_V2_BM, bn, stages, 1)
        resident = per_sm * sm_count
        depth = -(-k // GBSA_V2_BK)
        per_split = GBSA_V2_MIN_KB_PER_SPLIT
    else:
        bn = 64 if c <= 64 else 128
        plan = GbsaPlan("v1", 128, bn, 2, 1)
        resident = 2 * sm_count
        depth, per_split = k, 256
    splits = 1
    while plan.ctas(m, c) * 2 * splits <= resident \
            and depth >= 2 * splits * per_split:
        splits *= 2
    return plan._replace(splits=splits)


def gemm_plan(p2d: torch.Tensor, w2d: torch.Tensor, sms: int) -> GbsaPlan:
    """The launch plan of either GEMM kernel for P [M, K] @ W [K, C] on a
    card of `sms` SMs: `gbsa_plan`, with the operands `aligned` where K and
    C are multiples of 8 and both data pointers are 16-byte aligned (TMA's
    rule for global strides and base)."""
    m, k = p2d.shape
    c = w2d.shape[1]
    aligned = (k % 8 == 0 and c % 8 == 0 and p2d.data_ptr() % 16 == 0
               and w2d.data_ptr() % 16 == 0)
    return gbsa_plan(m, k, c, p2d.dtype, aligned, sms)


def gemm_bias_scale_act_launch(p2d: torch.Tensor, w2d: torch.Tensor,
                               b: torch.Tensor, scale: torch.Tensor,
                               shift: torch.Tensor, act: str, leak: float,
                               out_dtype: torch.dtype) -> torch.Tensor:
    """The kernel on CUDA tensors (raises if it cannot launch), in the
    design `gemm_plan` picks."""
    _check_gemm_operands(p2d, w2d)
    m, k = p2d.shape
    c = w2d.shape[1]
    dev = p2d.device
    b = channel_vector("b", b, c, dev)
    scale = channel_vector("scale", scale, c, dev)
    shift = channel_vector("shift", shift, c, dev)
    plan = gemm_plan(p2d, w2d, sm_count(dev))
    y = torch.empty((m, c), dtype=out_dtype, device=dev)
    # split-K partial sums, summed in split order by the kernel's finish
    ws = torch.empty((plan.splits, m, c), dtype=torch.float32,
                     device=dev) if plan.splits > 1 else None
    fn = c_function("gemm_bias_scale_act", "dcgan_gemm_bias_scale_act")
    with torch.cuda.device(dev):
        err = fn(p2d.data_ptr(), w2d.data_ptr(), b.data_ptr(),
                 scale.data_ptr(), shift.data_ptr(), y.data_ptr(),
                 ws.data_ptr() if ws is not None else None,
                 GBSA_DESIGNS[plan.design], plan.bm, plan.bn, plan.stages,
                 plan.splits, m, k, c, DTYPE_CODES[p2d.dtype],
                 DTYPE_CODES[out_dtype], ACT_CODES[act], float(leak),
                 stream_of(dev))
    check_launch("gemm_bias_scale_act", err)
    gemm_bias_scale_act.launches += 1
    gemm_bias_scale_act.launches_by_design[plan.design] += 1
    return y


class _GemmBiasScaleAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p2d, w2d, b, scale, shift, act, leak, out_dtype):
        ctx.save_for_backward(p2d, w2d, b, scale, shift)
        ctx.act, ctx.leak = act, leak
        if p2d.device.type == "cpu":
            return gemm_bias_scale_act_plain(p2d, w2d, b, scale, shift, act,
                                             leak, out_dtype)
        return gemm_bias_scale_act_launch(p2d, w2d, b, scale, shift, act,
                                          leak, out_dtype)

    @staticmethod
    def backward(ctx, g):
        # `_gbsa_vjp_bwd`: u recomputed in f32 (one matmul) instead of
        # stored, then f32 products outside any kernel (XLA's in JAX), each
        # cotangent cast to its input's dtype
        p2d, w2d, b, scale, shift = ctx.saved_tensors
        pf, wf, sf = p2d.float(), w2d.float(), scale.float()
        u = torch.matmul(pf, wf) + b.float()
        v = u * sf + shift.float()
        dv = g.float() * act_grad(v, ctx.act, ctx.leak)
        du = dv * sf
        need = ctx.needs_input_grad
        dp = torch.matmul(du, wf.t()).to(p2d.dtype) if need[0] else None
        dw = torch.matmul(pf.t(), du).to(w2d.dtype) if need[1] else None
        db = du.sum(0).to(b.dtype) if need[2] else None
        dscale = (dv * u).sum(0).to(scale.dtype) if need[3] else None
        dshift = dv.sum(0).to(shift.dtype) if need[4] else None
        return dp, dw, db, dscale, dshift, None, None, None


def gemm_bias_scale_act(p2d: torch.Tensor, w2d: torch.Tensor,
                        b: torch.Tensor, scale: torch.Tensor,
                        shift: torch.Tensor, act: str = "none",
                        leak: float = LEAK,
                        out_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """act((p2d @ w2d + b) * scale + shift) for p2d [M, K], w2d [K, C] and
    [C] vectors, accumulated in f32, returned in `out_dtype`;
    differentiable in the five tensors.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and raises if it cannot) in the design `gbsa_plan` picks: bf16
    operands whose K and C are multiples of 8 and whose data pointers are
    16-byte aligned take v2 (TMA and wgmma), other bf16 operands v1
    (WMMA), f32 operands the SIMT kernel. `gemm_bias_scale_act.launches`
    counts launches, `.launches_by_design` them by design; the backward
    launches none of them."""
    check_act(act)
    _check_gemm(p2d, w2d, out_dtype)
    return _GemmBiasScaleAct.apply(p2d, w2d, b, scale, shift, act, leak,
                                   out_dtype)


gemm_bias_scale_act.launches = 0
gemm_bias_scale_act.launches_by_design = dict.fromkeys(GBSA_DESIGNS, 0)


# ---------------------------------------------------------------------------
# gemm_bias_moments: u = P @ W + b (f32) and the moments of u in out_dtype
# ---------------------------------------------------------------------------

def gemm_bias_moments_plain(p2d: torch.Tensor, w2d: torch.Tensor,
                            b: torch.Tensor,
                            out_dtype: torch.dtype = torch.float32
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The plain PyTorch version: f32 product of the operands (exact for
    bf16 inputs) plus the bias, and the f32 moments of u rounded to
    `out_dtype` (the value the model goes on to see)."""
    u = torch.matmul(p2d.float(), w2d.float()) + b.float()
    v = u.to(out_dtype).float()
    inv_m = 1.0 / u.shape[0]
    return u, v.sum(0) * inv_m, (v * v).sum(0) * inv_m


def gemm_bias_moments_launch(p2d: torch.Tensor, w2d: torch.Tensor,
                             b: torch.Tensor,
                             out_dtype: torch.dtype = torch.float32
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The kernel on CUDA tensors (raises if it cannot launch), in the
    design `gemm_plan` picks."""
    _check_gemm_operands(p2d, w2d)
    m, k = p2d.shape
    c = w2d.shape[1]
    dev = p2d.device
    b = channel_vector("b", b, c, dev)
    in_code = DTYPE_CODES[p2d.dtype]
    sms = sm_count(dev)
    plan = gemm_plan(p2d, w2d, sms)
    parts = c_function("gemm_bias_moments",
                       "dcgan_gemm_bias_moments_parts")(m, c, in_code,
                                                        plan.splits, sms)
    u = torch.empty((m, c), dtype=torch.float32, device=dev)
    mean = torch.empty(c, dtype=torch.float32, device=dev)
    mean_sq = torch.empty(c, dtype=torch.float32, device=dev)
    # split-K partial products, and the partial moments of each row tile
    # (or row chunk): both summed in a fixed order by the kernel's finish
    ws = torch.empty((plan.splits, m, c), dtype=torch.float32,
                     device=dev) if plan.splits > 1 else None
    part = torch.empty((2, parts, c), dtype=torch.float32, device=dev)
    fn = c_function("gemm_bias_moments", "dcgan_gemm_bias_moments")
    with torch.cuda.device(dev):
        err = fn(p2d.data_ptr(), w2d.data_ptr(), b.data_ptr(), u.data_ptr(),
                 mean.data_ptr(), mean_sq.data_ptr(),
                 ws.data_ptr() if ws is not None else None, part.data_ptr(),
                 GBSA_DESIGNS[plan.design], plan.bm, plan.bn, plan.stages,
                 plan.splits, parts, m, k, c, in_code,
                 int(out_dtype == torch.bfloat16), 1.0 / m, stream_of(dev))
    check_launch("gemm_bias_moments", err)
    gemm_bias_moments.launches += 1
    gemm_bias_moments.launches_by_design[plan.design] += 1
    return u, mean, mean_sq


class _GemmBiasMoments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p2d, w2d, b, out_dtype):
        if p2d.device.type == "cpu":
            u, mean, mean_sq = gemm_bias_moments_plain(p2d, w2d, b,
                                                       out_dtype)
        else:
            u, mean, mean_sq = gemm_bias_moments_launch(p2d, w2d, b,
                                                        out_dtype)
        ctx.save_for_backward(p2d, w2d, b, u)
        return u, mean, mean_sq

    @staticmethod
    def backward(ctx, gu, g_mean, g_msq):
        # `_gbm_vjp_bwd`: d mean/du = 1/M and d mean_sq/du = 2u/M fold into
        # the GEMM cotangent; then two f32 matmuls (XLA's in JAX, outside
        # any Pallas kernel) and a column sum
        p2d, w2d, b, u = ctx.saved_tensors
        m = u.shape[0]
        du = gu.float() + (g_mean.float()[None, :]
                           + 2.0 * u * g_msq.float()[None, :]) / m
        need_p, need_w, need_b = ctx.needs_input_grad[:3]
        dp = torch.matmul(du, w2d.float().t()).to(p2d.dtype) \
            if need_p else None
        dw = torch.matmul(p2d.float().t(), du).to(w2d.dtype) \
            if need_w else None
        db = du.sum(0).to(b.dtype) if need_b else None
        return dp, dw, db, None


def gemm_bias_moments(p2d: torch.Tensor, w2d: torch.Tensor, b: torch.Tensor,
                      out_dtype: torch.dtype = torch.float32
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused pass: u = p2d @ w2d + b (f32 accumulation) together with
    the per-channel (E[v], E[v^2]) of v = u cast to `out_dtype`. Returns
    (u [M, C] float32, mean [C], mean_sq [C]); differentiable in p2d, w2d
    and b.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and raises if it cannot) in the design `gemm_plan` picks, as
    `gemm_bias_scale_act` does. `gemm_bias_moments.launches` counts
    launches, `.launches_by_design` them by design."""
    _check_gemm(p2d, w2d, out_dtype)
    return _GemmBiasMoments.apply(p2d, w2d, b, out_dtype)


gemm_bias_moments.launches = 0
gemm_bias_moments.launches_by_design = dict.fromkeys(GBSA_DESIGNS, 0)


# ---------------------------------------------------------------------------
# The fused stage: deconv ⊕ bias ⊕ BN ⊕ act
# ---------------------------------------------------------------------------

def fused_conv_bn_act(conv_params: Pytree, bn_params: Pytree,
                      bn_state: Pytree, x: torch.Tensor, *, transpose: bool,
                      kernel: int, stride: int = 2, train: bool,
                      momentum: float = 0.9, eps: float = 1e-5, act: str,
                      leak: float = LEAK,
                      compute_dtype: Optional[torch.dtype] = None,
                      quant: str = "", group=None
                      ) -> Tuple[torch.Tensor, Pytree]:
    """One G (transpose=True) or D (transpose=False) stage, conv ⊕ bias ⊕
    BN ⊕ act, returning (y NHWC, bn_state) with `batch_norm_apply`'s state
    contract.

    train=True: the gemm_bias_moments kernel, BN's batch arithmetic on the
    [C]-sized moments, then the scale_shift_act epilogue kernel; the new
    state is the EMA update, detached. train=False: the running statistics
    are known before the GEMM, so the whole stage is the single
    gemm_bias_scale_act kernel. quant="fp8" quantizes the patch matrix
    and W first. With a process `group` (synced BN,
    `dcgan_tpu/ops/pallas_fused.py:345-407`), the kernel's per-rank
    (mean, mean_sq) are averaged over its ranks before kernel 2's scale
    and shift, and kernel 4's backward (which folds 1/M and 2u/M with M
    the rank's rows) receives their cotangents all-reduced
    (parallel/collectives.py's `synced_moments`). The patch matrix lives only inside this call (and in
    autograd's graph, for dw = P^T du)."""
    cdt = compute_dtype if compute_dtype is not None else x.dtype
    w, b = conv_params["w"], conv_params["b"]
    w2d = w_to_gemm(w.to(cdt))
    p2d, (n, ho, wo) = conv_patches(x.to(cdt), kernel, stride, transpose)
    if quant == "fp8":
        p2d, w2d = fake_quant_fp8(p2d), fake_quant_fp8(w2d)
    c = w2d.shape[1]
    gamma, beta = bn_params["scale"], bn_params["bias"]
    if train:
        u, mean, mean_sq = gemm_bias_moments(p2d, w2d, b, cdt)
        mean, mean_sq = synced_moments(group, mean, mean_sq)
        mean, var, new_state = finish_batch_moments(bn_state, mean, mean_sq,
                                                    momentum=momentum)
        scale, shift = bn_scale_shift(gamma, beta, mean, var, eps)
        y2d = scale_shift_act(u.to(cdt), scale, shift, act, leak)
        return y2d.reshape(n, ho, wo, c), new_state
    scale, shift = bn_scale_shift(gamma, beta, bn_state["mean"],
                                  bn_state["var"], eps)
    y2d = gemm_bias_scale_act(p2d, w2d, b, scale, shift, act, leak, cdt)
    return y2d.reshape(n, ho, wo, c), bn_state
