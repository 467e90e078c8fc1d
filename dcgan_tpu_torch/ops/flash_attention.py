"""Flash attention: the forward, dq and dkv kernels and their wrappers, and
ring x flash over them (the counterpart of
`dcgan_tpu/ops/pallas_attention.py:123-443`).

`flash_attention(q, k, v, scale)` is softmax(q k^T * scale) v over [B, S, d]
blocks, returned in f32, without an [S, S] score matrix in device memory.
It is a `torch.autograd.Function` whose forward saves (q, k, v, out, lse)
and whose backward runs, as the JAX `_bwd_impl` does, `bwd_stats` (delta =
sum(g * out) in f32 and the cotangent cast to q's dtype once, plain torch
as XLA runs it in JAX), then the dq kernel, then the dkv kernel.

- `flash_fwd(q, k, v, scale)` -> (out f32 [B, S, dv], lse f32 [B, S]):
  `csrc/flash_attention.cu`'s forward, replacing `_fwd_kernel`;
- `flash_dq(q, k, v, do, lse, delta, scale)` -> dq in q's dtype, replacing
  `_dq_kernel`;
- `flash_dkv(...)` -> (dk, dv) in k's and v's dtypes, replacing
  `_dkv_kernel`;
- `out_dtype=torch.float32` asks dq and dkv for f32 gradients from bf16
  operands, the accumulators written without a bf16 rounding (`_bwd_core`'s
  `grad_dtype`, which the ring backward passes).

`ring_flash_attention(q, k, v, scale=, ring=)` is exact attention over a
sequence split into n blocks around a ring (`pallas_attention.py:351-443`):
each rank's q stays, the (k, v) blocks rotate, and every hop's fold runs the
flash kernels. The forward runs `flash_fwd` on the resident block and then
on each of the n - 1 rotated ones, merging the normalized partials in f32:
lse = logaddexp(lse, lse_b), out = out * e^(lse_old - lse) + out_b *
e^(lse_b - lse). The backward computes `bwd_stats` once against the global
lse, then takes n hops of `flash_dq` and `flash_dkv` with f32 outputs: dq
sums on the rank, the f32 (dk, dv) sums travel with their blocks and are
home after the full cycle, and each gradient is cast to its operand's
dtype at the end. `ring` is parallel/collectives.py's `GroupRing` (one
block per rank, `lax.ppermute`'s ring) or `LocalRing` (the n blocks
stacked along dim 0 in one process, each hop one launch over all of them).

Precision policy (the JAX one): the products take the operands in their
dtype (bf16 on the sagan64 path, f32 in the f32 tests) and accumulate in
f32; scores, the softmax statistics and every accumulator are f32; p and
ds are cast to the operand dtype before the products that consume them.
Each `*_plain` function is the same function in plain PyTorch, written as
the single-k-block form of the TPU kernel (what it computes at S <= 1024,
where its k-tile spans the sequence).

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises. Each wrapper counts its launches in
`.launches`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from dcgan_tpu_torch.ops.kernels import DTYPE_CODES, c_function, \
    check_launch, stream_of

# the widest heads the kernels take (csrc/flash_attention.cu)
MAX_DK = 64
MAX_DV = 128


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """(q . k^T in f32) * scale: products of the operands as they are
    (exact in f32 for bf16 operands), sums in f32."""
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale


def _mm(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype
        ) -> torch.Tensor:
    """a @ b with both operands rounded to `dtype` first, f32 sums."""
    return torch.matmul(a.to(dtype).float(), b.to(dtype).float())


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out f32 [B, S, dv], lse f32 [B, S]): m = row max of the scores,
    p = exp(s - m) in f32, l = sum of the f32 p, out = (p in v's dtype) . v
    / l, lse = m + log l."""
    s = _scores(q, k, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    out = _mm(p, v, v.dtype) / l
    return out, (m + torch.log(l)).squeeze(-1)


def _probs_and_ds(q, k, v, do, lse, delta, scale):
    p = torch.exp(_scores(q, k, scale) - lse.unsqueeze(-1))
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta.unsqueeze(-1))


def flash_dq_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                   scale: float, out_dtype: Optional[torch.dtype] = None
                   ) -> torch.Tensor:
    """dq = ((ds in q's dtype) . k) * scale, ds = p * (do . v^T - delta),
    p = exp(s - lse); returned in `out_dtype` (q's dtype by default)."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, scale)
    return (_mm(ds, k, q.dtype) * scale).to(out_dtype or q.dtype)


def flash_dkv_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                    scale: float, out_dtype: Optional[torch.dtype] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk = ((ds in k's dtype)^T . q) * scale and dv = (p in v's dtype)^T
    . do, in `out_dtype` (k's and v's dtypes by default)."""
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, scale)
    dk = _mm(ds.transpose(-1, -2), q, k.dtype) * scale
    dv = _mm(p.transpose(-1, -2), do, v.dtype)
    return dk.to(out_dtype or k.dtype), dv.to(out_dtype or v.dtype)


def kernel_error_bounds(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, lse: torch.Tensor,
                        delta: torch.Tensor, scale: float
                        ) -> Dict[str, torch.Tensor]:
    """Elementwise bounds on |kernel - plain| for "out", "dq", "dk" and
    "dv" on these inputs: a share of the summed magnitudes of the products
    each output sums. bf16: 2^-8, since the kernel and the plain version
    round each p or ds to bf16 at a different point (the forward's p at
    another running max); f32: 2e-5, summation order only. A bf16 output
    may also round to a neighbour: callers add one bf16 ulp of the value."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    p = torch.exp(_scores(qf, kf, scale) - lse.unsqueeze(-1))
    ds = (p * (torch.matmul(dof, vf.transpose(-1, -2))
               - delta.unsqueeze(-1))).abs()
    mags = {"out": torch.matmul(p, vf.abs()),
            "dq": torch.matmul(ds, kf.abs()) * scale,
            "dk": torch.matmul(ds.transpose(-1, -2), qf.abs()) * scale,
            "dv": torch.matmul(p.transpose(-1, -2), dof.abs())}
    share = 2.0 ** -8 + 1e-5 if q.dtype == torch.bfloat16 else 2e-5
    return {name: share * m + 1e-6 for name, m in mags.items()}


def bwd_stats(q: torch.Tensor, out: torch.Tensor, g: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(do, delta): the f32 cotangent g of out cast to q's dtype once, and
    delta = sum(g * out) over the value axis in f32 ([B, S])."""
    return g.to(q.dtype), (g.float() * out).sum(-1)


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dim() != 3:
            raise ValueError(f"{name} must be [B, S, d], got "
                             f"{tuple(t.shape)}")
        if t.dtype not in DTYPE_CODES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; q is "
                             f"{q.dtype} on {q.device}")
    b, s, dk = q.shape
    if tuple(k.shape) != (b, s, dk) or tuple(v.shape[:2]) != (b, s):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not form [B, S, d]")
    if not (1 <= dk <= MAX_DK and 1 <= v.shape[2] <= MAX_DV):
        raise ValueError(f"the kernels take d_qk <= {MAX_DK} and d_v <= "
                         f"{MAX_DV}, got {dk} and {v.shape[2]}")
    if b * s == 0:
        raise ValueError("empty attention input")


def _check_like(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype \
            or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} "
                         f"{tuple(shape)} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _dims(q, v):
    b, s, dk = q.shape
    return b, s, dk, v.shape[2], DTYPE_CODES[q.dtype]


def _out_dtype(q: torch.Tensor, out_dtype: Optional[torch.dtype]
               ) -> torch.dtype:
    """The gradients' dtype: q's, or f32 (from bf16 operands too)."""
    out = out_dtype or q.dtype
    if out not in (q.dtype, torch.float32):
        raise ValueError(f"the gradients come in the operands' dtype "
                         f"({q.dtype}) or float32, not {out}")
    return out


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out f32 [B, S, dv], lse f32 [B, S]). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (and raises if it cannot).
    `flash_fwd.launches` counts launches."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, scale)
    _check_qkv(q, k, v)
    b, s, dk, dv, code = _dims(q, v)
    out = torch.empty((b, s, dv), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, s), dtype=torch.float32, device=q.device)
    fn = c_function("flash_attention", "dcgan_flash_fwd")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), b, s, dk, dv, code, float(scale),
                 stream_of(q.device))
    check_launch("flash_fwd", err)
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def _check_bwd_inputs(q, k, v, do, lse, delta):
    _check_qkv(q, k, v)
    b, s, _ = q.shape
    _check_like("do", do, v.shape, q.dtype, q.device)
    _check_like("lse", lse, (b, s), torch.float32, q.device)
    _check_like("delta", delta, (b, s), torch.float32, q.device)


def flash_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
             scale: float, out_dtype: Optional[torch.dtype] = None
             ) -> torch.Tensor:
    """dq in `out_dtype` (q's dtype, or f32) from the saved lse and delta.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and raises if it cannot). `flash_dq.launches` counts launches."""
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, do, lse, delta, scale,
                              _out_dtype(q, out_dtype))
    _check_bwd_inputs(q, k, v, do, lse, delta)
    out = _out_dtype(q, out_dtype)
    b, s, dk, dv, code = _dims(q, v)
    dq = torch.empty_like(q, dtype=out)
    fn = c_function("flash_attention", "dcgan_flash_dq")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, s, dk,
                 dv, code, DTYPE_CODES[out], float(scale),
                 stream_of(q.device))
    check_launch("flash_dq", err)
    flash_dq.launches += 1
    return dq


flash_dq.launches = 0


def flash_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
              scale: float, out_dtype: Optional[torch.dtype] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) in `out_dtype` (k's and v's dtypes, or f32). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (and raises
    if it cannot). `flash_dkv.launches` counts launches."""
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, do, lse, delta, scale,
                               _out_dtype(q, out_dtype))
    _check_bwd_inputs(q, k, v, do, lse, delta)
    out = _out_dtype(q, out_dtype)
    b, s, dk, dv, code = _dims(q, v)
    dk_out = torch.empty_like(k, dtype=out)
    dv_out = torch.empty_like(v, dtype=out)
    fn = c_function("flash_attention", "dcgan_flash_dkv")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dk_out.data_ptr(),
                 dv_out.data_ptr(), b, s, dk, dv, code, DTYPE_CODES[out],
                 float(scale), stream_of(q.device))
    check_launch("flash_dkv", err)
    flash_dkv.launches += 1
    return dk_out, dv_out


flash_dkv.launches = 0


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        do, delta = bwd_stats(q, out, g)
        dq = flash_dq(q, k, v, do, lse, delta, ctx.scale)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over [B, S, d] blocks, f32 [B, S, dv];
    differentiable in q, k and v (q, k, v of one dtype)."""
    if q.dim() != 3:
        raise ValueError(f"q must be [B, S, d], got {tuple(q.shape)}")
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), scale)


# ---------------------------------------------------------------------------
# Ring x flash
# ---------------------------------------------------------------------------

def ring_flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float, ring) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """(out f32, lse f32) over the whole ring: the resident block's
    `flash_fwd`, then n - 1 hops that rotate (k, v) and merge each block's
    normalized partial (`_ring_flash_fwd_pass`)."""
    out, lse = flash_fwd(q, k, v, scale)
    k_blk, v_blk = k, v
    for _ in range(ring.n - 1):
        k_blk, v_blk = ring.rotate(k_blk, v_blk)
        out_b, lse_b = flash_fwd(q, k_blk, v_blk, scale)
        lse_new = torch.logaddexp(lse, lse_b)
        out = (out * torch.exp(lse - lse_new).unsqueeze(-1)
               + out_b * torch.exp(lse_b - lse_new).unsqueeze(-1))
        lse = lse_new
    return out, lse


def ring_flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        g: torch.Tensor, scale: float, ring
                        ) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv) in the operands' dtypes (`_ring_flash_vjp_bwd`): the
    hop-invariant stats once, against the global lse, then n hops of the
    dq and dkv kernels with f32 outputs; (k, v) and their f32 gradient
    sums rotate together and are home after the n-th rotation."""
    do, delta = bwd_stats(q, out, g)
    f32 = torch.float32
    dq = torch.zeros(q.shape, dtype=f32, device=q.device)
    dk_c = torch.zeros(k.shape, dtype=f32, device=k.device)
    dv_c = torch.zeros(v.shape, dtype=f32, device=v.device)
    k_blk, v_blk = k, v
    for hop in range(ring.n):
        dq += flash_dq(q, k_blk, v_blk, do, lse, delta, scale, out_dtype=f32)
        dk_h, dv_h = flash_dkv(q, k_blk, v_blk, do, lse, delta, scale,
                               out_dtype=f32)
        dk_c += dk_h
        dv_c += dv_h
        if hop < ring.n - 1:
            k_blk, v_blk, dk_c, dv_c = ring.rotate(k_blk, v_blk, dk_c, dv_c)
        else:   # the blocks themselves are not needed at home
            dk_c, dv_c = ring.rotate(dk_c, dv_c)
    return dq.to(q.dtype), dk_c.to(k.dtype), dv_c.to(v.dtype)


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, ring):
        out, lse = ring_flash_forward(q, k, v, scale, ring)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.ring = scale, ring
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ring_flash_backward(q, k, v, out, lse,
                                         g.contiguous(), ctx.scale, ctx.ring)
        return dq, dk, dv, None, None


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: float, ring) -> torch.Tensor:
    """Exact attention over the ring's whole sequence, f32 [B, S_local,
    dv] for the rank's (or, over a LocalRing, every stacked shard's) q
    rows, every hop's fold on the flash kernels; differentiable in q, k
    and v. `ring.n == 1` is `flash_attention`."""
    if ring.n == 1:
        return flash_attention(q, k, v, scale)
    if q.dim() != 3:
        raise ValueError(f"q must be [B, S, d], got {tuple(q.shape)}")
    return _RingFlash.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                            scale, ring)
