"""SAGAN self-attention over the flattened spatial sequence, with the two
sequence-parallel strategies (the counterpart of
`dcgan_tpu/ops/attention.py:67-363`).

An NHWC map [B, H, W, C] flattens to a sequence of H*W positions; query and
key project to C/8 channels, value to C/2, the output back to C (1x1
convolutions written as channel matmuls), and the block returns
x + gamma * out. gamma starts at 0, so at init the block passes x through
and every gradient into q, k and v is multiplied by 0: a check of the
attention sets gamma != 0.

The rounding points are the JAX package's: q, k and v in the compute
dtype; scores, softmax and accumulation in f32; p cast to v's dtype before
the PV product; scale = 1/sqrt(d_qk / heads); the attention output cast to
v's dtype before `out`; x + gamma * out in x's dtype. Heads split the same
projections at apply time and ride the batch axis.

`use_pallas=True` routes the attention through the flash kernels
(ops/flash_attention.py); otherwise `full_attention` materializes the
[B, S, S] scores.

Under a spatial mesh each rank holds a block of the sequence (its rows of
the image, parallel/spatial.py) and `attn_apply(seq_mesh=ring)` runs one of
the JAX strategies over the ring of the model axis (parallel/collectives.py's
`GroupRing`, or a `LocalRing` of stacked blocks in one process):
- "ring" (`ring_attention`): q stays, the (k, v) blocks rotate n - 1 times
  and fold into an online softmax (running max, normalizer, accumulator);
  under `use_pallas` every fold runs the flash kernels instead
  (ops/flash_attention.py::ring_flash_attention);
- "ulysses" (`ulysses_attention`): one all_to_all trades the sequence split
  for a split of the heads, each rank attends over the whole sequence for
  its heads (flash under `use_pallas`), and one all_to_all trades back; the
  head count must divide over the axis.
The rotations and all_to_alls are autograd Functions whose backward runs
the reverse collective, as JAX's AD transposes ppermute and all_to_all.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dcgan_tpu_torch.ops.flash_attention import flash_attention, \
    ring_flash_attention
from dcgan_tpu_torch.ops.layers import linear_apply, linear_init

Pytree = dict

SUBLAYERS = ("query", "key", "value", "out")


def attn_init(gen: torch.Generator, ch: int, *,
              dtype=torch.float32) -> Pytree:
    """Parameters of one attention block over `ch`-channel maps, drawn on
    the CPU from `gen`; gamma starts at 0 (identity at init)."""
    if ch < 8:
        raise ValueError(f"attention needs >= 8 channels, got {ch}")
    return {
        "query": linear_init(gen, ch, ch // 8, dtype=dtype),
        "key": linear_init(gen, ch, ch // 8, dtype=dtype),
        "value": linear_init(gen, ch, ch // 2, dtype=dtype),
        "out": linear_init(gen, ch // 2, ch, dtype=dtype),
        "gamma": torch.zeros((), dtype=dtype),
    }


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over the whole sequence, [B, S, d] each,
    f32 out: scores and softmax in f32, p cast to v's dtype for the PV
    product, f32 sums."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float())


class _Rotate(torch.autograd.Function):
    """ring.rotate, whose backward rotates the cotangents back (the
    transpose of a ppermute)."""

    @staticmethod
    def forward(ctx, ring, *tensors):
        ctx.ring = ring
        return ring.rotate(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.ring.rotate_back(*(g.contiguous()
                                               for g in grads)))


class _AllToAll(torch.autograd.Function):
    """ring.all_to_all, whose backward is the all_to_all with the split
    and concat dims swapped."""

    @staticmethod
    def forward(ctx, ring, t, split_dim, concat_dim):
        ctx.ring, ctx.dims = ring, (split_dim, concat_dim)
        return ring.all_to_all(t, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (None, ctx.ring.all_to_all(g.contiguous(), concat_dim,
                                          split_dim), None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   ring, scale: float) -> torch.Tensor:
    """Exact attention over the ring's whole sequence for this block's q
    rows, f32 (`dcgan_tpu/ops/attention.py:105-158`): the resident (k, v)
    block folds first, then n - 1 rotated ones, each into the online
    softmax (m, l, acc) with full_attention's rounding points."""
    if ring.n == 1:
        return full_attention(q, k, v, scale=scale)
    qf = q.float()

    def fold(k_blk, v_blk, m, l, acc):
        s = torch.matmul(qf, k_blk.float().transpose(-1, -2)) * scale
        m_new = torch.maximum(m, s.amax(-1))
        # m = -inf only on the first fold's correction side, where
        # exp(-inf - finite) = 0 drops the empty accumulator
        p = torch.exp(s - m_new.unsqueeze(-1))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr.unsqueeze(-1) + torch.matmul(
            p.to(v_blk.dtype).float(), v_blk.float())
        return m_new, l, acc

    b, s_loc, _ = q.shape
    m = torch.full((b, s_loc), -torch.inf, device=q.device)
    l = torch.zeros((b, s_loc), device=q.device)
    acc = torch.zeros((b, s_loc, v.shape[-1]), device=q.device)
    m, l, acc = fold(k, v, m, l, acc)
    k_blk, v_blk = k, v
    for _ in range(ring.n - 1):
        k_blk, v_blk = _Rotate.apply(ring, k_blk, v_blk)
        m, l, acc = fold(k_blk, v_blk, m, l, acc)
    return acc / l.unsqueeze(-1)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      ring, num_heads: int, scale: float,
                      use_pallas: bool = False) -> torch.Tensor:
    """All-to-all sequence parallelism (`dcgan_tpu/ops/attention.py:
    161-211`): [B, S_local, h * d] blocks -> all_to_all to [B, S, h / n, d]
    -> attention over the whole sequence per head (flash under
    use_pallas) -> cast to v's dtype -> all_to_all back to
    [B, S_local, h * dv]."""
    n = ring.n
    if num_heads % n:
        raise ValueError(
            f"ulysses needs num_heads ({num_heads}) divisible by the "
            f"sequence-parallel axis ({n}); use the ring strategy "
            "or adjust attn_heads")
    b, s_loc, _ = q.shape

    def to_heads(t):
        t = t.reshape(b, s_loc, num_heads, t.shape[-1] // num_heads)
        return _AllToAll.apply(ring, t, 2, 1)

    qh, kh, vh = to_heads(q), to_heads(k), to_heads(v)
    s = s_loc * n
    h_loc = num_heads // n

    def fold(t):   # heads into the batch for the local attention
        return t.permute(0, 2, 1, 3).reshape(b * h_loc, s, t.shape[-1])

    if use_pallas:
        out = flash_attention(fold(qh), fold(kh), fold(vh), scale)
    else:
        out = full_attention(fold(qh), fold(kh), fold(vh), scale=scale)
    # the f32 sums stay local: the return trip moves v's dtype
    out = out.to(v.dtype).reshape(b, h_loc, s, -1).permute(0, 2, 1, 3)
    out = _AllToAll.apply(ring, out.contiguous(), 1, 2)
    return out.reshape(b, s_loc, -1)


def _project(params: Pytree, x: torch.Tensor, cdt
             ) -> Tuple[torch.Tensor, ...]:
    return tuple(linear_apply(params[name], x, compute_dtype=cdt)
                 for name in ("query", "key", "value"))


def _split_heads(t: torch.Tensor, h: int) -> torch.Tensor:
    """[B, S, h*d] -> [B*h, S, d] (heads ride the batch axis)."""
    b, s, d = t.shape
    return t.reshape(b, s, h, d // h).permute(0, 2, 1, 3) \
        .reshape(b * h, s, d // h)


def _merge_heads(t: torch.Tensor, h: int) -> torch.Tensor:
    """[B*h, S, d] -> [B, S, h*d]."""
    bh, s, d = t.shape
    return t.reshape(bh // h, h, s, d).permute(0, 2, 1, 3) \
        .reshape(bh // h, s, h * d)


def attn_apply(params: Pytree, x: torch.Tensor, *,
               compute_dtype: Optional[torch.dtype] = None,
               num_heads: int = 1, seq_mesh=None, seq_axis: str = "model",
               batch_axis: str = "data", seq_strategy: str = "ring",
               use_pallas: bool = False) -> torch.Tensor:
    """x [B, H, W, C] -> x + gamma * attention(x), same shape and dtype.

    seq_mesh: None, or the ring over the sequence's blocks when the map
    is split by rows (a `GroupRing` over the ranks of the `seq_axis`
    within one `batch_axis` index, whose names JAX's signature keeps, or
    a `LocalRing`): x is then this block's rows and the attention runs
    as `seq_strategy` ("ring" or "ulysses") over the whole sequence."""
    b, hh, ww, c = x.shape
    seq = x.reshape(b, hh * ww, c)
    q, k, v = _project(params, seq, compute_dtype)
    if num_heads > 1 and (q.shape[-1] % num_heads
                          or v.shape[-1] % num_heads):
        raise ValueError(
            f"num_heads={num_heads} does not divide the projection dims "
            f"(qk {q.shape[-1]}, v {v.shape[-1]})")
    scale = 1.0 / ((q.shape[-1] // num_heads) ** 0.5)
    seq_parallel = seq_mesh is not None and seq_mesh.n > 1
    if seq_parallel and seq_strategy not in ("ring", "ulysses"):
        raise ValueError(f"unknown seq_strategy {seq_strategy!r}")
    if seq_parallel and seq_strategy == "ulysses":
        # heads stay unsplit: the all_to_all is the head split
        out = ulysses_attention(q, k, v, ring=seq_mesh, num_heads=num_heads,
                                scale=scale, use_pallas=use_pallas)
    else:
        if num_heads > 1:
            q, k, v = (_split_heads(t, num_heads) for t in (q, k, v))
        if seq_parallel and use_pallas:
            out = ring_flash_attention(q, k, v, scale=scale, ring=seq_mesh)
        elif seq_parallel:
            out = ring_attention(q, k, v, ring=seq_mesh, scale=scale)
        elif use_pallas:
            out = flash_attention(q, k, v, scale)
        else:
            out = full_attention(q, k, v, scale=scale)
        if num_heads > 1:
            out = _merge_heads(out, num_heads)
    out = linear_apply(params["out"], out.to(v.dtype),
                       compute_dtype=compute_dtype)
    gamma = params["gamma"].to(x.dtype)
    return x + gamma * out.reshape(b, hh, ww, c).to(x.dtype)
