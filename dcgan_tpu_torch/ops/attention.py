"""SAGAN self-attention over the flattened spatial sequence (the
counterpart of `dcgan_tpu/ops/attention.py:67-103, 214-363`).

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
[B, S, S] scores. The sequence-parallel strategies (ring, ulysses) need a
device mesh, which the port does not have yet: a `seq_mesh` raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dcgan_tpu_torch.ops.flash_attention import flash_attention
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
               num_heads: int = 1, use_pallas: bool = False,
               seq_mesh=None) -> torch.Tensor:
    """x [B, H, W, C] -> x + gamma * attention(x), same shape and dtype."""
    if seq_mesh is not None:
        raise NotImplementedError(
            "sequence-parallel attention (ring/ulysses over a device mesh) "
            "is not ported to dcgan_tpu_torch yet (ROADMAP Queue A item 7, "
            "Queue B item 9)")
    b, hh, ww, c = x.shape
    seq = x.reshape(b, hh * ww, c)
    q, k, v = _project(params, seq, compute_dtype)
    if num_heads > 1 and (q.shape[-1] % num_heads
                          or v.shape[-1] % num_heads):
        raise ValueError(
            f"num_heads={num_heads} does not divide the projection dims "
            f"(qk {q.shape[-1]}, v {v.shape[-1]})")
    scale = 1.0 / ((q.shape[-1] // num_heads) ** 0.5)
    if num_heads > 1:
        q, k, v = (_split_heads(t, num_heads) for t in (q, k, v))
    if use_pallas:
        out = flash_attention(q, k, v, scale)
    else:
        out = full_attention(q, k, v, scale=scale)
    if num_heads > 1:
        out = _merge_heads(out, num_heads)
    out = linear_apply(params["out"], out.to(v.dtype),
                       compute_dtype=compute_dtype)
    gamma = params["gamma"].to(x.dtype)
    return x + gamma * out.reshape(b, hh, ww, c).to(x.dtype)
