"""The sequence-parallel attention of the port against the JAX package's on
the CPU: kernels 7 and 8 with f32 gradient outputs, and the three
strategies over a ring of n blocks.

- `flash_dq` and `flash_dkv` with `out_dtype=torch.float32` (their plain
  versions here) against JAX `_bwd_core(..., grad_dtype=jnp.float32)` in
  interpret mode, on bf16 operands: the same f32 sums, never rounded to
  bf16; within 1e-5 x the output's largest value (summation order).
- `ring_attention`, `ulysses_attention` and ring x flash
  (`ring_flash_attention` on the plain kernels) over a `LocalRing` of n
  = 2 and 4 blocks (the n shards stacked in one process) against JAX's
  `ring_attention`, `ulysses_attention` and `ring_flash_attention` under
  `shard_map` over n of conftest's 8 virtual CPU devices, the sequence
  split over the "model" axis: the output and the gradients of q, k and
  v under one cotangent, in f32 and bf16, with 1 and 2 heads (the ring
  strategies take heads folded into the batch, as attn_apply splits
  them; Ulysses splits them itself, and where the heads do not divide
  over the blocks both refuse with the same message; Ulysses also at 4
  heads over 4 blocks). f32 within 1e-5 x the largest value
  of each result (summation order); bf16 within 2^-7 x that value, one
  bf16 ulp of it (the two sides may round one p, ds or gradient element
  to neighbouring bf16 values).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from dcgan_tpu.ops import attention as jattn
from dcgan_tpu.ops import pallas_attention as jpa
from dcgan_tpu.utils.backend import shard_map
from dcgan_tpu_torch.ops import attention as tattn
from dcgan_tpu_torch.ops import flash_attention as tflash
from dcgan_tpu_torch.parallel.collectives import LocalRing
from torch_jax_draws import one_torch_thread  # noqa: F401

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# (B, S, d_qk per head, d_v per head)
SHAPE = (2, 32, 4, 8)


def _tol(dtype: str, ref: np.ndarray) -> float:
    top = float(np.abs(ref).max(initial=0.0))
    return (2.0 ** -7 if dtype == "bfloat16" else 1e-5) * top + 1e-6


def _close(name, got, ref, dtype):
    got = np.asarray(got, dtype=np.float32)
    ref = np.asarray(ref, dtype=np.float32)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    err = float(np.abs(got - ref).max(initial=0.0))
    assert err <= _tol(dtype, ref), (name, err, _tol(dtype, ref))


def _inputs(heads, seed=0):
    b, s, dk, dv = SHAPE
    rng = np.random.default_rng(seed)
    q, k = (rng.normal(size=(b, s, heads * dk)).astype(np.float32)
            for _ in range(2))
    v = rng.normal(size=(b, s, heads * dv)).astype(np.float32)
    g = rng.normal(size=(b, s, heads * dv)).astype(np.float32)
    return q, k, v, g


def _jax_strategy(strategy, n, heads, scale):
    """The JAX strategy under shard_map over n devices, on [B, S, h * d]
    arrays (the ring strategies' heads folded into the batch)."""
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("model",))
    spec = P(None, "model", None)
    if strategy == "ulysses":
        fn = functools.partial(jattn.ulysses_attention, axis_name="model",
                               n_shards=n, num_heads=heads, scale=scale)
        return shard_map(fn, mesh=mesh, in_specs=(spec,) * 3,
                         out_specs=spec)
    if strategy == "ring":
        fn = functools.partial(jattn.ring_attention, axis_name="model",
                               n_shards=n, scale=scale)
        check = True
    else:
        fn = functools.partial(jpa.ring_flash_attention, scale=scale,
                               axis_name="model", n_shards=n)
        check = False   # pallas outputs carry no vma annotations
    ring = shard_map(fn, mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
                     check=check)

    def split(q, k, v):
        q, k, v = (jattn._split_heads(t, heads) for t in (q, k, v))
        return jattn._merge_heads(ring(q, k, v), heads)
    return split


def _torch_strategy(strategy, ring, heads, scale):
    if strategy == "ulysses":
        return functools.partial(tattn.ulysses_attention, ring=ring,
                                 num_heads=heads, scale=scale)
    if strategy == "ring":
        fn = functools.partial(tattn.ring_attention, ring=ring, scale=scale)
    else:
        fn = functools.partial(tflash.ring_flash_attention, scale=scale,
                               ring=ring)

    def split(q, k, v):
        q, k, v = (tattn._split_heads(t, heads) for t in (q, k, v))
        return tattn._merge_heads(fn(q, k, v), heads)
    return split


def _check_strategy(strategy, dtype, n, heads):
    tdt, jdt = DTYPES[dtype]
    q, k, v, g = _inputs(heads)
    scale = SHAPE[2] ** -0.5
    jfn = _jax_strategy(strategy, n, heads, scale)
    jq, jk, jv = (jnp.asarray(t).astype(jdt) for t in (q, k, v))
    ring = LocalRing(n)
    tq, tk, tv = (ring.stack(torch.from_numpy(t).to(tdt))
                  .requires_grad_(True) for t in (q, k, v))
    tfn = _torch_strategy(strategy, ring, heads, scale)
    if strategy == "ulysses" and heads % n:
        with pytest.raises(ValueError) as want:
            jfn(jq, jk, jv)
        with pytest.raises(ValueError) as got:
            tfn(tq, tk, tv)
        assert str(got.value) == str(want.value)
        return
    @jax.jit
    def forward_and_grads(a, b, c, cot):
        out, vjp = jax.vjp(lambda x, y, z: jfn(x, y, z).astype(jnp.float32),
                           a, b, c)
        return out, vjp(cot)

    jout, jgrads = forward_and_grads(jq, jk, jv, jnp.asarray(g))
    out = tfn(tq, tk, tv)
    out.float().backward(ring.stack(torch.from_numpy(g)))
    _close("out", ring.unstack(out.detach()).float().numpy(),
           jax.device_get(jout), dtype)
    for name, t, jg in zip("qkv", (tq, tk, tv), jgrads):
        assert t.grad.dtype == tdt, (name, t.grad.dtype)
        _close(f"d{name}", ring.unstack(t.grad).float().numpy(),
               np.asarray(jg.astype(jnp.float32)), dtype)


@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("strategy", ["ring", "ulysses", "ring_flash"])
def test_strategy_matches_jax(strategy, dtype, n, heads):
    _check_strategy(strategy, dtype, n, heads)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ulysses_four_heads_over_four_blocks_matches_jax(dtype):
    _check_strategy("ulysses", dtype, 4, 4)


def _bwd_inputs(shape, dtype, seed=1):
    b, s, dk, dv = shape
    rng = np.random.default_rng(seed)
    q, k = (rng.normal(size=(b, s, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.normal(size=(b, s, dv)).astype(np.float32)
    g = rng.normal(size=(b, s, dv)).astype(np.float32)
    jdt = DTYPES[dtype][1]
    jq, jk, jv = (jnp.asarray(t).astype(jdt) for t in (q, k, v))
    scale = dk ** -0.5
    out, lse = jpa._fwd_impl(jq, jk, jv, scale)
    return (jq, jk, jv), jnp.asarray(g), out, lse, scale


@pytest.mark.parametrize("shape,dtype", [
    ((2, 64, 8, 16), "bfloat16"), ((3, 100, 16, 32), "bfloat16"),
    ((2, 64, 8, 16), "float32")])
def test_f32_gradient_outputs_match_bwd_core(shape, dtype):
    """The plain flash_dq and flash_dkv with out_dtype=float32 against
    JAX's _bwd_core(grad_dtype=jnp.float32) (interpret mode) on the same
    operands, lse and cotangent."""
    (jq, jk, jv), g, out, lse, scale = _bwd_inputs(shape, dtype)
    do, delta, lse_r, delta_r = jpa._bwd_stats(jq, out, lse, g)
    want = jpa._bwd_core(scale, jq, jk, jv, do, lse, delta, lse_r, delta_r,
                         grad_dtype=jnp.float32)
    tdt = DTYPES[dtype][0]
    tq, tk, tv, tdo = (torch.from_numpy(np.array(t.astype(jnp.float32)))
                       .to(tdt) for t in (jq, jk, jv, do))
    tlse = torch.from_numpy(np.asarray(lse))[..., 0]
    tdelta = torch.from_numpy(np.asarray(delta))[..., 0]
    args = (tq, tk, tv, tdo, tlse, tdelta, scale)
    dq = tflash.flash_dq(*args, out_dtype=torch.float32)
    dk, dv = tflash.flash_dkv(*args, out_dtype=torch.float32)
    for name, got, w in (("dq", dq, want[0]), ("dk", dk, want[1]),
                         ("dv", dv, want[2])):
        assert got.dtype == torch.float32 and w.dtype == jnp.float32
        w = np.asarray(w)
        err = float(np.abs(got.numpy() - w).max())
        assert err <= 1e-5 * float(np.abs(w).max()) + 1e-6, (name, err)


def test_f32_outputs_are_not_rounded_to_bf16():
    """From bf16 operands the f32 gradients keep bits a bf16 rounding
    drops: the default outputs are the f32 ones rounded to bf16."""
    (jq, jk, jv), g, out, lse, scale = _bwd_inputs((2, 64, 8, 16),
                                                   "bfloat16")
    do, delta, _, _ = jpa._bwd_stats(jq, out, lse, g)
    args = tuple(torch.from_numpy(np.asarray(t.astype(jnp.float32)))
                 .to(torch.bfloat16) for t in (jq, jk, jv, do)) + (
        torch.from_numpy(np.asarray(lse))[..., 0],
        torch.from_numpy(np.asarray(delta))[..., 0], scale)
    f32 = tflash.flash_dq(*args, out_dtype=torch.float32)
    bf16 = tflash.flash_dq(*args)
    assert bf16.dtype == torch.bfloat16
    assert torch.equal(f32.to(torch.bfloat16), bf16)
    assert not torch.equal(f32, bf16.float())
    dk32, dv32 = tflash.flash_dkv(*args, out_dtype=torch.float32)
    dk16, dv16 = tflash.flash_dkv(*args)
    assert torch.equal(dk32.to(torch.bfloat16), dk16)
    assert torch.equal(dv32.to(torch.bfloat16), dv16)
