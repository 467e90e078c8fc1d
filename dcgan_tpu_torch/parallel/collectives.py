"""The cross-rank reductions of the data-parallel step: the port's form of
the JAX step's `lax.pmean`s (`dcgan_tpu/train/steps.py:298-401`,
`ops/norm.py:170-172`, `ops/pallas_fused.py:379-381`), its sample gather
(`parallel/shard_map_backend.py:221-235`) and the global histograms'
pmin, pmax and psum (`utils/metrics.py:184-189`).

Every function takes the process group first; with None (a process that
named no world) it returns its input, and at world size 1 the collective
runs and leaves the bits as they are (a sum of one term, divided by 1).
A mean is the JAX one: the sum over ranks, then a division by the rank
count. A gradient tree is averaged as one flat buffer per dtype, one
all_reduce per net and dtype, not one per leaf.

`synced_moments` is the BatchNorm moments' mean over ranks as an
autograd Function. Its backward all-reduces the moments' cotangents and
divides by the rank count: each rank's moments feed every rank's loss,
so the gradient through its own moments is the mean of every rank's
cotangent (JAX's AD through `lax.pmean`). Without it each rank would
train on its own cotangent only, and nothing would fail.

gloo on CUDA tensors: where this torch's gloo refuses a CUDA tensor, the
collective stages it through host memory (`STAGED["host"]` counts those
calls) and says so once on stderr; NCCL never stages.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence

import torch

Pytree = dict

# collectives issued by this process, by kind (the step's census), and
# those staged through host memory (gloo on CUDA tensors)
COUNTS: Dict[str, int] = {"all_reduce": 0, "all_gather": 0}
STAGED: Dict[str, int] = {"host": 0}
_GLOO_CUDA: Dict[object, bool] = {}


def world_size(group) -> int:
    if group is None:
        return 1
    import torch.distributed as dist

    return dist.get_world_size(group)


def capturable(group) -> bool:
    """Whether a CUDA graph can capture this group's collectives: NCCL's
    can (their communicator formed before the capture), gloo's cannot."""
    return group is None or _backend(group) == "nccl"


def _backend(group) -> str:
    import torch.distributed as dist

    return str(dist.get_backend(group))


def _gloo_takes_cuda(group, t: torch.Tensor) -> bool:
    """Whether gloo runs this collective on the CUDA tensor itself; probed
    once per group with a one-element all_reduce (every rank runs the same
    torch, so every rank takes the same branch)."""
    if group not in _GLOO_CUDA:
        import torch.distributed as dist

        try:
            dist.all_reduce(torch.zeros(1, device=t.device), group=group)
            _GLOO_CUDA[group] = True
        except RuntimeError as e:
            _GLOO_CUDA[group] = False
            print(f"[dcgan_tpu_torch] gloo refuses CUDA tensors ({e!s:.80}); "
                  f"collectives stage through host memory", file=sys.stderr,
                  flush=True)
    return _GLOO_CUDA[group]


def _staged(group, t: torch.Tensor) -> bool:
    return t.device.type == "cuda" and _backend(group) == "gloo" \
        and not _gloo_takes_cuda(group, t)


def all_reduce_sum_(group, t: torch.Tensor) -> torch.Tensor:
    """Sum `t` over the ranks in place; returns it."""
    if group is None:
        return t
    import torch.distributed as dist

    COUNTS["all_reduce"] += 1
    if _staged(group, t):
        STAGED["host"] += 1
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
        return t
    dist.all_reduce(t, group=group)
    return t


def mean_over(group, t: torch.Tensor) -> torch.Tensor:
    """The mean of `t` over the ranks (a new tensor; `t` itself without
    a group)."""
    if group is None:
        return t
    return all_reduce_sum_(group, t.clone()) / world_size(group)


def mean_scalars(group, values: Sequence[torch.Tensor]
                 ) -> List[torch.Tensor]:
    """Each 0-d tensor's mean over the ranks, in one all_reduce."""
    if group is None:
        return list(values)
    stacked = torch.stack([v.detach().float() for v in values])
    out = all_reduce_sum_(group, stacked) / world_size(group)
    return [o.to(v.dtype) for o, v in zip(out.unbind(), values)]


def mean_tree(group, tree: Pytree) -> Pytree:
    """The mean over the ranks of every leaf of a nested dict of tensors:
    the leaves of each dtype packed into one flat buffer, one all_reduce
    per dtype, unpacked in place of the leaves."""
    if group is None:
        return tree
    from dcgan_tpu_torch.train.steps import tree_leaves, tree_unflatten

    leaves = tree_leaves(tree)
    n = world_size(group)
    out: List[Optional[torch.Tensor]] = [None] * len(leaves)
    for dtype in sorted({leaf.dtype for leaf in leaves}, key=str):
        idx = [i for i, leaf in enumerate(leaves) if leaf.dtype == dtype]
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        flat = all_reduce_sum_(group, flat) / n
        for i, part in zip(idx, flat.split([leaves[i].numel()
                                            for i in idx])):
            out[i] = part.view(leaves[i].shape)
    return tree_unflatten(tree, out)


def gather_rows(group, t: torch.Tensor) -> torch.Tensor:
    """Every rank's `t` stacked along dim 0 in rank order (the sample
    gather)."""
    if group is None:
        return t
    import torch.distributed as dist

    n = world_size(group)
    COUNTS["all_gather"] += 1
    src = t.contiguous()
    if _staged(group, src):
        STAGED["host"] += 1
        parts = [torch.empty_like(src, device="cpu") for _ in range(n)]
        dist.all_gather(parts, src.cpu(), group=group)
        return torch.cat(parts).to(t.device)
    if _backend(group) == "nccl":
        out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=group)
        return out
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts)


def min_max(group, lo: torch.Tensor, hi: torch.Tensor):
    """(the min of `lo`, the max of `hi`) over the ranks, in one
    all_reduce: the max of (-lo, hi) is taken as a sum-free MAX."""
    if group is None:
        return lo, hi
    import torch.distributed as dist

    both = torch.stack([-lo.float(), hi.float()])
    COUNTS["all_reduce"] += 1
    if _staged(group, both):
        STAGED["host"] += 1
        host = both.cpu()
        dist.all_reduce(host, op=dist.ReduceOp.MAX, group=group)
        both = host.to(both.device)
    else:
        dist.all_reduce(both, op=dist.ReduceOp.MAX, group=group)
    return (-both[0]).to(lo.dtype), both[1].to(hi.dtype)


class _SyncedMoments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, mean, mean_sq):
        ctx.group = group
        both = torch.stack([mean.float(), mean_sq.float()])
        both = all_reduce_sum_(group, both) / world_size(group)
        return both[0], both[1]

    @staticmethod
    def backward(ctx, g_mean, g_msq):
        both = torch.stack([g_mean.float(), g_msq.float()])
        both = all_reduce_sum_(ctx.group, both) / world_size(ctx.group)
        return None, both[0], both[1]


def synced_moments(group, mean: torch.Tensor, mean_sq: torch.Tensor):
    """(mean, mean_sq) averaged over the ranks, differentiable: the
    backward all-reduces the cotangents (see the module docstring).
    Without a group, the moments themselves."""
    if group is None:
        return mean, mean_sq
    return _SyncedMoments.apply(group, mean, mean_sq)
