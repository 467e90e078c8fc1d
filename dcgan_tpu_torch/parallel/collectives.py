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

The sequence-parallel collectives of the spatial mesh: `ring_shift`
(each rank sends to the next rank of its group and receives from the
previous one, the JAX `lax.ppermute` with perm [(i, (i + 1) % n)]),
`exchange` (point-to-point sends and receives to named peers, the conv
halo of parallel/spatial.py) and `all_to_all` (`lax.all_to_all(...,
tiled=True)`), and the two rings the sequence-parallel attention folds
over: `GroupRing` (one shard per rank of a process group) and
`LocalRing` (all n shards in one process, stacked along dim 0, rotated
with no collective: the same per-hop code at full size on one card and
in the CPU tests).

gloo on CUDA tensors: where this torch's gloo refuses a CUDA tensor, the
collective stages it through host memory (`STAGED["host"]` counts those
calls) and says so once on stderr; NCCL never stages. Each kind of
collective is probed on its own (gloo's CUDA support differs by op): an
all_reduce and an all_to_all run once on a CUDA tensor, and a refusal
stages that kind. gloo's send and recv have no CUDA path to probe: they
hand the tensor's address to gloo's TCP transport, which reads and
writes host memory, so over gloo a CUDA tensor is always sent and
received through host memory.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence, Tuple

import torch

Pytree = dict

# collectives issued by this process, by kind (the step's census), and
# those staged through host memory (gloo on CUDA tensors)
COUNTS: Dict[str, int] = {"all_reduce": 0, "all_gather": 0, "p2p": 0,
                          "all_to_all": 0}
STAGED: Dict[str, int] = {"host": 0}
# (group, kind) -> whether gloo takes a CUDA tensor for that kind
_GLOO_CUDA: Dict[Tuple[object, str], bool] = {}


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


def _probe(kind: str, group, device: torch.device) -> None:
    """One small collective of `kind` on a CUDA tensor (raises where gloo
    refuses it)."""
    import torch.distributed as dist

    if kind == "all_reduce":
        dist.all_reduce(torch.zeros(1, device=device), group=group)
    else:   # all_to_all
        n = world_size(group)
        dist.all_to_all_single(torch.empty(n, device=device),
                               torch.zeros(n, device=device), group=group)


def _gloo_takes_cuda(group, t: torch.Tensor, kind: str = "all_reduce"
                     ) -> bool:
    """Whether gloo runs a collective of `kind` on the CUDA tensor itself;
    probed once per group and kind with a one-element collective (every
    rank runs the same torch, so every rank takes the same branch). P2P
    is never handed a CUDA tensor (the module docstring)."""
    key = (group, kind)
    if key not in _GLOO_CUDA:
        if kind == "p2p":
            _GLOO_CUDA[key] = False
            reason = "send and recv have no CUDA path"
        else:
            try:
                _probe(kind, group, t.device)
                _GLOO_CUDA[key] = True
            except RuntimeError as e:
                _GLOO_CUDA[key] = False
                reason = f"{e!s:.80}"
        if not _GLOO_CUDA[key]:
            print(f"[dcgan_tpu_torch] gloo refuses CUDA tensors for "
                  f"{kind} ({reason}); those collectives stage through "
                  f"host memory", file=sys.stderr, flush=True)
    return _GLOO_CUDA[key]


def _staged(group, t: torch.Tensor, kind: str = "all_reduce") -> bool:
    return t.device.type == "cuda" and _backend(group) == "gloo" \
        and not _gloo_takes_cuda(group, t, kind)


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


def mean_tree(group, tree: Pytree, count: Optional[int] = None) -> Pytree:
    """The mean over the ranks of every leaf of a nested dict of tensors:
    the leaves of each dtype packed into one flat buffer, one all_reduce
    per dtype, unpacked in place of the leaves. `count` divides the sum in
    place of the rank count (the spatial step's data axis)."""
    if group is None:
        return tree
    from dcgan_tpu_torch.train.steps import tree_leaves, tree_unflatten

    leaves = tree_leaves(tree)
    n = world_size(group) if count is None else count
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


# ---------------------------------------------------------------------------
# Point to point and all_to_all (the spatial mesh)
# ---------------------------------------------------------------------------

def exchange(group, sends: Sequence[Tuple[int, torch.Tensor, int]],
             recvs: Sequence[Tuple[int, torch.Tensor, int]]) -> None:
    """Send each (peer, tensor, tag) of `sends` and receive into each
    (peer, buffer, tag) of `recvs`, in one batch of point-to-point
    operations; peers are global ranks of `group`'s members, and a send
    meets the receive of its tag. Returns when all are done."""
    import torch.distributed as dist

    if not sends and not recvs:
        return
    COUNTS["p2p"] += 1
    first = (list(sends) + list(recvs))[0][1]
    staged = _staged(group, first, "p2p")
    outs = recvs
    if staged:
        STAGED["host"] += 1
        sends = [(p, t.cpu(), tag) for p, t, tag in sends]
        recvs = [(p, torch.empty(b.shape, dtype=b.dtype), tag)
                 for p, b, tag in recvs]
    ops = [dist.P2POp(dist.isend, t.contiguous(), p, group, tag)
           for p, t, tag in sends]
    ops += [dist.P2POp(dist.irecv, b, p, group, tag) for p, b, tag in recvs]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if staged:
        for (_, out, _), (_, host, _) in zip(outs, recvs):
            out.copy_(host)


def ring_shift(group, nxt: int, prv: int,
               tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every tensor sent to global rank `nxt` and its counterpart received
    from `prv`, one batch for all of them: the ring's step (rank i's
    blocks move to rank i + 1)."""
    outs = [torch.empty_like(t) for t in tensors]
    exchange(group, [(nxt, t, i) for i, t in enumerate(tensors)],
             [(prv, o, i) for i, o in enumerate(outs)])
    return outs


def all_to_all(group, t: torch.Tensor, split_dim: int, concat_dim: int
               ) -> torch.Tensor:
    """`lax.all_to_all(t, split_axis=split_dim, concat_axis=concat_dim,
    tiled=True)` over `group`: `t` split into n chunks along split_dim,
    chunk j sent to rank j, the chunks received concatenated along
    concat_dim in rank order."""
    import torch.distributed as dist

    n = world_size(group)
    send = torch.stack(t.chunk(n, split_dim)).contiguous()
    COUNTS["all_to_all"] += 1
    if _staged(group, send, "all_to_all"):
        STAGED["host"] += 1
        host = send.cpu()
        recv = torch.empty_like(host)
        dist.all_to_all_single(recv, host, group=group)
        recv = recv.to(t.device)
    else:
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


def local_all_to_all(t: torch.Tensor, n: int, split_dim: int,
                     concat_dim: int) -> torch.Tensor:
    """`all_to_all` over n shards stacked along dim 0 of `t` in one
    process ([n * B, ...], shard i the rows i * B ..): the same tiled
    exchange as a permutation, differentiable as it is. `split_dim` and
    `concat_dim` are a shard's dims (>= 1)."""
    b = t.shape[0] // n
    rest = list(t.shape[1:])
    x = t.reshape(n, b, *rest)
    names = ["src", "b"] + [f"d{d}" for d in range(1, t.dim())]
    i = names.index(f"d{split_dim}")
    x = x.unflatten(i, (n, rest[split_dim - 1] // n))
    names[i:i + 1] = ["dst", f"d{split_dim}"]
    target = ["dst", "b"] + [f"d{d}" for d in range(1, t.dim())]
    j = target.index(f"d{concat_dim}")
    target[j:j + 1] = ["src", f"d{concat_dim}"]
    x = x.permute([names.index(name) for name in target])
    shape = list(rest)
    shape[split_dim - 1] //= n
    shape[concat_dim - 1] *= n
    return x.reshape(n * b, *shape)


class GroupRing:
    """The ring of a process group's ranks in group order: `rotate` moves
    every rank's blocks to the next rank (rank i receives rank i - 1's),
    `rotate_back` the other way; `all_to_all` is the group's."""

    def __init__(self, group, ranks: Sequence[int], index: int):
        self.group = group
        self.ranks = tuple(ranks)
        self.index = index
        self.n = len(self.ranks)

    def _peer(self, step: int) -> int:
        return self.ranks[(self.index + step) % self.n]

    def rotate(self, *tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return tuple(ring_shift(self.group, self._peer(1), self._peer(-1),
                                tensors))

    def rotate_back(self, *tensors: torch.Tensor
                    ) -> Tuple[torch.Tensor, ...]:
        return tuple(ring_shift(self.group, self._peer(-1), self._peer(1),
                                tensors))

    def all_to_all(self, t: torch.Tensor, split_dim: int, concat_dim: int
                   ) -> torch.Tensor:
        return all_to_all(self.group, t, split_dim, concat_dim)


class LocalRing:
    """n shards in one process, stacked along dim 0 ([n * B, ...], shard i
    the rows i * B ..): `rotate` rolls the stack by one shard (shard i
    receives shard i - 1's blocks), with no collective; `all_to_all` is
    `local_all_to_all`."""

    def __init__(self, n: int):
        self.n = n

    def rotate(self, *tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return tuple(torch.roll(t, t.shape[0] // self.n, 0)
                     for t in tensors)

    def rotate_back(self, *tensors: torch.Tensor
                    ) -> Tuple[torch.Tensor, ...]:
        return tuple(torch.roll(t, -(t.shape[0] // self.n), 0)
                     for t in tensors)

    def all_to_all(self, t: torch.Tensor, split_dim: int, concat_dim: int
                   ) -> torch.Tensor:
        return local_all_to_all(t, self.n, split_dim, concat_dim)

    def stack(self, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """A whole [B, ...] tensor as the stack of its n shards along
        `dim` ([n * B, ...])."""
        return torch.cat(t.chunk(self.n, dim), 0)

    def unstack(self, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The inverse of `stack`."""
        return torch.cat(t.chunk(self.n, 0), dim)
