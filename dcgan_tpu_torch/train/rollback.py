"""NaN rollback-and-skip (the `RollbackManager` of
`dcgan_tpu/train/rollback.py`, with its contract).

Under `--nan_policy rollback` the trainer keeps a copy of the last
gate-verified state every `rollback_snapshot_steps` steps; when the NaN
gate trips, the manager puts the snapshot back and the trainer rewinds its
step counter and trains on. The data iterator is not rewound, so the
batches that fed the poisoned window are skipped, and the trainer folds
the rollback count into its step-draw seeds so that the replayed steps
draw fresh z. Optional LR backoff multiplies both nets' base rates by
`lr_backoff` per rollback. `max_rollbacks` bounds the whole mechanism:
persistent divergence still aborts (`RollbackExhausted`).

The snapshot lives on the state's device: one preallocated copy of every
leaf, filled by one multi-tensor copy (`torch._foreach_copy_`) on the
current stream (no host sync, no allocation after the first), and
`restore(into=...)` copies it back into the trainer's static state in
place. So the captured CUDA graphs, which read the static state by
address, stay valid across a rollback and nothing is captured again. The
price is one copy of the train state in device memory; the JAX package's
single-process host copy costs a device-to-host transfer of the whole
state per snapshot instead.

restore()'s order is the JAX contract: the budget check, then the
`on_restore` hook (the trainer drains the G/D pipeline's in-flight fake
stack there), then the copy back.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from dcgan_tpu_torch.train.steps import tree_leaves, tree_map

Pytree = dict


class RollbackExhausted(FloatingPointError):
    """The gate tripped more than max_rollbacks times; carries the last
    gate failure as __cause__."""


def _copy_leaves(dst: List[torch.Tensor], src: List[torch.Tensor]) -> None:
    # one multi-tensor copy for the whole tree: a few launches, not one
    # per leaf (celeba64's state has 137 leaves)
    with torch.no_grad():
        torch._foreach_copy_(dst, src)


class RollbackManager:
    """Last-good snapshot keeper and restore executor for one run."""

    def __init__(self, *, every: int, max_rollbacks: int,
                 lr_backoff: float = 1.0, chief: bool = True):
        if every < 1:
            raise ValueError(f"snapshot cadence must be >= 1, got {every}")
        self.every = every
        self.max_rollbacks = max_rollbacks
        self.lr_backoff = lr_backoff
        self.chief = chief
        self.rollbacks = 0
        self._snap: Optional[Pytree] = None
        self._snap_step: Optional[int] = None
        # drain-before-restore: called once per consumed rollback, after
        # the budget check and before the copy back
        self.on_restore: Optional[Callable[[], None]] = None

    @property
    def snapshot_step(self) -> Optional[int]:
        return self._snap_step

    def due(self, step: int) -> bool:
        return step % self.every == 0

    def snapshot(self, step: int, state: Pytree) -> None:
        """Copy `state` (gate-verified) into the snapshot. The buffers are
        allocated at the first snapshot and again only when the tree's
        leaves change shape or dtype (a progressive phase switch)."""
        leaves = tree_leaves(state)
        if self._snap is None or not _same_layout(tree_leaves(self._snap),
                                                  leaves):
            self._snap = tree_map(torch.empty_like, state)
        _copy_leaves(tree_leaves(self._snap), leaves)
        self._snap_step = int(step)

    def restore(self, exc: FloatingPointError,
                into: Optional[Pytree] = None) -> Tuple[Pytree, int]:
        """Consume one rollback: (state, step) of the snapshot, copied into
        `into` in place when given (the static state), else into fresh
        tensors. Raises RollbackExhausted (from `exc`) once the budget is
        spent, and `exc` itself when no snapshot was ever taken."""
        if self._snap is None:
            raise exc
        self.rollbacks += 1
        if self.rollbacks > self.max_rollbacks:
            raise RollbackExhausted(
                f"NaN gate tripped {self.rollbacks} times with "
                f"max_rollbacks={self.max_rollbacks} — persistent "
                f"divergence, aborting (last failure: {exc})") from exc
        if self.chief:
            print(f"[dcgan_tpu_torch] NaN gate tripped ({exc}); rolling "
                  f"back to last-good snapshot at step {self._snap_step} "
                  f"(rollback {self.rollbacks}/{self.max_rollbacks}, "
                  f"offending batch window will be skipped)", flush=True)
        if self.on_restore is not None:
            self.on_restore()
        if into is None:
            into = tree_map(torch.empty_like, self._snap)
        _copy_leaves(tree_leaves(into), tree_leaves(self._snap))
        return into, self._snap_step

    def lr_scale(self) -> float:
        """Cumulative LR multiplier after the rollbacks so far."""
        return self.lr_backoff ** self.rollbacks


def _same_layout(a: List[torch.Tensor], b: List[torch.Tensor]) -> bool:
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype and x.device == y.device
        for x, y in zip(a, b))
