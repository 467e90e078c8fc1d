"""Class labels as the JAX package reads them, with no index that can leave
its table (the counterpart of `jax.nn.one_hot` and of a gather into a
[K, C] table, `dcgan_tpu/models/dcgan.py:226-230,383-390`,
`dcgan_tpu/ops/norm.py:180-187`).

- `one_hot(labels, K, dtype)`: `jax.nn.one_hot`'s row, all zeros for a
  label outside [0, K), built by comparison (`F.one_hot` raises on such a
  label, and on the card a device assert would end the process);
- `class_rows(table, labels)`: row `labels[b]` of a [K, C] table for each
  example, the index taken as JAX's gather takes it: a negative label
  wraps once (-1 -> K-1), then the index is clamped to [0, K-1]. Its
  gradient is JAX's too, whose scatter drops an index still outside
  [0, K) after the wrap: such an example reads the clamped row but adds
  nothing to the table's gradient. The rows are a one-hot product summed
  over the classes, so the table's gradient is a plain reduction over
  the batch, the same bits on every run (the backward of `table[idx]` is
  an atomic scatter on CUDA, whose float order varies, and a captured
  step must equal the eager one bit for bit).
"""

from __future__ import annotations

import torch


def one_hot(labels: torch.Tensor, num_classes: int,
            dtype: torch.dtype) -> torch.Tensor:
    """[B] integer labels -> [B, K] in `dtype`; zeros outside [0, K)."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[:, None] == classes).to(dtype)


def class_rows(table: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """[K, C] table, [B] labels -> [B, C] rows in the table's dtype."""
    k = table.shape[0]
    wrapped = torch.where(labels < 0, labels + k, labels)
    # the differentiable rows: zero (and no gradient) outside [0, K)
    sel = one_hot(wrapped, k, table.dtype)
    rows = (sel[:, :, None] * table[None]).sum(dim=1)
    # the clamped row's value where the label is still out of range
    outside = ((wrapped < 0) | (wrapped >= k))[:, None]
    clamped = table.detach().index_select(0, wrapped.clamp(0, k - 1))
    return rows + torch.where(outside, clamped, torch.zeros_like(clamped))
