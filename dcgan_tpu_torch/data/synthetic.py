"""Synthetic image batches, a copy of `dcgan_tpu/data/synthetic.py::
synthetic_batches` (numpy only, so the same seed gives the JAX package's
batches bit for bit)."""

from __future__ import annotations

from typing import Iterator

import numpy as np


def synthetic_batches(batch_size: int, image_size: int = 64, channels: int = 3,
                      seed: int = 0, num_classes: int = 0,
                      pool: int = 64) -> Iterator:
    """Endless stream of [-1,1] float32 batches [B, S, S, C] (no disk).

    num_classes > 0 yields (images, int32 labels) pairs instead. The first
    `pool` batches are freshly drawn, then the stream cycles them (pool=0:
    every batch fresh); the cache is capped at ~256 MB whatever the batch
    geometry, falling back to fresh batches when one batch alone exceeds
    it. Synthetic data exercises the training machinery; it is not meant
    to be learned from.
    """
    if pool < 0:
        raise ValueError(f"pool must be >= 0, got {pool}")
    rng = np.random.default_rng(seed)
    if pool:
        batch_bytes = 4 * batch_size * image_size * image_size * channels
        pool = min(pool, (256 << 20) // max(1, batch_bytes))
    cache = []
    while True:
        if pool and len(cache) >= pool:
            for item in cache:
                yield item
            continue
        imgs = np.tanh(rng.normal(
            size=(batch_size, image_size, image_size, channels))
        ).astype(np.float32)
        if num_classes:
            item = (imgs, rng.integers(num_classes, size=(batch_size,),
                                       dtype=np.int32))
        else:
            item = imgs
        if pool:
            cache.append(item)
        yield item
