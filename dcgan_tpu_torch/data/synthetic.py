"""Synthetic data, copies of `dcgan_tpu/data/synthetic.py` (numpy only, so
the same seed gives the JAX package's bytes bit for bit):

- `write_image_tfrecords`: TFRecord shards in the reference's on-disk
  schema (one bytes feature `image_raw` of raw [H, W, C] pixels, float64 by
  default), so the loader runs against the real format without a dataset
  on disk;
- `synthetic_batches`: an endless stream of [-1, 1] batches.
"""

from __future__ import annotations

import os
from typing import Iterator, List

import numpy as np

from dcgan_tpu_torch.data.example_proto import serialize_example
from dcgan_tpu_torch.data.tfrecord import write_tfrecords


def write_image_tfrecords(out_dir: str, *, num_examples: int,
                          image_size: int = 64, channels: int = 3,
                          num_shards: int = 2, record_dtype: str = "float64",
                          seed: int = 0,
                          feature_name: str = "image_raw",
                          num_classes: int = 0,
                          label_feature: str = "label") -> List[str]:
    """Write `num_examples` random images (pixel scale [0,255]) across shards.

    num_classes > 0 also writes an int64 `label_feature` per example.
    Returns the shard paths.
    """
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    per_shard = (num_examples + num_shards - 1) // num_shards
    written = 0
    for s in range(num_shards):
        n = min(per_shard, num_examples - written)
        if n <= 0:
            break

        def records() -> Iterator[bytes]:
            for _ in range(n):
                img = rng.uniform(0, 255,
                                  size=(image_size, image_size, channels))
                raw = img.astype(record_dtype).tobytes()
                feats = {feature_name: [raw]}
                if num_classes:
                    feats[label_feature] = [int(rng.integers(num_classes))]
                yield serialize_example(feats)

        path = os.path.join(out_dir, f"shard-{s:05d}.tfrecord")
        write_tfrecords(path, records())
        paths.append(path)
        written += n
    return paths


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
