"""Bucket ladder: the only batch shapes the serving plane dispatches (the
counterpart of `dcgan_tpu/serve/buckets.py:41-111`).

Every dynamic batch snaps UP to the nearest rung and is padded with
throwaway latent rows, so the sampler sees a small fixed set of shapes. In
JAX each rung is an AOT-compiled executable; here a rung is warmed by one
primed throwaway dispatch at cold start (`worker.py`), which also builds
the CUDA kernels and lets cuDNN pick its algorithms before live traffic.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class BucketLadder:
    """Ascending, granule-aligned batch sizes the server may dispatch."""

    buckets: Tuple[int, ...]
    granule: int = 1

    def __post_init__(self):
        if not self.buckets:
            raise ValueError("bucket ladder must not be empty")
        if self.granule < 1:
            raise ValueError(f"granule must be >= 1, got {self.granule}")
        if list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError(
                f"buckets must be strictly ascending, got {self.buckets}")
        bad = [b for b in self.buckets if b < 1 or b % self.granule]
        if bad:
            raise ValueError(
                f"buckets {bad} are not positive multiples of the device "
                f"granule {self.granule}")

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    def snap(self, n: int) -> int:
        """The smallest bucket >= n; n past the top rung returns max_bucket
        (the caller chunks oversized work across dispatches)."""
        if n < 1:
            raise ValueError(f"batch size must be >= 1, got {n}")
        for b in self.buckets:
            if b >= n:
                return b
        return self.max_bucket


def build_ladder(max_batch: int, granule: int = 1) -> BucketLadder:
    """The default doubling ladder granule, 2*granule, ... capped by (and
    always including) `max_batch` rounded up to the granule."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    if granule < 1:
        raise ValueError(f"granule must be >= 1, got {granule}")
    top = -(-max_batch // granule) * granule
    rungs = []
    b = granule
    while b < top:
        rungs.append(b)
        b *= 2
    rungs.append(top)
    return BucketLadder(buckets=tuple(rungs), granule=granule)


def parse_buckets(spec: str, granule: int = 1) -> BucketLadder:
    """'8,16,32' -> BucketLadder, the CLI's explicit-ladder form."""
    try:
        rungs = tuple(sorted({int(tok) for tok in spec.split(",") if tok}))
    except ValueError:
        raise ValueError(
            f"--buckets must be comma-separated ints, got {spec!r}"
        ) from None
    return BucketLadder(buckets=rungs, granule=granule)
