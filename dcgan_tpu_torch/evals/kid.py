"""Kernel Inception Distance (Bińkowski et al. 2018, arXiv:1801.01401); a
copy of `dcgan_tpu/evals/kid.py` (numpy only: the reservoir draws the same
`numpy.random.default_rng` stream as the JAX package's).

KID is the unbiased MMD^2 between real and generated feature distributions
under the polynomial kernel k(x, y) = (x·y / D + 1)^3, reported as the mean
(and std) over random subsets. It complements FID in the eval rig: the
estimator is unbiased at small sample counts (FID's Gaussian fit is not), so
it is the score to trust for quick evals during training, and it needs no
matrix square root.

Unlike FID's O(D)/O(D^2) streaming moments (evals/fid.py), MMD needs actual
feature vectors. `FeaturePool` keeps a bounded uniform sample of the stream
via reservoir sampling — memory is capacity·D however many examples stream
through, and the pooled subset is an unbiased draw, which is exactly what the
subset-averaged estimator wants. Pools merge across hosts (weighted reservoir
merge) the way StreamingStats.merge does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class FeaturePool:
    """Bounded uniform sample of a feature stream ([B, D] updates)."""

    def __init__(self, dim: int, capacity: int, *, seed: int = 0):
        if capacity < 2:
            raise ValueError(f"capacity must be >= 2, got {capacity}")
        self.dim = dim
        self.capacity = capacity
        self.n_seen = 0
        self._buf = np.zeros((capacity, dim), np.float32)
        self._rng = np.random.default_rng(seed)

    def update(self, feats) -> None:
        feats = np.asarray(feats, np.float32)
        if feats.ndim != 2 or feats.shape[1] != self.dim:
            raise ValueError(f"expected [B, {self.dim}], got {feats.shape}")
        # fill phase: copy rows straight into empty slots
        if self.n_seen < self.capacity:
            take = min(self.capacity - self.n_seen, feats.shape[0])
            self._buf[self.n_seen:self.n_seen + take] = feats[:take]
            self.n_seen += take
            feats = feats[take:]
        if feats.shape[0] == 0:
            return
        # classic reservoir (Algorithm R), vectorized per batch: stream
        # element i replaces a uniform slot j ~ [0, i] iff j < capacity
        idx = np.arange(self.n_seen + 1, self.n_seen + 1 + feats.shape[0])
        js = (self._rng.random(feats.shape[0]) * idx).astype(np.int64)
        keep = js < self.capacity
        # later duplicates must win (they would in the sequential loop)
        self._buf[js[keep]] = feats[keep]
        self.n_seen += feats.shape[0]

    def merge(self, other: "FeaturePool") -> "FeaturePool":
        """Fold another pool in, keeping the union uniform: each slot draws
        from self/other proportional to their stream counts.

        Each side's buffer is shuffled before the draw: a reservoir's
        *contents* are a uniform sample but its *order* correlates with
        stream position (the fill phase is stream-ordered), so consuming
        sequential prefixes would bias the merged sample toward
        early-stream features whenever take < mine+theirs."""
        if other.dim != self.dim or other.capacity != self.capacity:
            raise ValueError("pool shape mismatch")
        mine = self.features().copy()
        theirs = other.features().copy()
        self._rng.shuffle(mine)
        self._rng.shuffle(theirs)
        total = self.n_seen + other.n_seen
        take = min(self.capacity, len(mine) + len(theirs))
        p_other = other.n_seen / max(1, total)
        out = np.zeros((take, self.dim), np.float32)
        mi = ti = 0
        for i in range(take):
            from_other = (self._rng.random() < p_other and ti < len(theirs)) \
                or mi >= len(mine)
            if from_other:
                out[i] = theirs[ti]; ti += 1
            else:
                out[i] = mine[mi]; mi += 1
        self._buf[:take] = out
        self.n_seen = total
        return self

    def features(self) -> np.ndarray:
        """The sampled features, [min(n_seen, capacity), D]."""
        return self._buf[:min(self.n_seen, self.capacity)]


def polynomial_kernel(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """k(x, y) = (x·y / D + 1)^3 — the KID paper's kernel (degree 3,
    gamma = 1/D, coef 1)."""
    d = x.shape[1]
    return (x @ y.T / d + 1.0) ** 3


def mmd2_unbiased(x: np.ndarray, y: np.ndarray) -> float:
    """Unbiased MMD^2 estimate between equal-size feature sets [n, D]."""
    n = x.shape[0]
    m = y.shape[0]
    if n < 2 or m < 2:
        raise ValueError(f"need >= 2 samples per side, got {n}, {m}")
    kxx = polynomial_kernel(x, x)
    kyy = polynomial_kernel(y, y)
    kxy = polynomial_kernel(x, y)
    sum_xx = (kxx.sum() - np.trace(kxx)) / (n * (n - 1))
    sum_yy = (kyy.sum() - np.trace(kyy)) / (m * (m - 1))
    sum_xy = kxy.mean()
    return float(sum_xx + sum_yy - 2.0 * sum_xy)


def kid_score(real: np.ndarray, fake: np.ndarray, *,
              subset_size: int = 1000, num_subsets: int = 100,
              seed: int = 0) -> Tuple[float, float]:
    """Mean and std of unbiased MMD^2 over `num_subsets` random subsets of
    size `subset_size` (the paper's block estimator; subsets are drawn
    without replacement within a block, with replacement across blocks).
    Subset size clamps to the smaller feature set."""
    real = np.asarray(real, np.float64)
    fake = np.asarray(fake, np.float64)
    n = min(subset_size, real.shape[0], fake.shape[0])
    rng = np.random.default_rng(seed)
    vals = np.empty(num_subsets, np.float64)
    for i in range(num_subsets):
        rs = real[rng.choice(real.shape[0], n, replace=False)]
        fs = fake[rng.choice(fake.shape[0], n, replace=False)]
        vals[i] = mmd2_unbiased(rs, fs)
    return float(vals.mean()), float(vals.std())
