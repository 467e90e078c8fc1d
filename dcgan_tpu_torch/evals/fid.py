"""Fréchet Inception Distance core: streaming activation statistics and the
matrix-sqrt Fréchet distance (a copy of `dcgan_tpu/evals/fid.py`, which
imports no JAX: the same float64 accumulators and scipy `sqrtm`, so both
packages give the same number on the same features).

FID(N(mu1, C1), N(mu2, C2)) = |mu1-mu2|^2 + tr(C1 + C2 - 2 (C1 C2)^{1/2})

Statistics accumulate in a streaming (sum / outer-product-sum) form so 50k
samples never need to be resident at once — features arrive in device batches,
are folded into float64 host accumulators, and the 50k-sample pass is O(D^2)
memory regardless of sample count. Accumulators merge (`merge`), which a
multi-process eval will use.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class StreamingStats:
    """Mean/covariance accumulator over feature batches [B, D]."""

    def __init__(self, dim: int):
        self.dim = dim
        self.n = 0
        self._sum = np.zeros((dim,), np.float64)
        self._outer = np.zeros((dim, dim), np.float64)

    def update(self, feats) -> None:
        feats = np.asarray(feats, np.float64)
        if feats.ndim != 2 or feats.shape[1] != self.dim:
            raise ValueError(f"expected [B, {self.dim}], got {feats.shape}")
        self.n += feats.shape[0]
        self._sum += feats.sum(axis=0)
        self._outer += feats.T @ feats

    def merge(self, other: "StreamingStats") -> "StreamingStats":
        """Fold another accumulator in (cross-host reduction for multi-process
        eval — each host streams its shard, stats merge at the end)."""
        if other.dim != self.dim:
            raise ValueError("dim mismatch")
        self.n += other.n
        self._sum += other._sum
        self._outer += other._outer
        return self

    def finalize(self) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (mean [D], covariance [D, D]) with the unbiased (n-1)
        normalization the reference FID implementations use (np.cov default).
        """
        if self.n < 2:
            raise ValueError(f"need >= 2 samples, have {self.n}")
        mu = self._sum / self.n
        cov = (self._outer - self.n * np.outer(mu, mu)) / (self.n - 1)
        return mu, cov


def frechet_distance(mu1, cov1, mu2, cov2, *, eps: float = 1e-6) -> float:
    """Fréchet distance between two Gaussians.

    The matrix square root runs on host in float64 (scipy); it's a one-shot
    O(D^3) epilogue, not worth a device kernel. A diagonal jitter retry
    handles the near-singular covariances that small sample counts produce.
    """
    import scipy.linalg

    mu1 = np.asarray(mu1, np.float64)
    mu2 = np.asarray(mu2, np.float64)
    cov1 = np.asarray(cov1, np.float64)
    cov2 = np.asarray(cov2, np.float64)

    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(cov1 @ cov2)
    if not np.isfinite(covmean).all():
        offset = eps * np.eye(cov1.shape[0])
        covmean = scipy.linalg.sqrtm((cov1 + offset) @ (cov2 + offset))
    if np.iscomplexobj(covmean):
        # numerical imaginary leakage from sqrtm of a near-PSD product
        covmean = covmean.real
    fid = diff @ diff + np.trace(cov1) + np.trace(cov2) - 2.0 * np.trace(covmean)
    # tiny negative values are pure roundoff; true FID is >= 0
    return float(max(fid, 0.0))
