"""Improved precision & recall for generative models (Kynkäänniemi et al.
2019, arXiv:1904.06991), plus density & coverage (Naeem et al. 2020,
arXiv:2002.09797) from the same k-NN radii; a copy of
`dcgan_tpu/evals/prdc.py` (numpy only).

FID/KID compress fidelity and diversity into one number; this family
separates them:

- precision: fraction of FAKE samples lying inside the real manifold
  (fidelity — are generated images realistic?);
- recall: fraction of REAL samples lying inside the fake manifold
  (diversity — is the whole data distribution covered?);
- density/coverage: the same questions with estimators that are robust to
  outlier samples inflating a manifold (density counts how many real
  k-NN balls contain each fake; coverage counts reals whose ball contains
  at least one fake).

The manifold is the classic k-NN estimate: a point set's manifold is the
union of balls centered on each point with radius = distance to its k-th
nearest neighbor within the set. Works on any feature embedding — here the
same pools the KID reservoir already collects (evals/kid.py), so the eval
CLI gets P&R from features it has in hand, no extra passes. Memory: the
[Nf, Nr] f32 distance matrix is materialized (400 MB at 10k reservoirs)
plus its bool membership mask (~100 MB) — peak ~600 MB; the blockwise
loops only bound per-chunk temporaries. Shrink --kid_pool on small hosts.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _pairwise_sq_dists(a: np.ndarray, b: np.ndarray,
                       block: int = 2048) -> np.ndarray:
    """Squared euclidean distances [len(a), len(b)], blockwise over rows."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    b_sq = (b ** 2).sum(axis=1)
    out = np.empty((len(a), len(b)), np.float32)
    for i in range(0, len(a), block):
        chunk = a[i:i + block]
        d = ((chunk ** 2).sum(axis=1)[:, None] + b_sq[None, :]
             - 2.0 * chunk @ b.T)
        np.maximum(d, 0.0, out=d)  # clamp fp cancellation
        out[i:i + block] = d
    return out


def _knn_radii_sq(feats: np.ndarray, k: int, block: int = 2048) -> np.ndarray:
    """Squared distance from each point to its k-th nearest OTHER point."""
    n = len(feats)
    if not 1 <= k < n:
        raise ValueError(f"k must be in [1, {n - 1}], got {k}")
    radii = np.empty((n,), np.float32)
    sq = np.asarray(feats, np.float32)
    for i in range(0, n, block):
        d = _pairwise_sq_dists(sq[i:i + block], sq, block=block)
        # self-distance sits at position i+j; exclude it from the k-NN by
        # taking the (k+1)-th smallest including self
        radii[i:i + block] = np.partition(d, k, axis=1)[:, k]
    return radii


def prdc(real_feats: np.ndarray, fake_feats: np.ndarray, *,
         k: int = 5) -> Dict[str, float]:
    """Precision, recall, density, coverage between two feature sets.

    Both sets should be uniform samples of comparable size (the KID
    reservoirs qualify). k=5 is the papers' standard setting.
    """
    real = np.asarray(real_feats, np.float32)
    fake = np.asarray(fake_feats, np.float32)
    if real.ndim != 2 or fake.ndim != 2 or real.shape[1] != fake.shape[1]:
        raise ValueError(
            f"expected [N, D] feature sets with equal D, got "
            f"{real.shape} vs {fake.shape}")

    real_r = _knn_radii_sq(real, k)              # [Nr]
    fake_r = _knn_radii_sq(fake, k)              # [Nf]
    d_fr = _pairwise_sq_dists(fake, real)        # [Nf, Nr]

    # precision: fake j inside ANY real ball
    inside_real = d_fr <= real_r[None, :]
    precision = float(inside_real.any(axis=1).mean())
    # recall: real i inside ANY fake ball — reuse d_fr transposed
    recall = float((d_fr.T <= fake_r[None, :]).any(axis=1).mean())
    # density: average count of real balls containing each fake, /k —
    # unlike precision it is not saturated by a single outlier ball
    density = float(inside_real.sum(axis=1).mean() / k)
    # coverage: fraction of real balls containing at least one fake —
    # the membership matrix is inside_real, already in hand
    coverage = float(inside_real.any(axis=0).mean())
    return {"precision": precision, "recall": recall,
            "density": density, "coverage": coverage}
