"""The eval job: stream real-data and generator features once, score FID
and optionally KID and PRDC from the same pass (the counterpart of
`dcgan_tpu/evals/job.py`).

Features are extracted on the device batch by batch; only the [D] / [D, D]
moment statistics, plus a bounded reservoir of features for KID and PRDC,
live on the host, in float64 numpy as in the JAX package (one readback of
[B, D] floats per batch). The statistics (`fid.py`, `kid.py`, `prdc.py`)
are the JAX package's own numpy code, copied, so the two packages give
the same scores on the same features.

The generator's z of batch i is U(-1, 1) [batch_size, z_dim] drawn from
(seed, i) by `generate.generate_z`, so batch i's draw does not depend on
the batches before it. The JAX package draws it from
`fold_in(key(seed), i)`; `draw_z(i)` replaces the port's draw (the tests
pass the JAX rows). A conditional generator's batch i has the labels
arange(i*B, (i+1)*B) % K, as in the JAX package.

Multi-process scoring (`distributed=True`, `allgather_merge_stats`,
`allgather_merge_pool`) is not ported: it comes with the port's multi-GPU
support (ROADMAP Queue A item 7).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Iterable, Optional, Union

import numpy as np
import torch

from dcgan_tpu_torch.evals.features import FeatureFn, make_random_feature_fn
from dcgan_tpu_torch.evals.fid import StreamingStats, frechet_distance
from dcgan_tpu_torch.evals.kid import FeaturePool, kid_score

MULTIPROCESS_UNPORTED = (
    "multi-process scoring is not ported to dcgan_tpu_torch yet: it comes "
    "with the port's multi-GPU support (ROADMAP Queue A item 7)")


class _Laps:
    """Seconds per phase, added into `timings` (None: nothing is timed and
    nothing synchronized). A lap given a CUDA tensor waits for the device
    first, so each device phase is timed by itself."""

    def __init__(self, timings: Optional[dict]):
        self.timings = timings
        self.t = time.perf_counter()

    def lap(self, name: str, tensor: Optional[torch.Tensor] = None) -> None:
        if self.timings is None:
            return
        if tensor is not None and tensor.device.type == "cuda":
            torch.cuda.synchronize(tensor.device)
        now = time.perf_counter()
        self.timings[name] = self.timings.get(name, 0.0) + now - self.t
        self.t = now


def _host(feats) -> np.ndarray:
    """Features on the host (the per-batch readback)."""
    if isinstance(feats, torch.Tensor):
        return feats.detach().cpu().numpy()
    return np.asarray(feats)


def stats_from_batches(feature_fn: FeatureFn, batches: Iterable,
                       num_examples: int, feature_dim: int,
                       pool: Optional[FeaturePool] = None) -> StreamingStats:
    """Fold image batches ([B,H,W,C] in [-1,1], tensors or numpy) into
    feature statistics until `num_examples` have been consumed; the last
    batch is trimmed to land exactly on the target count. `pool`, if
    given, reservoir-samples the same features for KID."""
    stats = StreamingStats(feature_dim)
    for batch in batches:
        take = min(int(batch.shape[0]), num_examples - stats.n)
        feats = _host(feature_fn(batch[:take]))
        stats.update(feats)
        if pool is not None:
            pool.update(feats)
        if stats.n >= num_examples:
            break
    if stats.n < num_examples:
        raise ValueError(
            f"data stream exhausted at {stats.n}/{num_examples} examples")
    return stats


def generator_stats(sample_fn: Callable, feature_fn: FeatureFn,
                    feature_dim: int, *, num_samples: int, batch_size: int,
                    z_dim: int, seed: int = 0, num_classes: int = 0,
                    pool: Optional[FeaturePool] = None,
                    draw_z: Optional[Callable[[int], np.ndarray]] = None,
                    timings: Optional[dict] = None) -> StreamingStats:
    """Stream `num_samples` generated images into feature statistics.

    `sample_fn(z[, labels]) -> images` gets z as a float32 CPU tensor
    [batch_size, z_dim] (and int32 labels cycling through the classes
    when conditional); its images may lie on any device. z of batch i is
    `draw_z(i)`, by default `generate_z(seed, i, batch_size, z_dim)`.
    `timings` gains the seconds of the sampler (with the z draw), the
    tower and the host statistics: `sampler_s`, `tower_s`, `stats_s`."""
    if draw_z is None:
        from dcgan_tpu_torch.generate import generate_z

        def draw_z(i):
            return generate_z(seed, i, batch_size, z_dim)
    stats = StreamingStats(feature_dim)
    laps = _Laps(timings)
    i = 0
    while stats.n < num_samples:
        z = torch.from_numpy(np.array(draw_z(i), np.float32))
        if num_classes:
            labels = (np.arange(i * batch_size, (i + 1) * batch_size)
                      % num_classes).astype(np.int32)
            images = sample_fn(z, torch.from_numpy(labels))
        else:
            images = sample_fn(z)
        laps.lap("sampler_s", images)
        take = min(batch_size, num_samples - stats.n)
        feats = _host(feature_fn(images[:take]))
        laps.lap("tower_s")
        stats.update(feats)
        if pool is not None:
            pool.update(feats)
        laps.lap("stats_s")
        i += 1
    return stats


def _norm_npz(path: str) -> str:
    """np.savez APPENDS '.npz' to extensionless paths; normalize up front so
    the save path and the existence check can never disagree."""
    return path if path.endswith(".npz") else path + ".npz"


def real_side_to_npz(path: str, stats: StreamingStats,
                     pool: Optional[FeaturePool] = None) -> None:
    """Persist real-side statistics (raw accumulators, not finalized
    moments, so merging/extending later stays exact; plus the KID reservoir
    when present), in the JAX package's schema: a file written by either
    package loads in the other. The real pass over 50k images is paid once
    per dataset, not once per checkpoint."""
    path = _norm_npz(path)
    arrays = {"n": np.asarray(stats.n, np.int64), "sum": stats._sum,
              "outer": stats._outer}
    if pool is not None:
        arrays["pool_features"] = pool.features()
        arrays["pool_n_seen"] = np.asarray(pool.n_seen, np.int64)
        arrays["pool_capacity"] = np.asarray(pool.capacity, np.int64)
    np.savez(path, **arrays)


def real_side_from_npz(path: str, *, need_pool: bool) -> tuple:
    """Load (StreamingStats, FeaturePool | None) written by
    real_side_to_npz. Raises if KID is requested but the file carries no
    reservoir (it was written without kid)."""
    with np.load(_norm_npz(path)) as raw:
        dim = int(raw["sum"].shape[0])
        stats = StreamingStats(dim)
        stats.n = int(raw["n"])
        stats._sum = np.asarray(raw["sum"], np.float64)
        stats._outer = np.asarray(raw["outer"], np.float64)
        pool = None
        if "pool_features" in raw:
            pool = pool_from_features(
                np.asarray(raw["pool_features"], np.float32),
                int(raw["pool_n_seen"]), int(raw["pool_capacity"]))
    if need_pool and pool is None:
        raise ValueError(
            f"{path} has no feature reservoir (it was written without "
            "--kid/--prdc); recompute the real statistics with the "
            "reservoir-needing flag set")
    return stats, pool


def pool_from_features(feats: np.ndarray, n_seen: int, capacity: int, *,
                       seed: int = 0) -> FeaturePool:
    """Rebuild a FeaturePool around an existing uniform sample (a
    real-statistics file's reservoir)."""
    pool = FeaturePool(feats.shape[1], capacity, seed=seed)
    pool._buf[:len(feats)] = feats
    pool.n_seen = int(n_seen)
    return pool


def allgather_merge_stats(stats: StreamingStats) -> StreamingStats:
    """The JAX package's cross-process reduction of feature statistics;
    not ported."""
    raise NotImplementedError(MULTIPROCESS_UNPORTED)


def allgather_merge_pool(pool: FeaturePool) -> FeaturePool:
    """The JAX package's cross-process reservoir merge; not ported."""
    raise NotImplementedError(MULTIPROCESS_UNPORTED)


def compute_fid(sample_fn: Callable, data_batches: Iterable, *,
                image_size: int, c_dim: int = 3, z_dim: int = 100,
                num_samples: int = 50_000, batch_size: int = 256,
                num_classes: int = 0, seed: int = 0,
                feature_fn: Optional[FeatureFn] = None,
                feature_dim: Optional[int] = None,
                kid: bool = False, kid_subset_size: int = 1000,
                kid_subsets: int = 100,
                kid_pool_size: int = 10_000,
                prdc: bool = False, prdc_k: int = 5,
                distributed: bool = False,
                real_side: Optional[tuple] = None,
                real_cache_path: Optional[str] = None,
                draw_z: Optional[Callable[[int], np.ndarray]] = None,
                device: Union[str, torch.device] = "cuda",
                timings: Optional[dict] = None) -> dict:
    """End-to-end scoring: returns {"fid", "num_samples", "feature_dim"} and,
    with kid=True, {"kid", "kid_std", "kid_pool"} from the SAME feature
    pass (a bounded reservoir of features feeds the subset-averaged
    unbiased-MMD estimator, kid.py). prdc=True adds {"precision", "recall",
    "density", "coverage", "prdc_pool", "prdc_k"} (prdc.py) computed on the
    same reservoirs.

    With feature_fn=None the port's fixed-seed random tower is built on
    `device` (features.py: its scores compare only with the port's own
    tower's). `draw_z(i)` replaces the generator's z of batch i (see the
    module docstring).

    real_side, if given, is a (StreamingStats, FeaturePool | None) pair of
    PRECOMPUTED real statistics: the data stream is not touched (the
    in-training probe computes it once). real_cache_path names an on-disk
    cache for the real side (the CLI's --real_stats): loaded when the file
    exists (with n / feature-dim / reservoir-capacity validation), else
    the real side is computed here and written there.

    `timings`, when given, gains the seconds of each phase: `real_s` (the
    real pass, 0 when it was loaded or given), `sampler_s`, `tower_s` and
    `stats_s` of the generator pass, `fid_s`, `kid_s`, `prdc_s`.
    distributed=True raises NotImplementedError."""
    if distributed:
        raise NotImplementedError(MULTIPROCESS_UNPORTED)
    if feature_fn is None:
        feature_fn, feature_dim = make_random_feature_fn(
            image_size, c_dim, device=device)
    elif feature_dim is None:
        raise ValueError("feature_dim required with a custom feature_fn")

    if real_cache_path:
        if real_side is not None:
            raise ValueError("pass real_side OR real_cache_path, not both")
        if os.path.exists(_norm_npz(real_cache_path)):
            real_side = real_side_from_npz(real_cache_path,
                                           need_pool=kid or prdc)
            cached, cached_pool = real_side
            if cached.n != num_samples:
                raise ValueError(
                    f"{real_cache_path} holds statistics over {cached.n} "
                    f"examples but num_samples is {num_samples}; FID sides "
                    "must match — recompute or adjust num_samples")
            if cached.dim != feature_dim:
                raise ValueError(
                    f"{real_cache_path} has feature dim {cached.dim}, the "
                    f"current extractor yields {feature_dim} — it was "
                    "written under a different feature config")
            if (kid or prdc) and cached_pool.capacity != kid_pool_size:
                raise ValueError(
                    f"{real_cache_path} reservoir capacity "
                    f"{cached_pool.capacity} != kid_pool_size "
                    f"{kid_pool_size}; kid/prdc sides must draw from "
                    "same-sized reservoirs — recompute or adjust kid_pool")

    need_pools = kid or prdc
    fake_pool = FeaturePool(feature_dim, kid_pool_size, seed=seed + 1) \
        if need_pools else None
    t_real = time.perf_counter()
    if real_side is not None:
        real, real_pool = real_side
        if need_pools and real_pool is None:
            raise ValueError(
                "kid/prdc need a FeaturePool in real_side")
    else:
        real_pool = FeaturePool(feature_dim, kid_pool_size, seed=seed) \
            if need_pools else None
        real = stats_from_batches(feature_fn, data_batches, num_samples,
                                  feature_dim, pool=real_pool)
        if real_cache_path:
            real_side_to_npz(real_cache_path, real, real_pool)
    if timings is not None:
        timings["real_s"] = 0.0 if real_side is not None \
            else time.perf_counter() - t_real
    fake = generator_stats(sample_fn, feature_fn, feature_dim,
                           num_samples=num_samples, batch_size=batch_size,
                           z_dim=z_dim, seed=seed, num_classes=num_classes,
                           pool=fake_pool, draw_z=draw_z, timings=timings)
    laps = _Laps(timings)
    fid = frechet_distance(*real.finalize(), *fake.finalize())
    laps.lap("fid_s")
    out = {"fid": fid, "num_samples": num_samples,
           "feature_dim": feature_dim}
    if kid:
        mean, std = kid_score(real_pool.features(), fake_pool.features(),
                              subset_size=kid_subset_size,
                              num_subsets=kid_subsets, seed=seed)
        out["kid"] = mean
        out["kid_std"] = std
        # the score is computed on at most this many reservoir-sampled
        # features per side — recorded so KID numbers are comparable
        out["kid_pool"] = min(kid_pool_size, num_samples)
        laps.lap("kid_s")
    if prdc:
        from dcgan_tpu_torch.evals.prdc import prdc as prdc_fn

        out.update(prdc_fn(real_pool.features(), fake_pool.features(),
                           k=prdc_k))
        # comparability keys, like kid_pool above: P&R values only compare
        # across runs at a fixed (pool, k)
        out["prdc_pool"] = min(kid_pool_size, num_samples)
        out["prdc_k"] = prdc_k
        laps.lap("prdc_s")
    return out
