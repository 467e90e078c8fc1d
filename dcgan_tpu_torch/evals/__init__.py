"""Evaluation rig: FID (with KID and PRDC from the same feature pass) of
generator checkpoints, the counterpart of `dcgan_tpu/evals/` (`python -m
dcgan_tpu_torch.evals`; the trainer's FID/KID probe uses `compute_fid`).
"""

from dcgan_tpu_torch.evals.features import (
    make_npz_feature_fn,
    make_random_feature_fn,
)
from dcgan_tpu_torch.evals.fid import StreamingStats, frechet_distance
from dcgan_tpu_torch.evals.job import (
    compute_fid,
    generator_stats,
    stats_from_batches,
)

__all__ = [
    "StreamingStats",
    "frechet_distance",
    "make_npz_feature_fn",
    "make_random_feature_fn",
    "stats_from_batches",
    "generator_stats",
    "compute_fid",
]
