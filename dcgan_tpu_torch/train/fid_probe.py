"""The trainer's in-training surrogate FID/KID probe with best-checkpoint
retention (the one-process half of `dcgan_tpu/train/trainer.py:620-693,
1817-1934`).

Every `fid_every_steps` steps the trainer calls `FidProbe.run`:

- the real side is computed once, at the first probe, from the held-out
  stream (`sample_image_dir`'s shards, or the synthetic stream at
  seed + 100): `ceil(fid_num_samples / batch_size)` batches through the
  port's random feature tower (evals/features.py) into StreamingStats and
  a `FeaturePool(D, n, seed=cfg.seed)` reservoir, labels dropped;
- each probe samples `fid_num_samples` images from the runner's live
  state through its captured `fid_sampler` row (train/warmup.py; z of
  batch i from (cfg.seed, i), evals/job.py) and scores them with
  `compute_fid(..., kid=True, kid_subset_size=max(2, min(1000, n // 4)),
  kid_subsets=20, kid_pool_size=n)`, the JAX trainer's settings;
- it prints the `[fid]` line and writes the `eval/fid` and `eval/kid`
  scalars;
- when the FID beats the best so far, the state is saved (synchronously)
  into `<checkpoint_dir>/best` by a Checkpointer keeping one step, with
  the run's `config.json` beside it (so `generate --checkpoint_dir
  <checkpoint_dir>/best` loads it like any run) and `score.json`
  ({"fid", "step"}, written by tmp and rename). A resumed run reads the
  best score back from `score.json`, so a worse probe after the restart
  does not replace a better best step.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Optional

import torch

from dcgan_tpu_torch.config import TrainConfig, save_config
from dcgan_tpu_torch.evals.features import make_random_feature_fn
from dcgan_tpu_torch.evals.job import compute_fid, stats_from_batches
from dcgan_tpu_torch.evals.kid import FeaturePool
from dcgan_tpu_torch.utils.checkpoint import Checkpointer

BEST_DIR = "best"
SCORE_FILENAME = "score.json"

NEEDS_HELD_OUT = (
    "fid_every_steps needs a held-out stream: provide sample_image_dir (or "
    "run synthetic), the same source the sample-loss probe uses")


def held_out_skip(cfg: TrainConfig, step: int) -> int:
    """The held-out batches a run that reached `step` has consumed: one per
    sample-loss probe, and the real side's once the first FID probe has
    run (the JAX trainer's count for a rebuilt held-out stream,
    `dcgan_tpu/train/trainer.py:1474-1484`). A resumed run skips them."""
    se = cfg.sample_every_steps
    n = step // se if se else 0
    if cfg.fid_every_steps and step >= cfg.fid_every_steps:
        n += -(-cfg.fid_num_samples // cfg.batch_size)
    return n


def read_best_score(checkpoint_dir: str) -> float:
    """The best FID `score.json` records under `checkpoint_dir`/best, or
    inf when there is none (or it is unreadable)."""
    try:
        with open(os.path.join(checkpoint_dir, BEST_DIR,
                               SCORE_FILENAME)) as f:
            return float(json.load(f)["fid"])
    except (OSError, ValueError, KeyError, TypeError):
        return float("inf")


class FidProbe:
    """The probe of one training run; see the module docstring."""

    def __init__(self, cfg: TrainConfig, device: torch.device):
        self.cfg = cfg
        self.feature_fn, self.feature_dim = make_random_feature_fn(
            cfg.model.output_size, cfg.model.c_dim, device=device)
        self.real_side = None     # (StreamingStats, FeaturePool)
        self.best = read_best_score(cfg.checkpoint_dir)
        self.best_dir = os.path.join(cfg.checkpoint_dir, BEST_DIR)
        self._ckpt: Optional[Checkpointer] = None

    def due(self, step: int) -> bool:
        return step % self.cfg.fid_every_steps == 0

    def run(self, step: int, runner, held_out, writer) -> dict:
        """Score the runner's state at `step` (the real side from
        `held_out`'s image batches at the first probe), write the scalars,
        keep the best; returns compute_fid's result."""
        cfg, mcfg = self.cfg, self.cfg.model
        n = cfg.fid_num_samples
        t0 = time.perf_counter()
        if self.real_side is None:
            pool = FeaturePool(self.feature_dim, n, seed=cfg.seed)
            stats = stats_from_batches(self.feature_fn, held_out, n,
                                       self.feature_dim, pool=pool)
            self.real_side = (stats, pool)
        result = compute_fid(
            runner.fid_sample, None, image_size=mcfg.output_size,
            c_dim=mcfg.c_dim, z_dim=mcfg.z_dim, num_samples=n,
            batch_size=cfg.batch_size, num_classes=mcfg.num_classes,
            seed=cfg.seed, feature_fn=self.feature_fn,
            feature_dim=self.feature_dim, kid=True,
            kid_subset_size=max(2, min(1000, n // 4)), kid_subsets=20,
            kid_pool_size=n, real_side=self.real_side)
        print(f"[dcgan_tpu_torch] [fid] step {step} fid "
              f"{result['fid']:.6f} kid {result['kid']:.3e} ({n} samples, "
              f"{time.perf_counter() - t0:.1f}s)", flush=True)
        writer.write_scalars(step, {"eval/fid": result["fid"],
                                    "eval/kid": result["kid"]})
        if result["fid"] < self.best:
            self.best = result["fid"]
            self._save_best(step, runner.state)
        return result

    def _save_best(self, step: int, state) -> None:
        if self._ckpt is None:
            # a sync save: each best save is on disk before training goes
            # on, so async machinery would only be joined
            self._ckpt = Checkpointer(self.best_dir, max_to_keep=1,
                                      async_save=False)
            save_config(self.cfg, self.best_dir)
        stale = os.path.join(self.best_dir, str(step))
        if os.path.isdir(stale):
            # a step saved before a resume from an earlier checkpoint
            shutil.rmtree(stale)
        self._ckpt.save(step, state)
        tmp = os.path.join(self.best_dir, SCORE_FILENAME + ".tmp")
        with open(tmp, "w") as f:
            json.dump({"fid": self.best, "step": int(step)}, f)
        os.replace(tmp, os.path.join(self.best_dir, SCORE_FILENAME))
        print(f"[dcgan_tpu_torch] [fid] new best ({self.best:.6f}) — saved "
              f"{self.best_dir}/{step}", flush=True)
