"""Eval CLI: score a trained checkpoint against a dataset (FID; KID with
--kid and precision/recall/density/coverage with --prdc, from the same
feature pass); the counterpart of `python -m dcgan_tpu.evals`.

    python -m dcgan_tpu_torch.evals --checkpoint_dir C --data_dir D \
        --kid --prdc
    python -m dcgan_tpu_torch.evals --checkpoint_dir C --synthetic --kid \
        --num_samples 1024 --device cpu                 # smoke run
    python -m dcgan_tpu_torch.evals --checkpoint_dir C --data_dir D \
        --feature_npz tower.npz     # the JAX package's default tower,
                                    # written by tools/export_feature_tower.py

Prints one JSON line with the JAX CLI's keys: {"fid", "num_samples",
"feature_dim", ("kid", "kid_std", "kid_pool",) ("precision", "recall",
"density", "coverage", "prdc_pool", "prdc_k",) "step"}.

It runs on the card unless --device cpu is given. The model is the
checkpoint's config.json plus the override flags; the newest intact step
is restored through the Checkpointer (--use_ema scores `ema_gen`). The
sampler is one captured program at [batch_size, z_dim] (and the labels of
a conditional model) on the route the config names (serve/sources.py's
rung); z of batch i comes from (--seed, i) (evals/job.py). The real side
is the synthetic stream at --seed + 1, every batch fresh, or the TFRecord
shards of --data_dir through the native loader, adopting the
record_dtype and feature_name of their dataset.json; labels are not read.
Without --feature_npz the port's own random tower scores, whose scores
compare only with the port's (evals/features.py).

Not carried over: --multihost (multi-process scoring comes with the
port's multi-GPU support, ROADMAP Queue A item 7) is refused by name;
--platform is --device.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional, Tuple

from dcgan_tpu_torch.config import add_model_override_flags


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dcgan_tpu_torch.evals",
                                description="FID scoring of a checkpoint")
    p.add_argument("--checkpoint_dir", required=True)
    p.add_argument("--data_dir", default=None,
                   help="TFRecord shards of real images")
    p.add_argument("--synthetic", action="store_true",
                   help="score against the synthetic data stream")
    p.add_argument("--num_samples", type=int, default=50_000)
    p.add_argument("--batch_size", type=int, default=256)
    # architecture flags default to None = "take it from the checkpoint's
    # config.json" (written by the trainer); explicit flags override
    add_model_override_flags(p)
    p.add_argument("--kid", action="store_true",
                   help="also report KID (subset-averaged unbiased MMD^2) "
                        "from the same feature pass")
    p.add_argument("--prdc", action="store_true",
                   help="also report precision/recall/density/coverage "
                        "(k-NN manifolds over the same feature reservoirs) "
                        "— fidelity and diversity separated. Note: k-NN "
                        "balls in a 512-d embedding are stringent at small "
                        "pools; compare values across checkpoints at a "
                        "fixed (pool, k), don't read absolutes")
    p.add_argument("--prdc_k", type=int, default=5,
                   help="k for the k-NN manifold radii (papers' default 5)")
    p.add_argument("--kid_subset_size", type=int, default=1000)
    p.add_argument("--kid_subsets", type=int, default=100)
    p.add_argument("--kid_pool", type=int, default=10_000,
                   help="per-side reservoir cap for KID features; raise to "
                        "num_samples for full-set KID (memory: pool*D*4 "
                        "bytes per side)")
    p.add_argument("--feature_npz", default=None,
                   help="tower weights in the npz schema (evals/features.py"
                        "); tools/export_feature_tower.py writes the JAX "
                        "package's default tower, for scores comparable "
                        "across the two packages")
    p.add_argument("--real_stats", default=None,
                   help="cache file for real-side statistics: loaded when "
                        "present (the real pass is skipped), written after "
                        "computing otherwise. One file per (dataset, "
                        "feature config, num_samples); include --kid when "
                        "writing if KID scoring will ever read it")
    p.add_argument("--use_ema", action="store_true",
                   help="score the EMA generator weights (trained with "
                        "--g_ema_decay > 0) instead of the live weights")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' must be asked for by name")
    p.add_argument("--multihost", action="store_true",
                   help="distributed scoring over processes: not ported "
                        "(refused)")
    return p


def _real_batches(args: argparse.Namespace, mcfg, device):
    """The real side's image batches on `device` (close them when done)."""
    from dcgan_tpu_torch.data.pipeline import DataConfig, \
        DevicePrefetcher, make_dataset, read_manifest
    from dcgan_tpu_torch.data.synthetic import synthetic_batches

    if args.synthetic:
        # pool=0: the real-side statistics need every sample distinct —
        # cycled batches would bias the FID moments and the KID reservoir
        return DevicePrefetcher(
            synthetic_batches(args.batch_size, mcfg.output_size,
                              mcfg.c_dim, seed=args.seed + 1, pool=0),
            device)
    # the manifest's wire format is authoritative for a read-only consumer;
    # only the keys it carries are passed, so DataConfig keeps the defaults
    # of a manifest-less dataset
    manifest = read_manifest(args.data_dir)
    wire = {k: manifest[k] for k in ("record_dtype", "feature_name")
            if k in manifest}
    return make_dataset(DataConfig(
        data_dir=args.data_dir, image_size=mcfg.output_size,
        channels=mcfg.c_dim, batch_size=args.batch_size, seed=args.seed,
        normalize=True, **wire), device)


def evaluate(args: argparse.Namespace, *,
             model_overrides: Optional[dict] = None) -> Tuple[dict, dict]:
    """Score the checkpoint; returns (the JSON line's dict, the seconds of
    each phase: `restore_s`, `capture_s`, compute_fid's `real_s`,
    `sampler_s`, `tower_s`, `stats_s`, `fid_s`, `kid_s`, `prdc_s`, and
    `total_s`). `model_overrides` replaces ModelConfig fields after the
    flags (e.g. the route: use_pallas, pallas_fused)."""
    if not args.synthetic and not args.data_dir:
        raise SystemExit("need --data_dir or --synthetic")
    if args.multihost:
        raise SystemExit(
            "--multihost (distributed scoring over processes) is not "
            "ported to dcgan_tpu_torch yet: it comes with the port's "
            "multi-GPU support (ROADMAP Queue A item 7)")

    from dcgan_tpu_torch.config import MODEL_OVERRIDE_FLAGS
    from dcgan_tpu_torch.device import resolve_device
    from dcgan_tpu_torch.evals.features import make_npz_feature_fn
    from dcgan_tpu_torch.evals.job import compute_fid
    from dcgan_tpu_torch.serve.sources import CheckpointSource

    t0 = time.perf_counter()
    dev = resolve_device(args.device)
    overrides = {name: getattr(args, name) for name in MODEL_OVERRIDE_FLAGS}
    overrides.update(model_overrides or {})
    source = CheckpointSource(args.checkpoint_dir, use_ema=args.use_ema,
                              overrides=overrides, device=dev)
    try:
        meta = source.prepare()
    except FileNotFoundError:
        raise SystemExit(
            f"no checkpoint under {args.checkpoint_dir}") from None
    mcfg = source.cfg
    timings = {"restore_s": time.perf_counter() - t0}
    data = None
    try:
        t1 = time.perf_counter()
        source.bind([args.batch_size])
        timings["capture_s"] = time.perf_counter() - t1
        feature_fn = feature_dim = None
        if args.feature_npz:
            feature_fn, feature_dim = make_npz_feature_fn(args.feature_npz,
                                                          device=dev)
        data = _real_batches(args, mcfg, dev)

        def sample_fn(z, labels=None):
            return source.run(args.batch_size, z, labels)

        result = compute_fid(
            sample_fn, data, image_size=mcfg.output_size, c_dim=mcfg.c_dim,
            z_dim=mcfg.z_dim, num_samples=args.num_samples,
            batch_size=args.batch_size, num_classes=mcfg.num_classes,
            seed=args.seed, feature_fn=feature_fn, feature_dim=feature_dim,
            kid=args.kid, kid_subset_size=args.kid_subset_size,
            kid_subsets=args.kid_subsets, kid_pool_size=args.kid_pool,
            prdc=args.prdc, prdc_k=args.prdc_k,
            real_cache_path=args.real_stats, device=dev, timings=timings)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    finally:
        if data is not None:    # stop the device feed's thread
            data.close()
        source.close()          # the sampler's graph and its pool
    result["step"] = meta["step"]
    timings["total_s"] = time.perf_counter() - t0
    return result, timings


def main(argv: Optional[List[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    result, _ = evaluate(args)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
