"""Standalone generation CLI: checkpoint -> images (the counterpart of
`dcgan_tpu/generate.py`).

    python -m dcgan_tpu_torch.generate --checkpoint_dir C --num_images 100
    python -m dcgan_tpu_torch.generate --checkpoint_dir C --grid 8x8 \
        --npz out.npz --use_ema --truncation 0.7 --seed 3
    python -m dcgan_tpu_torch.generate --checkpoint_dir C --interpolate

The architecture comes from the checkpoint's config.json unless --preset
or the model flags say otherwise (explicit flag > --preset > config.json >
defaults, `config.resolve_model_config`). The newest intact checkpoint is
restored through `Checkpointer.restore_latest`; --use_ema samples its
`ema_gen` weights, else the live ones.

Images come in batches of --batch_size through the sampler rungs of the
serving plane (serve/sources.py, captured CUDA graphs on the card): the
full batch is the top rung of `build_ladder(batch_size)`, and the tail
snaps to the smallest rung that covers it, so a run dispatches a few
fixed shapes. Grids (8x8 PNGs by default, the reference's sample-grid
format) are tiled from the whole pool into `gen_<step>_<chunk>.png` in
--out_dir; --npz also writes the images, float32 in tanh range, as
`images`.

z: batch i draws U(-1, 1) rows from a CPU `torch.Generator` seeded from
(--seed, i) through `np.random.SeedSequence` (`generate_z`), the rung's
size of them, scaled by --truncation; --interpolate draws its two
endpoint sets as batch 0. The draw does not depend on the device, so the
tests and chip_smoke.py rebuild the rows. It differs from the JAX
package's z for the same seed, which comes from `jax.random`; the two
packages agree on the same z rows.

A conditional model (num_classes K > 0) generates image i of class
i mod K, the cycle running on across batches, or every image of
--class_id (range-checked: an id outside [0, K) would one-hot to zeros);
--interpolate holds one class per grid row (row r of class r mod K, or
--class_id). --npz then also writes the images' `labels`. --class_id on
an unconditional model fails, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    from dcgan_tpu_torch.config import add_model_override_flags

    p = argparse.ArgumentParser(prog="dcgan_tpu_torch.generate",
                                description="generate images from a "
                                            "trained checkpoint")
    p.add_argument("--checkpoint_dir", required=True)
    p.add_argument("--out_dir", default="generated")
    p.add_argument("--num_images", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--grid", default="8x8",
                   help="RxC tiling per PNG (e.g. 8x8); 0 disables PNGs")
    p.add_argument("--npz", default=None,
                   help="also dump all images to this .npz")
    p.add_argument("--preset", default=None,
                   help="named config (presets.py) supplying the model "
                        "architecture instead of the checkpoint's "
                        "config.json; explicit flags override")
    add_model_override_flags(p)
    p.add_argument("--class_id", type=int, default=None,
                   help="conditional models: generate only this class")
    p.add_argument("--use_ema", action="store_true",
                   help="sample from the EMA generator weights the "
                        "checkpoint carries; default samples the live "
                        "weights")
    p.add_argument("--interpolate", action="store_true",
                   help="latent-space interpolation: each grid row walks z "
                        "linearly between two random endpoints")
    p.add_argument("--truncation", type=float, default=1.0,
                   help="scale z by psi in (0, 1] toward the prior's mode; "
                        "1 = off")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' must be asked for by name")
    return p


def _model_config(args: argparse.Namespace):
    from dcgan_tpu_torch.config import MODEL_OVERRIDE_FLAGS, \
        resolve_model_config

    return resolve_model_config(
        args.checkpoint_dir, preset=args.preset,
        overrides={name: getattr(args, name)
                   for name in MODEL_OVERRIDE_FLAGS})


def generate_z(seed: int, batch_idx: int, n: int, z_dim: int,
               truncation: float = 1.0) -> np.ndarray:
    """The z rows of batch `batch_idx`: n x z_dim U(-1, 1) from a CPU
    generator seeded from (seed, batch_idx), times `truncation`."""
    state = np.random.SeedSequence(
        [seed & 0xFFFFFFFFFFFFFFFF, batch_idx]).generate_state(1, np.uint64)
    gen = torch.Generator().manual_seed(int(state[0]))
    z = torch.rand((n, z_dim), generator=gen) * 2.0 - 1.0
    return (truncation * z).numpy()


def _grid(spec: str):
    if not spec or spec == "0":
        return None
    try:
        rows, cols = (int(v) for v in spec.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--grid must be RxC (e.g. 8x8) or 0, "
                         f"got {spec!r}") from None
    if rows < 1 or cols < 1:
        raise SystemExit(f"--grid dimensions must be >= 1, got {spec!r}")
    return rows, cols


def generate(args: argparse.Namespace) -> dict:
    """Runs generation; returns {"num_images", "step", "paths",
    "buckets" (the rung of each dispatch), "compile_ms" (each rung's
    capture ms)}."""
    from dcgan_tpu_torch.config import TrainConfig
    from dcgan_tpu_torch.device import resolve_device
    from dcgan_tpu_torch.serve.buckets import build_ladder
    from dcgan_tpu_torch.serve.sources import StateSource
    from dcgan_tpu_torch.train.steps import init_train_state
    from dcgan_tpu_torch.utils.checkpoint import Checkpointer
    from dcgan_tpu_torch.utils.images import save_sample_grid

    mcfg = _model_config(args)
    if args.batch_size < 1:
        raise SystemExit(f"--batch_size must be >= 1, got {args.batch_size}")
    if args.num_images < 1:
        raise SystemExit(f"--num_images must be >= 1, got {args.num_images}")
    if not 0.0 < args.truncation <= 1.0:
        raise SystemExit(
            f"--truncation must be in (0, 1], got {args.truncation}")
    if args.class_id is not None:
        if not mcfg.num_classes:
            raise SystemExit("--class_id requires a conditional model "
                             "(--num_classes > 0)")
        if not 0 <= args.class_id < mcfg.num_classes:
            raise SystemExit(
                f"--class_id {args.class_id} out of range "
                f"[0, {mcfg.num_classes}) — an out-of-range id would one-hot "
                "to all zeros and generate unconditioned images")
    grid = _grid(args.grid)
    if args.interpolate and not grid:
        raise SystemExit("--interpolate needs a grid (e.g. --grid 8x8)")

    dev = resolve_device(args.device)
    template = init_train_state(TrainConfig(model=mcfg), device=dev)
    state = Checkpointer(args.checkpoint_dir).restore_latest(template)
    if state is None:
        raise SystemExit(f"no checkpoint under {args.checkpoint_dir}")
    del template
    step = int(state["step"])
    source = StateSource(
        mcfg, state["ema_gen"] if args.use_ema else state["params"]["gen"],
        state["bn"]["gen"], device=dev)
    ladder = build_ladder(args.batch_size)
    os.makedirs(args.out_dir, exist_ok=True)

    k = mcfg.num_classes

    def classes(first: int, n: int) -> Optional[np.ndarray]:
        """The labels of n rows from row `first` of the class cycle, or
        --class_id's; None for an unconditional model."""
        if not k:
            return None
        if args.class_id is not None:
            return np.full((n,), args.class_id, np.int32)
        return np.arange(first, first + n, dtype=np.int32) % k

    # (z, labels or None, rows kept) per dispatch
    batches = []
    if args.interpolate:
        rows, cols = grid
        ends = generate_z(args.seed, 0, 2 * rows, mcfg.z_dim,
                          args.truncation).reshape(2, rows, mcfg.z_dim)
        t = np.linspace(0.0, 1.0, cols, dtype=np.float32)[None, :, None]
        z_all = ((1.0 - t) * ends[0][:, None, :]
                 + t * ends[1][:, None, :]).reshape(rows * cols,
                                                    mcfg.z_dim)
        # one class per grid row
        row_classes = classes(0, rows)
        labels_all = None if row_classes is None \
            else np.repeat(row_classes, cols)
        for lo in range(0, len(z_all), ladder.max_bucket):
            z = z_all[lo:lo + ladder.max_bucket]
            n = ladder.snap(len(z))
            # padding rows (z = 0, class 0) are sliced off
            pad = n - len(z)
            batches.append((
                np.concatenate([z, np.zeros((pad, mcfg.z_dim),
                                            np.float32)]),
                None if labels_all is None else np.concatenate(
                    [labels_all[lo:lo + len(z)], np.zeros(pad, np.int32)]),
                len(z)))
    else:
        made, i = 0, 0
        while made < args.num_images:
            remaining = args.num_images - made
            n = ladder.max_bucket if remaining >= ladder.max_bucket \
                else ladder.snap(remaining)
            take = min(n, remaining)
            # the class cycle runs on across batches, whatever the rung
            batches.append((generate_z(args.seed, i, n, mcfg.z_dim,
                                       args.truncation),
                            classes(made, n), take))
            made += take
            i += 1
    source.bind({len(z) for z, _, _ in batches})
    try:
        images = np.concatenate([
            source.sample(len(z), z, labels)[:take]
            for z, labels, take in batches]).astype(np.float32)
    finally:
        source.close()   # the rungs' graph pools go now

    paths: List[str] = []
    if args.interpolate:
        path = os.path.join(args.out_dir, f"interp_{step:08d}.png")
        save_sample_grid(path, images, grid)
        paths.append(path)
    elif grid:
        # tile from the full pool, not per batch, so grids larger than
        # batch_size still get written
        cells = grid[0] * grid[1]
        for chunk in range(len(images) // cells):
            path = os.path.join(args.out_dir,
                                f"gen_{step:08d}_{chunk:04d}.png")
            save_sample_grid(path, images[chunk * cells:(chunk + 1) * cells],
                             grid)
            paths.append(path)
        if not paths:
            print(f"[dcgan_tpu_torch.generate] warning: no PNGs written — "
                  f"--num_images {args.num_images} < grid {grid[0]}x"
                  f"{grid[1]} ({cells} cells); lower --grid or raise "
                  "--num_images", file=sys.stderr)
    if args.npz:
        arrays = {"images": images}
        if k:
            arrays["labels"] = np.concatenate(
                [labels[:take] for _, labels, take in batches])
        np.savez(args.npz, **arrays)
        paths.append(args.npz)
    return {"num_images": len(images), "step": step, "paths": paths,
            "buckets": [len(z) for z, _, _ in batches],
            "compile_ms": dict(source.compile_ms)}


def main(argv: Optional[List[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    result = generate(args)
    print(f"[dcgan_tpu_torch.generate] {result['num_images']} images from "
          f"checkpoint step {result['step']} -> "
          f"{result['paths'][-1] if result['paths'] else args.out_dir}",
          flush=True)
    return result


if __name__ == "__main__":
    main()
