#!/usr/bin/env python3
"""Write the JAX package's fixed-seed random feature tower
(`dcgan_tpu.evals.features.make_random_feature_fn`) as an npz in the
schema `make_npz_feature_fn` reads (`conv{i}/w` HWIO, `conv{i}/b`,
`proj`), on a host where JAX is installed:

    python tools/export_feature_tower.py --image_size 64 --out tower64.npz

Both packages load that file with their own `make_npz_feature_fn`, so
`python -m dcgan_tpu.evals --feature_npz tower64.npz` and `python -m
dcgan_tpu_torch.evals --feature_npz tower64.npz` score with the very tower
that the JAX package uses by default: the way to compare the two
packages' FID, KID and PRDC. (The port's own default tower is drawn from
a `torch.Generator`, not from `jax.random`, and scores differently.)

The weights are drawn here as `make_random_feature_fn` draws them, from
the same keys, so its features and those of the exported npz agree
(tests/test_torch_evals.py checks this under JAX's `make_npz_feature_fn`).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def tower_arrays(image_size: int, c_dim: int = 3, *,
                 feature_dim: int = 512, base_ch: int = 32,
                 seed: int = 42) -> Dict[str, np.ndarray]:
    """The arrays of `make_random_feature_fn(image_size, c_dim,
    feature_dim=, base_ch=, seed=)`'s tower, by npz name."""
    import jax
    import jax.numpy as jnp

    from dcgan_tpu.ops.layers import conv2d_init

    n_stages = max(1, int(np.log2(image_size / 4)))
    keys = jax.random.split(jax.random.key(seed), n_stages + 1)
    arrays: Dict[str, np.ndarray] = {}
    in_ch, total = c_dim, 0
    for i in range(n_stages):
        out_ch = base_ch * (2 ** i)
        conv = conv2d_init(keys[i], in_ch, out_ch)
        arrays[f"conv{i}/w"] = np.asarray(conv["w"])
        arrays[f"conv{i}/b"] = np.asarray(conv["b"])
        total += out_ch
        in_ch = out_ch
    proj = jax.random.normal(keys[-1], (total, feature_dim), jnp.float32)
    arrays["proj"] = np.asarray(
        proj / jnp.sqrt(jnp.asarray(total, jnp.float32)))
    return arrays


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="write the JAX package's default random feature tower "
                    "as an npz for --feature_npz")
    p.add_argument("--image_size", type=int, required=True,
                   help="the scored images' size (the model's output_size)")
    p.add_argument("--c_dim", type=int, default=3)
    p.add_argument("--feature_dim", type=int, default=512)
    p.add_argument("--base_ch", type=int, default=32)
    p.add_argument("--seed", type=int, default=42,
                   help="make_random_feature_fn's default seed")
    p.add_argument("--out", required=True, help="the npz to write")
    p.add_argument("--platform", default="cpu",
                   help="the JAX platform that draws the weights")
    args = p.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", args.platform)
    arrays = tower_arrays(args.image_size, args.c_dim,
                          feature_dim=args.feature_dim,
                          base_ch=args.base_ch, seed=args.seed)
    np.savez(args.out, **arrays)
    print(f"wrote {len(arrays) // 2} conv stages and proj "
          f"{arrays['proj'].shape} to {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
