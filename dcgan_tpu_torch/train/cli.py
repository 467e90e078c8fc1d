"""CLI of the trainer: the JAX package's flag names for the knobs this
slice serves, plus --device.

    python -m dcgan_tpu_torch.train --preset celeba64 --use_pallas \
        --pallas_fused --synthetic --max_steps 200
    python -m dcgan_tpu_torch.train --preset sagan64 --synthetic \
        --max_steps 200
    python -m dcgan_tpu_torch.train --preset sagan64 --synthetic \
        --max_steps 2 --device cpu --output_size 16 --attn_res 8 \
        --gf_dim 16 --df_dim 16 --z_dim 8 --batch_size 4

Flags given explicitly override the preset's values. Without --synthetic
it fails: the TFRecord data feed is not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

from dcgan_tpu_torch.presets import PRESETS, get_preset

# flag -> ("" for a TrainConfig field or "model", field name)
_FLAG_FIELDS = {
    "batch_size": ("", "batch_size"),
    "max_steps": ("", "max_steps"),
    "checkpoint_dir": ("", "checkpoint_dir"),
    "log_every_steps": ("", "log_every_steps"),
    "seed": ("", "seed"),
    "update_mode": ("", "update_mode"),
    "grad_clip": ("", "grad_clip"),
    "lr_schedule": ("", "lr_schedule"),
    "use_pallas": ("model", "use_pallas"),
    "pallas_fused": ("model", "pallas_fused"),
    "output_size": ("model", "output_size"),
    "gf_dim": ("model", "gf_dim"),
    "df_dim": ("model", "df_dim"),
    "z_dim": ("model", "z_dim"),
    "attn_res": ("model", "attn_res"),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dcgan_tpu_torch.train",
        description="DCGAN trainer on one GPU (PyTorch/CUDA port)",
        argument_default=argparse.SUPPRESS)
    p.add_argument("--preset", choices=sorted(PRESETS), default="celeba64")
    p.add_argument("--batch_size", type=int)
    p.add_argument("--max_steps", type=int)
    p.add_argument("--update_mode", choices=["sequential", "fused"])
    p.add_argument("--grad_clip", type=float,
                   help=">0 clips both nets' grads by global norm before "
                        "Adam")
    p.add_argument("--lr_schedule", choices=["constant", "linear", "cosine"])
    p.add_argument("--use_pallas", action="store_true",
                   help="BN moments and epilogue through the channel_moments "
                        "and scale_shift_act kernels")
    p.add_argument("--pallas_fused", action="store_true",
                   help="each interior G/D stage as the fused GEMM kernels "
                        "(requires --use_pallas)")
    p.add_argument("--output_size", type=int)
    p.add_argument("--gf_dim", type=int)
    p.add_argument("--df_dim", type=int)
    p.add_argument("--z_dim", type=int)
    p.add_argument("--attn_res", type=int,
                   help="feature-map resolution of the self-attention block "
                        "(0 = none; the sagan64 preset sets 32)")
    p.add_argument("--synthetic", action="store_true", default=False,
                   help="train on synthetic data (the only feed ported)")
    p.add_argument("--checkpoint_dir",
                   help="where events.jsonl is written")
    p.add_argument("--log_every_steps", type=int)
    p.add_argument("--seed", type=int)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' must be asked for by name")
    return p


def config_from_args(args: argparse.Namespace):
    """The preset's TrainConfig with the explicitly given flags applied."""
    top, model_kw = {}, {}
    for flag, value in vars(args).items():
        if flag in _FLAG_FIELDS:
            section, field = _FLAG_FIELDS[flag]
            (model_kw if section == "model" else top)[field] = value
    cfg = get_preset(args.preset)
    if model_kw:
        top["model"] = dataclasses.replace(cfg.model, **model_kw)
    return dataclasses.replace(cfg, **top) if top else cfg


def main(argv: Optional[List[str]] = None):
    """Parse, build the config, train; returns the final state."""
    args = build_parser().parse_args(argv)
    if not args.synthetic:
        raise SystemExit(
            "dcgan_tpu_torch.train: the TFRecord data feed is not ported "
            "yet; pass --synthetic")
    cfg = config_from_args(args)
    from dcgan_tpu_torch.train.trainer import train

    return train(cfg, synthetic_data=True, device=args.device)
