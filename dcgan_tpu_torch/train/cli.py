"""CLI of the trainer: the JAX package's flag names for the knobs this
port serves, plus --device.

    python -m dcgan_tpu_torch.train --preset celeba64 --use_pallas \
        --pallas_fused --data_dir D --checkpoint_dir C
    python -m dcgan_tpu_torch.train --preset celeba64 --use_pallas \
        --pallas_fused --data_dir D --checkpoint_dir C --steps_per_call 4 \
        --aot_warmup
    python -m dcgan_tpu_torch.train --preset sagan64 --synthetic \
        --max_steps 200
    python -m dcgan_tpu_torch.train --preset sagan64 --synthetic \
        --max_steps 2 --device cpu --output_size 16 --attn_res 8 \
        --gf_dim 16 --df_dim 16 --z_dim 8 --batch_size 4

Flags given explicitly override the preset's values. The run reads the
TFRecord shards of --data_dir (or synthetic data with --synthetic) and,
run again on the same --checkpoint_dir, resumes from its newest intact
checkpoint.
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
    "data_dir": ("", "data_dir"),
    "shuffle_buffer": ("", "shuffle_buffer"),
    "num_loader_threads": ("", "num_loader_threads"),
    "record_dtype": ("", "record_dtype"),
    "prefetch_device_batches": ("", "prefetch_device_batches"),
    "max_corrupt_records": ("", "max_corrupt_records"),
    "checkpoint_dir": ("", "checkpoint_dir"),
    "sample_dir": ("", "sample_dir"),
    "save_summaries_secs": ("", "save_summaries_secs"),
    "save_model_secs": ("", "save_model_secs"),
    "max_checkpoints": ("", "max_checkpoints"),
    "sample_every_steps": ("", "sample_every_steps"),
    "log_every_steps": ("", "log_every_steps"),
    "seed": ("", "seed"),
    "update_mode": ("", "update_mode"),
    "grad_clip": ("", "grad_clip"),
    "lr_schedule": ("", "lr_schedule"),
    "steps_per_call": ("", "steps_per_call"),
    "aot_warmup": ("", "aot_warmup"),
    "use_pallas": ("model", "use_pallas"),
    "pallas_fused": ("model", "pallas_fused"),
    "output_size": ("model", "output_size"),
    "gf_dim": ("model", "gf_dim"),
    "df_dim": ("model", "df_dim"),
    "z_dim": ("model", "z_dim"),
    "attn_res": ("model", "attn_res"),
}

# --no_<x> flags -> the TrainConfig field they turn off
_NEGATED_FLAGS = {"no_normalize": "normalize_inputs",
                  "no_tensorboard": "tensorboard"}


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
    p.add_argument("--data_dir",
                   help="directory of TFRecord shards (default: train)")
    p.add_argument("--synthetic", action="store_true", default=False,
                   help="train on synthetic data (no shards needed)")
    p.add_argument("--no_normalize", action="store_true",
                   help="feed the raw pixel scale instead of [-1, 1]")
    p.add_argument("--record_dtype", choices=["float64", "float32", "uint8"],
                   help="wire format of shards without a dataset.json (a "
                        "manifest's record_dtype is adopted)")
    p.add_argument("--shuffle_buffer", type=int,
                   help="examples in the loader's shuffle pool")
    p.add_argument("--num_loader_threads", type=int)
    p.add_argument("--prefetch_device_batches", type=int,
                   help="batches the device feed keeps ready ahead of the "
                        "step (0: copied on the step's thread)")
    p.add_argument("--max_corrupt_records", type=int,
                   help=">0: quarantine (skip, log, count) corrupt records "
                        "up to this budget; 0: the first one is fatal")
    p.add_argument("--checkpoint_dir",
                   help="checkpoints, config.json, events.jsonl and the "
                        "TensorBoard files; a run resumes from it")
    p.add_argument("--sample_dir", help="where the sample grids go")
    p.add_argument("--no_tensorboard", action="store_true",
                   help="no TensorBoard event files (events.jsonl only)")
    p.add_argument("--save_summaries_secs", type=float)
    p.add_argument("--save_model_secs", type=float,
                   help="seconds between checkpoints")
    p.add_argument("--max_checkpoints", type=int,
                   help="checkpoints kept (the oldest pruned beyond this)")
    p.add_argument("--sample_every_steps", type=int,
                   help="steps between sample grids (0: none)")
    p.add_argument("--log_every_steps", type=int)
    p.add_argument("--seed", type=int)
    p.add_argument("--steps_per_call", type=int,
                   help=">1: K steps as one captured CUDA graph (the step "
                        "cadences must be 0, multiples or divisors of K)")
    p.add_argument("--aot_warmup", action="store_true",
                   help="capture every program of the run after its first "
                        "step, writing perf/compile_ms/* capture times")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' must be asked for by name")
    return p


def config_from_args(args: argparse.Namespace):
    """The preset's TrainConfig with the explicitly given flags applied."""
    top, model_kw = {}, {}
    for flag, value in vars(args).items():
        if flag in _NEGATED_FLAGS:
            top[_NEGATED_FLAGS[flag]] = not value
        elif flag in _FLAG_FIELDS:
            section, field = _FLAG_FIELDS[flag]
            (model_kw if section == "model" else top)[field] = value
    cfg = get_preset(args.preset)
    if model_kw:
        top["model"] = dataclasses.replace(cfg.model, **model_kw)
    return dataclasses.replace(cfg, **top) if top else cfg


def main(argv: Optional[List[str]] = None):
    """Parse, build the config, train; returns the final state."""
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    from dcgan_tpu_torch.train.trainer import train

    return train(cfg, synthetic_data=args.synthetic, device=args.device)
