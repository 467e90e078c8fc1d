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
    python -m dcgan_tpu_torch.train --preset wgan-gp --synthetic \
        --max_steps 200
    python -m dcgan_tpu_torch.train --preset celeba64 --use_pallas \
        --pallas_fused --precision bf16 --n_critic 2 --grad_accum 2 \
        --diffaug color,translation,cutout --data_dir D --checkpoint_dir C
    python -m dcgan_tpu_torch.train --preset celeba64 --use_pallas \
        --pallas_fused --pipeline_gd --data_dir D --checkpoint_dir C
    python -m dcgan_tpu_torch.data.prepare --cifar10 \
        --input_dir cifar-10-batches-py --output_dir D
    python -m dcgan_tpu_torch.train --preset cifar10-cond --use_pallas \
        --pallas_fused --data_dir D --checkpoint_dir C
    python -m dcgan_tpu_torch.train --preset dcgan128 --synthetic
    python -m dcgan_tpu_torch.train --preset sagan128 --synthetic

Flags given explicitly override the preset's values. The run reads the
TFRecord shards of --data_dir (or synthetic data with --synthetic) and,
run again on the same --checkpoint_dir, resumes from its newest intact
checkpoint. SIGTERM or SIGINT stops the run at the next call boundary with
a final checkpoint; a non-finite loss on the --nan_check_steps cadence
aborts it with FloatingPointError.
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
    "loss": ("", "loss"),
    "gp_weight": ("", "gp_weight"),
    "r1_gamma": ("", "r1_gamma"),
    "r1_interval": ("", "r1_interval"),
    "n_critic": ("", "n_critic"),
    "grad_accum": ("", "grad_accum"),
    "diffaug": ("", "diffaug"),
    "precision": ("", "precision"),
    "sample_image_dir": ("", "sample_image_dir"),
    "activation_summary_steps": ("", "activation_summary_steps"),
    "grad_clip": ("", "grad_clip"),
    "lr_schedule": ("", "lr_schedule"),
    "steps_per_call": ("", "steps_per_call"),
    "aot_warmup": ("", "aot_warmup"),
    "nan_check_steps": ("", "nan_check_steps"),
    "pipeline_gd": ("", "pipeline_gd"),
    "use_pallas": ("model", "use_pallas"),
    "pallas_fused": ("model", "pallas_fused"),
    "output_size": ("model", "output_size"),
    "gf_dim": ("model", "gf_dim"),
    "df_dim": ("model", "df_dim"),
    "z_dim": ("model", "z_dim"),
    "attn_res": ("model", "attn_res"),
    "num_classes": ("model", "num_classes"),
    "conditional_bn": ("model", "conditional_bn"),
    "label_feature": ("", "label_feature"),
}

# --no_<x> flags -> the TrainConfig field they turn off
_NEGATED_FLAGS = {"no_normalize": "normalize_inputs",
                  "no_tensorboard": "tensorboard"}


def _parse_bool(text: str) -> bool:
    """The JAX CLI's {true,false} flag values."""
    lowered = text.lower()
    if lowered in ("1", "true", "yes", "on"):
        return True
    if lowered in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected true or false, got {text!r}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dcgan_tpu_torch.train",
        description="DCGAN trainer on one GPU (PyTorch/CUDA port)",
        argument_default=argparse.SUPPRESS)
    p.add_argument("--preset", choices=sorted(PRESETS), default="celeba64")
    p.add_argument("--batch_size", type=int)
    p.add_argument("--max_steps", type=int)
    p.add_argument("--update_mode", choices=["sequential", "fused"])
    p.add_argument("--loss", choices=["gan", "wgan-gp", "hinge"])
    p.add_argument("--n_critic", type=int,
                   help="D updates per G update (WGAN-GP canonical: 5)")
    p.add_argument("--grad_accum", type=int,
                   help=">1 accumulates that many microbatches per "
                        "optimizer update (batch_size must divide by it)")
    p.add_argument("--gp_weight", type=float,
                   help="WGAN-GP gradient-penalty coefficient")
    p.add_argument("--r1_gamma", type=float,
                   help=">0 adds R1 regularization ((gamma/2)*||grad D||^2 "
                        "on reals) to the gan/hinge families")
    p.add_argument("--r1_interval", type=int,
                   help="lazy regularization: compute R1 every k-th step "
                        "with gamma scaled by k (1 = every step)")
    p.add_argument("--diffaug",
                   help="DiffAugment policy for every D input, e.g. "
                        "'color,translation,cutout'; '' = off")
    p.add_argument("--precision", choices=["", "f32", "bf16", "fp8"],
                   help="f32 (float32 compute and params), bf16 (bf16 "
                        "params and compute, f32 Adam first moments), fp8 "
                        "(bf16 plus fp8 conv operands at >= 64 px stages); "
                        "'' leaves the model dtypes alone")
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
    p.add_argument("--num_classes", type=int,
                   help=">0 = class-conditional G/D (the cifar10-cond "
                        "preset sets 10)")
    p.add_argument("--conditional_bn", action="store_true",
                   help="conditional models: per-class BN affine in G "
                        "(not with --pallas_fused)")
    p.add_argument("--label_feature",
                   help="int64 class feature name in the records (used "
                        "when --num_classes > 0; default: label)")
    p.add_argument("--data_dir",
                   help="directory of TFRecord shards (default: train)")
    p.add_argument("--sample_image_dir",
                   help="held-out TFRecord shards of the sample-loss probe "
                        "(default: sample_data; skipped when absent)")
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
    p.add_argument("--activation_summary_steps", type=int,
                   help="per-layer activation histogram cadence (0 = off)")
    p.add_argument("--seed", type=int)
    p.add_argument("--steps_per_call", type=int,
                   help=">1: K steps as one captured CUDA graph (the step "
                        "cadences must be 0, multiples or divisors of K)")
    p.add_argument("--aot_warmup", action="store_true",
                   help="capture every program of the run after its first "
                        "step, writing perf/compile_ms/* capture times")
    p.add_argument("--nan_check_steps", type=int,
                   help="numerical-health gate cadence (0 = off): every "
                        "N steps a non-finite loss aborts the run with "
                        "FloatingPointError before the step is saved")
    p.add_argument("--pipeline_gd", type=_parse_bool, nargs="?", const=True,
                   metavar="{true,false}",
                   help="pipelined G/D dispatch: the step as three stage "
                        "programs (gen_fakes, d_update, g_update), D "
                        "training on the fake stack G produced during the "
                        "previous step (sequential update mode, "
                        "steps_per_call 1)")
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
