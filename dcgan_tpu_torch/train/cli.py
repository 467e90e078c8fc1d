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
    python -m dcgan_tpu_torch.train --preset dcgan128 --use_pallas \
        --pallas_fused --progressive "32:2000,64:2000,128:*" \
        --progressive_fade_steps 500 --aot_warmup --data_dir "D_{res}"
    python -m dcgan_tpu_torch.train --preset sagan128 --synthetic
    torchrun --nproc_per_node 2 -m dcgan_tpu_torch.train --preset sagan128 \
        --mesh_model 2 --mesh_spatial --synthetic
    torchrun --nproc_per_node 4 -m dcgan_tpu_torch.train --preset sagan64 \
        --mesh_data 2 --mesh_model 2 --mesh_spatial --seq_strategy ulysses \
        --attn_heads 2 --synthetic
    python -m dcgan_tpu_torch.train --preset sngan-cifar10 --use_pallas \
        --data_dir D --checkpoint_dir C
    python -m dcgan_tpu_torch.train --preset stylegan64 --synthetic
    python -m dcgan_tpu_torch.train --arch resnet --loss wgan-gp \
        --n_critic 5 --learning_rate 1e-4 --beta1 0 --synthetic

Flags given explicitly override the preset's values. The run reads the
TFRecord shards of --data_dir (or synthetic data with --synthetic) and,
run again on the same --checkpoint_dir, resumes from its newest intact
checkpoint. SIGTERM or SIGINT stops the run at the next call boundary with
a final checkpoint; a non-finite loss on the --nan_check_steps cadence
aborts it with FloatingPointError, or with --nan_policy rollback restores
the last good snapshot and trains on:

    python -m dcgan_tpu_torch.train --preset celeba64 --use_pallas \
        --pallas_fused --synthetic --nan_policy rollback \
        --rollback_snapshot_steps 20 --max_rollbacks 3 \
        --rollback_lr_backoff 0.5 --collective_timeout_secs 60

A torch.profiler window of --profile_num_steps steps from
--profile_start_step goes to --profile_dir; touching the
--profile_trigger file captures the next window of a running job. Each
window is digested into perf/device/* rows and a `trace digest` line;
tools/trace_summary_torch.py prints a trace's programs:

    python -m dcgan_tpu_torch.train --preset celeba64 --use_pallas \
        --pallas_fused --data_dir D --checkpoint_dir C --profile_dir T \
        --profile_trigger C/trace_now --timing_window 20
    touch C/trace_now
    python tools/trace_summary_torch.py T
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

from dcgan_tpu_torch.presets import PRESETS, get_preset

# flag -> ("" for a TrainConfig field or "model", field name)
_FLAG_FIELDS = {
    "learning_rate": ("", "learning_rate"),
    "d_learning_rate": ("", "d_learning_rate"),
    "g_learning_rate": ("", "g_learning_rate"),
    "beta1": ("", "beta1"),
    "warmup_steps": ("", "warmup_steps"),
    "g_ema_decay": ("", "g_ema_decay"),
    "label_smoothing": ("", "label_smoothing"),
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
    "fid_every_steps": ("", "fid_every_steps"),
    "fid_num_samples": ("", "fid_num_samples"),
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
    "nan_policy": ("", "nan_policy"),
    "rollback_snapshot_steps": ("", "rollback_snapshot_steps"),
    "max_rollbacks": ("", "max_rollbacks"),
    "rollback_lr_backoff": ("", "rollback_lr_backoff"),
    "async_services": ("", "async_services"),
    "flight_recorder_steps": ("", "flight_recorder_steps"),
    "collective_timeout_secs": ("", "collective_timeout_secs"),
    "pipeline_gd": ("", "pipeline_gd"),
    "progressive": ("", "progressive"),
    "progressive_fade_steps": ("", "progressive_fade_steps"),
    "profile_dir": ("", "profile_dir"),
    "profile_start_step": ("", "profile_start_step"),
    "profile_num_steps": ("", "profile_num_steps"),
    "profile_trigger": ("", "profile_trigger"),
    "timing_window": ("", "timing_window"),
    "arch": ("model", "arch"),
    "use_pallas": ("model", "use_pallas"),
    "pallas_fused": ("model", "pallas_fused"),
    "output_size": ("model", "output_size"),
    "c_dim": ("model", "c_dim"),
    "gf_dim": ("model", "gf_dim"),
    "df_dim": ("model", "df_dim"),
    "z_dim": ("model", "z_dim"),
    "attn_res": ("model", "attn_res"),
    "attn_heads": ("model", "attn_heads"),
    "seq_strategy": ("model", "attn_seq_strategy"),
    "spectral_norm": ("model", "spectral_norm"),
    "num_classes": ("model", "num_classes"),
    "conditional_bn": ("model", "conditional_bn"),
    "label_feature": ("", "label_feature"),
    "mesh_data": ("mesh", "data"),
    "mesh_model": ("mesh", "model"),
    "mesh_spatial": ("mesh", "spatial"),
    "mesh_shard_opt": ("mesh", "shard_opt"),
    "zero_stage": ("mesh", "zero_stage"),
    "backend": ("", "backend"),
    "comm_overlap": ("", "comm_overlap"),
    "comm_bucket_mb": ("", "comm_bucket_mb"),
}

# the JAX CLI's live-elastic flags: refused by name when given
ELASTIC_UNPORTED = (
    "live elasticity (--elastic_target_devices, --elastic_notice_file) is "
    "not ported to dcgan_tpu_torch yet (ROADMAP Queue A item 10)")

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
    p.add_argument("--learning_rate", type=float)
    p.add_argument("--d_learning_rate", type=float,
                   help="TTUR: discriminator base lr (default: "
                        "learning_rate)")
    p.add_argument("--g_learning_rate", type=float,
                   help="TTUR: generator base lr (default: learning_rate)")
    p.add_argument("--beta1", type=float)
    p.add_argument("--warmup_steps", type=int)
    p.add_argument("--g_ema_decay", type=float,
                   help="EMA decay for a shadow copy of generator weights "
                        "used for sampling (0 = off, reference parity; "
                        "typical 0.999)")
    p.add_argument("--label_smoothing", type=float,
                   help="one-sided label smoothing: D's real target "
                        "becomes 1-eps (gan loss only)")
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
    p.add_argument("--arch", choices=["dcgan", "resnet", "stylegan"],
                   help="model family: the reference's DCGAN stacks, the "
                        "WGAN-GP/SNGAN residual blocks, or StyleGAN2-lite "
                        "(modulated convs + resnet critic; pair with "
                        "--r1_gamma)")
    p.add_argument("--output_size", type=int)
    p.add_argument("--c_dim", type=int)
    p.add_argument("--gf_dim", type=int)
    p.add_argument("--df_dim", type=int)
    p.add_argument("--z_dim", type=int)
    p.add_argument("--attn_res", type=int,
                   help="feature-map resolution of the self-attention block "
                        "(0 = none; the sagan64 preset sets 32)")
    p.add_argument("--attn_heads", type=int,
                   help="attention heads (1 = SAGAN paper; apply-time "
                        "split, checkpoint-compatible across head counts)")
    p.add_argument("--seq_strategy", choices=["ring", "ulysses"],
                   help="sequence-parallel attention under --mesh_spatial: "
                        "ppermute ring vs two all_to_alls (Ulysses; needs "
                        "attn_heads divisible by the model axis)")
    p.add_argument("--spectral_norm", choices=["none", "d", "gd"],
                   help="spectral-normalize discriminator (d) or both nets' "
                        "(gd) weights — SN-GAN / SAGAN Lipschitz control")
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
    p.add_argument("--fid_every_steps", type=int,
                   help=">0: periodic in-training surrogate FID/KID probe "
                        "against the held-out sample stream (eval/fid + "
                        "eval/kid scalars, the best-scoring state kept in "
                        "<checkpoint_dir>/best); 0 = off")
    p.add_argument("--fid_num_samples", type=int,
                   help="samples per side for the in-training FID probe "
                        "(default 2048)")
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
    p.add_argument("--nan_policy", choices=["abort", "rollback"],
                   help="tripped NaN gate: abort with step context "
                        "(reference parity) or restore the last-good "
                        "snapshot, skip the offending batch window, and "
                        "keep training (bounded by --max_rollbacks)")
    p.add_argument("--rollback_snapshot_steps", type=int,
                   help="with --nan_policy rollback: snapshot the "
                        "gate-verified state every K steps (the restore "
                        "point)")
    p.add_argument("--max_rollbacks", type=int,
                   help="rollbacks allowed per run before the gate aborts "
                        "anyway")
    p.add_argument("--rollback_lr_backoff", type=float,
                   help="<1.0: multiply both base learning rates by this "
                        "on every rollback (1.0 = off)")
    p.add_argument("--async_services", type=_parse_bool,
                   metavar="{true,false}",
                   help="run the telemetry tails (event-file IO, sample "
                        "PNGs, probe writes) on a background executor; "
                        "--async_services=false runs every service inline "
                        "on the dispatch thread (identical metric values "
                        "and event structure)")
    p.add_argument("--flight_recorder_steps", type=int,
                   help="crash flight recorder: ring of the last K "
                        "per-step telemetry records dumped as JSONL on "
                        "watchdog trip / NaN abort / coordinated stop / "
                        "uncaught exception (crash-path-only IO; 0 = off)")
    p.add_argument("--collective_timeout_secs", type=float,
                   help=">0 arms the hung-section watchdog: a deadline "
                        "around each dispatch/save/restore section that "
                        "dumps the stacks and exits 43 on expiry so the "
                        "launcher restarts the job instead of hanging; "
                        "0 = off")
    p.add_argument("--pipeline_gd", type=_parse_bool, nargs="?", const=True,
                   metavar="{true,false}",
                   help="pipelined G/D dispatch: the step as three stage "
                        "programs (gen_fakes, d_update, g_update), D "
                        "training on the fake stack G produced during the "
                        "previous step (sequential update mode, "
                        "steps_per_call 1)")
    p.add_argument("--progressive",
                   help="progressive-resolution schedule (phase table "
                        "\"RES:STEPS[:BATCH],...,RES:*\", e.g. "
                        "\"32:2000,64:2000,128:*\"): train each phase at "
                        "its resolution and switch mid-run with no "
                        "capture after --aot_warmup (every phase's "
                        "programs captured at startup). Resolutions "
                        "ascend to --output_size; state carries across "
                        "the model growth (new layers init fresh); "
                        "loaders re-open at each phase's decode "
                        "resolution ({res} in --data_dir substitutes per "
                        "phase); each checkpoint's manifest records the "
                        "phase so resumes land mid-schedule correctly")
    p.add_argument("--progressive_fade_steps", type=int,
                   help=">0 with --progressive: linear fade-in over the "
                        "first N steps of each later phase (real images "
                        "blend toward their previous-resolution content)")
    # trace capture (torch.profiler) and step timing
    p.add_argument("--profile_dir",
                   help="capture a torch.profiler trace into this dir")
    p.add_argument("--profile_start_step", type=int)
    p.add_argument("--profile_num_steps", type=int)
    p.add_argument("--profile_trigger",
                   help="on-demand tracing: touch this file mid-run to "
                        "capture the next --profile_num_steps steps (the "
                        "file is deleted as the ack; touch again for "
                        "another capture); each capture is digested into "
                        "perf/device/* events — compute/collective/"
                        "idle-gap ms and the device's own step time")
    p.add_argument("--timing_window", type=int,
                   help="sliding window (steps) for step-time stats")
    # data parallelism over processes (one per GPU): the JAX mesh flags
    p.add_argument("--mesh_data", type=int,
                   help="data-parallel axis size (-1 = all devices)")
    p.add_argument("--mesh_model", type=int,
                   help="second mesh axis size: with --mesh_spatial the "
                        "ranks that split image height (tensor "
                        "parallelism without it is not ported)")
    p.add_argument("--backend", choices=["gspmd", "shard_map"],
                   help="collective strategy: gspmd = jit + sharding "
                        "annotations; shard_map = explicit per-device "
                        "psum/pmean (DP-only, composes with --use_pallas)")
    p.add_argument("--mesh_shard_opt", action="store_true",
                   help="ZeRO-1: shard optimizer state over the data axis "
                        "(reduce-scatter/all-gather weight updates)")
    p.add_argument("--zero_stage", type=int, choices=[1, 2, 3],
                   help="state-sharding stage (both backends): 1 = today's "
                        "behavior (parity); 2 = gradients + optimizer state "
                        "shard over the data axis (reduce-scatter grads, "
                        "shard-local Adam, one fused all-gather rebuilds "
                        "params per update); 3 = params + EMA additionally "
                        "stay resident sharded between steps with a just-"
                        "in-time all-gather inside each forward. Stages "
                        ">= 2 need a data axis of size > 1")
    p.add_argument("--comm_overlap", choices=["off", "bucket", "prefetch"],
                   help="collective overlap plane (DESIGN §6n): off = "
                        "per-leaf ZeRO collectives (parity); bucket = pack "
                        "leaves into dtype-grouped flat buffers, one large "
                        "collective per bucket (bit-exact); prefetch "
                        "(zero_stage=3 only) = bucket plus layer-ahead "
                        "staged param gathers so gather i+1 overlaps "
                        "compute i")
    p.add_argument("--comm_bucket_mb", type=int,
                   help="bucket size cap in MiB for --comm_overlap (per "
                        "dtype group; an oversized leaf gets its own "
                        "bucket)")
    p.add_argument("--mesh_spatial", action="store_true",
                   help="use the model axis to shard image height instead of "
                        "weights (conv halo exchange; the sequence-parallel "
                        "attention path)")
    p.add_argument("--elastic_target_devices", type=int,
                   help=">0 arms live in-run elasticity (not ported: "
                        "refused)")
    p.add_argument("--elastic_notice_file", type=str,
                   help="with --elastic_target_devices: the notice file "
                        "(not ported: refused)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' must be asked for by name "
                        "(a process of a torchrun world takes "
                        "cuda:LOCAL_RANK)")
    return p


def config_from_args(args: argparse.Namespace):
    """The preset's TrainConfig with the explicitly given flags applied."""
    given = vars(args)
    if given.get("elastic_target_devices") or \
            given.get("elastic_notice_file"):
        raise NotImplementedError(ELASTIC_UNPORTED)
    top, sections = {}, {"model": {}, "mesh": {}}
    for flag, value in given.items():
        if flag in _NEGATED_FLAGS:
            top[_NEGATED_FLAGS[flag]] = not value
        elif flag in _FLAG_FIELDS:
            section, field = _FLAG_FIELDS[flag]
            (sections[section] if section else top)[field] = value
    cfg = get_preset(args.preset)
    for section, kw in sections.items():
        if kw:
            top[section] = dataclasses.replace(getattr(cfg, section), **kw)
    return dataclasses.replace(cfg, **top) if top else cfg


def main(argv: Optional[List[str]] = None):
    """Parse, build the config, train; returns the final state."""
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    from dcgan_tpu_torch.train.trainer import train

    return train(cfg, synthetic_data=args.synthetic, device=args.device)
