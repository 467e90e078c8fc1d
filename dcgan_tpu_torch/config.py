"""Model and training configuration: copies of `dcgan_tpu/config.py`'s
`ModelConfig` and of the `TrainConfig` fields the port serves, and of its
`save_config` / `load_config`.

Same field names, defaults and validation as the JAX package's, so each
package's `config.json` loads in the other. The port serves and trains
the three model families (`arch`): the DCGAN stacks, the residual
SNGAN/WGAN-GP stacks ("resnet") and StyleGAN2-lite ("stylegan", with the
residual critic), with or without the SAGAN additions (a self-attention
block at `attn_res`, spectral norm on D or on both nets, the hinge loss)
and with or without class conditioning (`num_classes`: a one-hot of the
label on G's z and as constant maps on D's image; `conditional_bn`: G's
BatchNorm affine per class), on the BCE, hinge or WGAN-GP loss, with R1,
n_critic, gradient accumulation, DiffAugment and the f32/bf16/fp8
precision policies, on one resolution or on a progressive schedule of
them, with the one-process fault tolerance (`nan_policy="rollback"` and
its snapshot cadence, budget and LR backoff, the async host services, the
flight recorder and the watchdog). It refuses, with
`NotImplementedError`, a penalty (WGAN-GP, R1) whose critic's second
derivative would meet a kernel: the JAX package cannot differentiate a
Pallas kernel twice, so it cannot trace a penalty through the DCGAN
stacks' BatchNorm under `use_pallas` nor through an attention block on
the flash kernels. The residual
critic is norm-free and G's kernels never see the penalty's double
backward (D's loss takes G's images detached), so resnet and stylegan
train their penalties under `use_pallas`.

`MeshConfig` and the TrainConfig fields `mesh`, `backend`, `comm_overlap`
and `comm_bucket_mb` are the JAX package's, with its names, defaults and
checks. The port trains over processes, one per GPU (parallel/api.py):
data parallelism (`model` 1), and the spatial mesh (`model` > 1 with
`spatial`: the model axis splits image height, parallel/spatial.py, and
the attention runs sequence-parallel over it, `attn_seq_strategy`). Tensor
parallelism (`model` > 1 without `spatial`), the ZeRO stages (`shard_opt`,
`zero_stage` >= 2) and the bucketed collectives (`comm_overlap` other than
"off") raise `NotImplementedError` naming ROADMAP Queue A item 7, as do
the settings the spatial step does not run yet (SPATIAL_UNPORTED).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
from typing import Any, Dict, Optional, Tuple

CONFIG_FILENAME = "config.json"

# TrainConfig.precision -> (compute_dtype, param_dtype, quant), the JAX
# package's policy table
PRECISION_POLICY = {"f32": ("float32", "float32", ""),
                    "bf16": ("bfloat16", "bfloat16", ""),
                    "fp8": ("bfloat16", "bfloat16", "fp8")}

DIFFAUG_POLICIES = ("color", "translation", "cutout")


def parse_policy(spec: str) -> Tuple[str, ...]:
    """DiffAugment's "color,translation" -> a validated tuple; "" -> ()."""
    if not spec:
        return ()
    parts = tuple(p.strip() for p in spec.split(",") if p.strip())
    for p in parts:
        if p not in DIFFAUG_POLICIES:
            raise ValueError(
                f"unknown diffaug policy {p!r}; available: "
                f"{DIFFAUG_POLICIES}")
    return parts


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture knobs (field-for-field the JAX `ModelConfig`)."""

    arch: str = "dcgan"
    output_size: int = 64
    gf_dim: int = 64
    df_dim: int = 64
    c_dim: int = 3
    z_dim: int = 100
    num_classes: int = 0
    conditional_bn: bool = False
    base_size: int = 4
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5
    leak: float = 0.2
    kernel_size: int = 5
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    use_pallas: bool = False       # BN epilogue through the scale_shift_act
                                   # kernel (ops/kernels.py)
    bn_pallas: Optional[bool] = None  # narrows the BN half of use_pallas
    pallas_fused: bool = False     # interior G stages as one
                                   # gemm_bias_scale_act kernel (ops/fused.py)
    quant: str = ""                # "fp8": fp8 operands at >= 64 px
                                   # stages (set by TrainConfig.precision)
    attn_res: int = 0
    attn_heads: int = 1
    attn_seq_strategy: str = "ring"
    spectral_norm: str = "none"

    @property
    def bn_use_pallas(self) -> bool:
        """Whether BatchNorm takes the kernel route: use_pallas unless
        bn_pallas overrides it."""
        return self.use_pallas if self.bn_pallas is None else self.bn_pallas

    @property
    def num_up_layers(self) -> int:
        """Number of stride-2 deconv stages (64 px -> 4)."""
        return int(round(math.log2(self.output_size / self.base_size)))

    def __post_init__(self):
        # the JAX package's own validation first, with its messages
        if self.arch not in ("dcgan", "resnet", "stylegan"):
            raise ValueError(
                f"arch must be 'dcgan', 'resnet', or 'stylegan', got "
                f"{self.arch!r}")
        if self.bn_pallas and not self.use_pallas:
            raise ValueError("bn_pallas=True requires use_pallas=True")
        if self.pallas_fused:
            if not self.use_pallas:
                raise ValueError(
                    "pallas_fused=True requires use_pallas=True")
            if self.arch != "dcgan":
                raise ValueError(
                    "pallas_fused=True supports arch='dcgan' only")
            if self.conditional_bn:
                raise ValueError(
                    "pallas_fused=True is incompatible with conditional_bn")
        if self.quant not in ("", "fp8"):
            raise ValueError(
                f"model.quant must be '' or 'fp8', got {self.quant!r}")
        n = self.num_up_layers
        if n < 1 or self.base_size * (2 ** n) != self.output_size:
            raise ValueError(
                f"output_size={self.output_size} must be base_size*2^k with "
                f"k >= 1 (base_size={self.base_size})")
        if self.attn_res:
            sites = {self.base_size * (2 ** j) for j in range(n)}
            if self.attn_res not in sites:
                raise ValueError(
                    f"attn_res={self.attn_res} is not a feature-map "
                    f"resolution of this stack; choose one of {sorted(sites)}")
        if self.spectral_norm not in ("none", "d", "gd"):
            raise ValueError(
                f"spectral_norm must be 'none', 'd', or 'gd', got "
                f"{self.spectral_norm!r}")
        if self.attn_heads < 1:
            raise ValueError(
                f"attn_heads must be >= 1, got {self.attn_heads}")
        if self.attn_seq_strategy not in ("ring", "ulysses"):
            raise ValueError(
                f"attn_seq_strategy must be 'ring' or 'ulysses', got "
                f"{self.attn_seq_strategy!r}")
        if self.conditional_bn and not self.num_classes:
            raise ValueError(
                "conditional_bn requires a conditional model "
                "(num_classes > 0)")
        if self.arch == "stylegan":
            if self.conditional_bn:
                raise ValueError(
                    "arch='stylegan' has no BatchNorm to condition "
                    "(styles carry conditioning); drop conditional_bn")
            if self.attn_res:
                raise ValueError(
                    "arch='stylegan' has no attention site wired; use "
                    "arch='dcgan'/'resnet' for attn_res")
            if self.spectral_norm == "gd":
                raise ValueError(
                    "arch='stylegan' supports spectral_norm='d' (critic "
                    "only) — SN on a style-modulated generator is not "
                    "wired")


# what the port's parallelism does not run yet, and where it waits
MESH_UNPORTED = "not ported to dcgan_tpu_torch yet (ROADMAP Queue A item 7)"

# what the JAX gspmd step runs under a spatial mesh and the port's spatial
# step does not: (the TrainConfig's test, the setting's name)
SPATIAL_UNPORTED = (
    (lambda c: c.model.arch != "dcgan", "arch other than 'dcgan'"),
    (lambda c: c.model.num_classes > 0, "class conditioning"),
    (lambda c: bool(c.diffaug), "DiffAugment"),
    (lambda c: c.loss == "wgan-gp" or c.r1_gamma > 0,
     "the gradient penalties (WGAN-GP, R1)"),
    (lambda c: bool(c.progressive), "a progressive schedule"),
    (lambda c: c.pipeline_gd, "the pipelined G/D step"),
    (lambda c: c.precision == "fp8", "the fp8 policy"),
)


@dataclasses.dataclass(frozen=True, eq=False)
class MeshConfig:
    """The device mesh (`dcgan_tpu/config.py:214-289`): a `data` axis of
    ranks that split the batch and a second `model` axis. In the port
    every rank is one process with one GPU (parallel/distributed.py), so
    the mesh covers the world's ranks.

    Equality is by field, also against the JAX package's MeshConfig, so
    a config loaded from either package's `config.json` compares equal
    to the one it was written from."""

    data: int = -1                 # data-parallel axis size; -1 = every
                                   # rank of the world
    model: int = 1                 # second mesh axis size (1 = off)
    spatial: bool = False          # the model axis shards image height
    shard_opt: bool = False        # ZeRO-1: Adam moments sharded over data
    zero_stage: int = 1            # 1: replicated state; 2, 3: ZeRO-2/3

    def __post_init__(self):
        # the JAX package's checks, with its messages
        if self.zero_stage not in (1, 2, 3):
            raise ValueError(
                f"zero_stage must be 1, 2, or 3, got {self.zero_stage}")
        if self.zero_stage >= 2 and self.spatial:
            raise ValueError(
                "zero_stage >= 2 does not compose with spatial meshes "
                "(spatial mode replicates all weights by policy — there is "
                "no per-leaf dim left for the data-axis state shards); use "
                "zero_stage=1 with spatial=True")
        if self.spatial and self.model <= 1:
            raise ValueError(
                "spatial=True repurposes the 'model' mesh axis to shard image "
                f"height, which needs model > 1 (got model={self.model}); "
                "with model=1 the run would silently be plain data "
                "parallelism")
        # then what the port's parallelism does not run
        unported = [f"{k}={v!r}" for k, v, default in (
            ("shard_opt", self.shard_opt, False),
            ("zero_stage", self.zero_stage, 1)) if v != default]
        if self.model > 1 and not self.spatial:
            unported.insert(0, f"model={self.model} without spatial")
        if unported:
            raise NotImplementedError(
                f"mesh {', '.join(unported)}: tensor parallelism and the "
                f"ZeRO stages are {MESH_UNPORTED}")

    def __eq__(self, other):
        if type(other).__name__ != "MeshConfig" \
                or not dataclasses.is_dataclass(other):
            return NotImplemented
        return dataclasses.asdict(self) == dataclasses.asdict(other)

    def __hash__(self):
        return hash(tuple(sorted(dataclasses.asdict(self).items())))

    def axis_sizes(self, n_devices: int) -> Tuple[int, int]:
        """(data, model) over `n_devices` ranks, as the JAX package
        computes them: data=-1 takes every rank, a fixed data that does
        not cover them raises."""
        if self.model < 1:
            raise ValueError(f"model axis must be >= 1, got {self.model}")
        model = self.model
        if self.data > 0:
            data = self.data
        else:
            if n_devices % model != 0:
                raise ValueError(
                    f"model axis {model} does not divide {n_devices} devices")
            data = n_devices // model
        if data * model != n_devices:
            raise ValueError(
                f"mesh {data}x{model} does not cover {n_devices} devices")
        return data, model


def celeba64(**overrides) -> ModelConfig:
    """The model of the `celeba64` preset: DCGAN 64x64, z=100, gf_dim=64,
    bf16 compute over f32 params (the reference's headline workload)."""
    return dataclasses.replace(ModelConfig(output_size=64), **overrides)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The run knobs of the training slice, field-for-field (names and
    defaults) the JAX `TrainConfig`'s."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    learning_rate: float = 2e-4
    d_learning_rate: Optional[float] = None  # None = learning_rate
    g_learning_rate: Optional[float] = None
    lr_schedule: str = "constant"  # "constant" | "linear" | "cosine" to 0
    warmup_steps: int = 0          # linear warmup from 0 before the schedule
    beta1: float = 0.5
    batch_size: int = 64
    max_steps: int = 1_200_000
    loss: str = "gan"              # BCE non-saturating | "wgan-gp" |
                                   # "hinge"
    gp_weight: float = 10.0        # WGAN-GP gradient-penalty coefficient
    r1_gamma: float = 0.0          # >0 adds (gamma/2) E[|grad_x D(x)|^2]
                                   # on the reals to D's loss ("gan" and
                                   # "hinge" only)
    r1_interval: int = 1           # lazy R1: the penalty every k-th step,
                                   # gamma scaled by k
    n_critic: int = 1              # D updates per G update, each on fresh
                                   # z against the same real batch
    update_mode: str = "sequential"  # D step, then G against the updated D;
                                     # "fused": both from the same params
    grad_accum: int = 1            # microbatches per optimizer update,
                                   # gradients accumulated in f32
    diffaug: str = ""              # DiffAugment on every D input: a comma
                                   # list of color, translation, cutout
    grad_clip: float = 0.0         # >0 clips each net's grads by global norm
    label_smoothing: float = 0.0   # one-sided: D's real target 1 - eps
    g_ema_decay: float = 0.0       # 0: ema_gen mirrors the live G weights
    # data (TFRecord shards, data/pipeline.py)
    data_dir: str = "train"
    label_feature: str = "label"   # int64 per-example class feature, read
                                   # when model.num_classes > 0
    sample_image_dir: str = "sample_data"  # the held-out shards of the
                                   # eval_losses probe (synthetic runs use
                                   # the synthetic stream at seed + 100)
    shuffle_buffer: int = 10_776   # shuffle pool: 10% of a CelebA epoch
    num_loader_threads: int = 16
    normalize_inputs: bool = True  # map reals to [-1,1]
    record_dtype: str = "float64"  # on-disk pixel dtype (dataset.json's
                                   # wins when the shards have one)
    prefetch_device_batches: int = 2  # batches the device feed keeps ready
    max_corrupt_records: int = 0   # >0: quarantine up to this many corrupt
                                   # records instead of failing
    # checkpoints, events and sample grids
    checkpoint_dir: str = "checkpoint"
    sample_dir: str = "samples"
    tensorboard: bool = True       # mirror events into TensorBoard files
    save_summaries_secs: float = 10.0  # MetricWriter.ready()'s interval
    save_model_secs: float = 600.0  # checkpoint cadence (wall clock)
    save_model_steps: int = 1000   # the JAX package's multi-host cadence
    max_checkpoints: int = 5       # checkpoints kept
    sample_every_steps: int = 100  # 0: no sample grids
    sample_grid: Tuple[int, int] = (8, 8)
    sample_size: int = 64          # rows of the fixed sample z
    fid_every_steps: int = 0       # >0: the in-training surrogate FID/KID
                                   # probe (evals/) against the held-out
                                   # stream every N steps, written as
                                   # eval/fid + eval/kid scalars, the best
                                   # scoring state kept in
                                   # <checkpoint_dir>/best; 0 = off
    fid_num_samples: int = 2048    # samples per side of the probe (small
                                   # by design: KID is unbiased at small n,
                                   # and the probe's job is the trend, not
                                   # the FID-50k headline)
    log_every_steps: int = 1
    nan_check_steps: int = 100     # every N steps the step's metrics must
                                   # be finite, else the run raises
                                   # FloatingPointError (0 = off)
    nan_policy: str = "abort"      # what a tripped NaN gate does: "abort"
                                   # (raise with step context) |
                                   # "rollback" (restore the last-good
                                   # snapshot, skip the offending batch
                                   # window, train on — train/rollback.py)
    rollback_snapshot_steps: int = 100  # nan_policy="rollback": copy the
                                   # gate-verified state every K steps (the
                                   # restore point; a device-side copy)
    max_rollbacks: int = 3         # rollbacks allowed per run before the
                                   # gate aborts anyway
    rollback_lr_backoff: float = 1.0  # <1.0: multiply both nets' base
                                   # learning rates by this on every
                                   # rollback (read by the captured step
                                   # from a device scalar: nothing is
                                   # captured again); 1.0 = off
    async_services: bool = True    # telemetry tails (event-file IO, grid
                                   # PNGs, the probes' writes) on one
                                   # background worker with drop-oldest
                                   # backpressure (train/services.py);
                                   # False runs each inline at its call
                                   # site
    flight_recorder_steps: int = 64  # ring of the last K per-step records,
                                   # dumped as flight_recorder.jsonl on a
                                   # NaN abort, a stop, a watchdog trip or
                                   # an uncaught exception; 0 = off
    collective_timeout_secs: float = 0.0  # >0 arms the watchdog
                                   # (train/coordination.py): a deadline on
                                   # each call's dispatch and readback, the
                                   # rollback restore and the save; on
                                   # expiry every thread's stack is dumped
                                   # and the process exits 43. A call that
                                   # captures a graph is exempt. 0 = off
    activation_summary_steps: int = 500  # per-layer activation histograms
                                   # and sparsity (0: none)
    seed: int = 0
    precision: str = ""            # "" leaves the model dtypes; "f32"
                                   # forces float32 compute and params;
                                   # "bf16" bf16 params and compute with
                                   # f32 Adam first moments; "fp8" that
                                   # plus fp8 operands at >= 64 px stages
    steps_per_call: int = 1        # >1: K steps as one captured CUDA graph
                                   # (train/warmup.py); the step cadences
                                   # must be 0, multiples or divisors of K
    aot_warmup: bool = False       # capture every program of the run
                                   # before its second step, with
                                   # perf/compile_ms/* capture times
    pipeline_gd: bool = False      # the step as three stage programs
                                   # (gen_fakes, d_update, g_update): D
                                   # trains on the fake stack G produced
                                   # during the previous step
                                   # (train/gd_pipeline.py)
    progressive: str = ""          # progressive-resolution schedule, the
                                   # phase table "RES:STEPS[:BATCH],...,
                                   # RES:*" (e.g. "32:2000,64:2000,128:*"):
                                   # each phase trains the model at its
                                   # resolution, the last at
                                   # model.output_size; at each switch the
                                   # state carries across the growth (new
                                   # layers init fresh), the loaders
                                   # re-open at the phase's resolution
                                   # ({res} in data_dir), and checkpoints
                                   # carry the phase's tag
                                   # (progressive/); "" = off
    progressive_fade_steps: int = 0  # >0 with progressive: the real
                                   # images of the first N steps of each
                                   # later phase blend alpha * x +
                                   # (1 - alpha) * up(down(x)), alpha
                                   # ramping to 1
    # trace capture (utils/profiling.py::TraceCapture, torch.profiler)
    profile_dir: str = ""          # non-empty enables the scheduled trace
                                   # capture window
    profile_start_step: int = 10   # the window's first step, counted from
                                   # the step the run starts at
    profile_num_steps: int = 5
    profile_trigger: str = ""      # non-empty: touch this file mid-run to
                                   # capture the next profile_num_steps
                                   # steps (the file is deleted as the ack;
                                   # touch again for another). Each capture
                                   # is digested on the services worker
                                   # into perf/device/* events. Traces land
                                   # in profile_dir, or checkpoint_dir/
                                   # trace when that is unset
    timing_window: int = 50        # sliding window for step-time stats
    # data parallelism over processes (parallel/api.py)
    backend: str = "gspmd"         # "gspmd": every rank draws the global
                                   # batch's randomness and takes its rows
                                   # (JAX's single partitioned draw) |
                                   # "shard_map": every rank draws from the
                                   # step's seed folded with its rank; the
                                   # per-rank program is the same
    comm_overlap: str = "off"      # "bucket", "prefetch": the JAX
                                   # package's bucketed ZeRO collectives
                                   # (not ported)
    comm_bucket_mb: int = 4        # bucket size cap in MiB for
                                   # comm_overlap != "off"

    def __post_init__(self):
        # the JAX package's validation of these fields, with its messages
        if self.precision not in ("", "f32", "bf16", "fp8"):
            raise ValueError(
                f"precision must be one of '', 'f32', 'bf16', 'fp8', got "
                f"{self.precision!r}")
        if self.precision:
            # the JAX policy normalization: precision overrides the model's
            # dtype and quant flags (idempotent, so config.json round-trips)
            cdt, pdt, quant = PRECISION_POLICY[self.precision]
            if (self.model.compute_dtype, self.model.param_dtype,
                    self.model.quant) != (cdt, pdt, quant):
                object.__setattr__(self, "model", dataclasses.replace(
                    self.model, compute_dtype=cdt, param_dtype=pdt,
                    quant=quant))
        elif self.model.quant:
            raise ValueError(
                "model.quant is set by the precision policy — use "
                "precision='fp8' rather than setting it directly")
        if self.backend not in ("gspmd", "shard_map"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.backend == "shard_map" and (self.mesh.model != 1
                                            or self.mesh.spatial
                                            or self.mesh.shard_opt):
            raise ValueError(
                "backend='shard_map' is data-parallel only (mesh.model must "
                "be 1, spatial/shard_opt False — tensor/spatial/ZeRO-1 "
                f"optimizer-state sharding live in the gspmd backend; "
                f"ZeRO-2/3 is mesh.zero_stage, supported here); got "
                f"mesh={self.mesh}")
        if self.comm_overlap not in ("off", "bucket", "prefetch"):
            raise ValueError(
                f"comm_overlap must be one of 'off', 'bucket', 'prefetch', "
                f"got {self.comm_overlap!r}")
        if self.comm_bucket_mb <= 0:
            raise ValueError(
                f"comm_bucket_mb must be > 0, got {self.comm_bucket_mb}")
        if self.comm_overlap != "off":
            raise NotImplementedError(
                f"comm_overlap={self.comm_overlap!r}: the bucketed ZeRO "
                f"collectives are {MESH_UNPORTED}")
        if self.loss not in ("gan", "wgan-gp", "hinge"):
            raise ValueError(f"unknown loss {self.loss!r}")
        if self.update_mode not in ("sequential", "fused"):
            raise ValueError(f"unknown update_mode {self.update_mode!r}")
        if self.n_critic < 1:
            raise ValueError(f"n_critic must be >= 1, got {self.n_critic}")
        if self.r1_gamma < 0:
            raise ValueError(f"r1_gamma must be >= 0, got {self.r1_gamma}")
        if self.r1_gamma and self.loss == "wgan-gp":
            raise ValueError(
                "r1_gamma composes with the 'gan'/'hinge' families; "
                "'wgan-gp' already carries its own gradient penalty")
        if self.r1_interval < 1:
            raise ValueError(
                f"r1_interval must be >= 1, got {self.r1_interval}")
        if self.r1_interval > 1 and not self.r1_gamma:
            raise ValueError(
                "r1_interval > 1 without r1_gamma is a silent no-op — set "
                "r1_gamma > 0 to enable R1")
        if self.grad_clip < 0:
            raise ValueError(f"grad_clip must be >= 0, got {self.grad_clip}")
        parse_policy(self.diffaug)  # raises on unknown policy names
        if not 0.0 <= self.label_smoothing < 0.5:
            raise ValueError(
                f"label_smoothing must be in [0, 0.5), got "
                f"{self.label_smoothing}")
        if self.label_smoothing and self.loss != "gan":
            raise ValueError(
                "label_smoothing targets BCE labels and applies only to "
                f"loss='gan', got loss={self.loss!r}")
        if not 0.0 <= self.g_ema_decay < 1.0:
            raise ValueError(
                f"g_ema_decay must be in [0, 1), got {self.g_ema_decay}")
        if self.lr_schedule not in ("constant", "linear", "cosine"):
            raise ValueError(f"unknown lr_schedule {self.lr_schedule!r}")
        if self.warmup_steps < 0:
            raise ValueError(f"warmup_steps must be >= 0, got "
                             f"{self.warmup_steps}")
        if self.warmup_steps >= self.max_steps:
            raise ValueError(
                f"warmup_steps ({self.warmup_steps}) must be < max_steps "
                f"({self.max_steps}) — the whole run would be warmup and the "
                "decay schedule would never engage")
        if self.grad_accum < 1:
            raise ValueError(
                f"grad_accum must be >= 1, got {self.grad_accum}")
        if self.batch_size % self.grad_accum:
            raise ValueError(
                f"batch_size ({self.batch_size}) must be a multiple of "
                f"grad_accum ({self.grad_accum}) — microbatches are "
                "batch_size/grad_accum")
        if self.log_every_steps < 1:
            raise ValueError(f"log_every_steps must be >= 1, got "
                             f"{self.log_every_steps}")
        if self.nan_policy not in ("abort", "rollback"):
            raise ValueError(
                f"nan_policy must be 'abort' or 'rollback', got "
                f"{self.nan_policy!r}")
        if self.nan_policy == "rollback" and not self.nan_check_steps:
            raise ValueError(
                "nan_policy='rollback' needs the NaN gate enabled "
                "(nan_check_steps > 0) — with the gate off nothing ever "
                "trips, so the snapshot cost buys no protection")
        if self.rollback_snapshot_steps < 1:
            raise ValueError(
                f"rollback_snapshot_steps must be >= 1, got "
                f"{self.rollback_snapshot_steps}")
        if self.max_rollbacks < 1:
            raise ValueError(
                f"max_rollbacks must be >= 1, got {self.max_rollbacks}")
        if not 0.0 < self.rollback_lr_backoff <= 1.0:
            raise ValueError(
                f"rollback_lr_backoff must be in (0, 1], got "
                f"{self.rollback_lr_backoff}")
        if self.collective_timeout_secs < 0:
            raise ValueError(
                f"collective_timeout_secs must be >= 0, got "
                f"{self.collective_timeout_secs}")
        if self.flight_recorder_steps < 0:
            raise ValueError(
                f"flight_recorder_steps must be >= 0, got "
                f"{self.flight_recorder_steps}")
        if self.fid_every_steps < 0:
            raise ValueError(
                f"fid_every_steps must be >= 0, got {self.fid_every_steps}")
        if self.fid_every_steps and self.fid_num_samples < 64:
            raise ValueError(
                f"fid_num_samples must be >= 64 for a meaningful probe, "
                f"got {self.fid_num_samples}")
        if self.max_corrupt_records < 0:
            raise ValueError(
                f"max_corrupt_records must be >= 0, got "
                f"{self.max_corrupt_records}")
        if self.prefetch_device_batches < 0:
            raise ValueError(
                f"prefetch_device_batches must be >= 0, got "
                f"{self.prefetch_device_batches}")
        if self.steps_per_call < 1:
            raise ValueError(
                f"steps_per_call must be >= 1, got {self.steps_per_call}")
        if self.steps_per_call > 1:
            # the JAX rule over the cadences the port has: a cadence that
            # is a multiple of K fires on schedule, one that divides K at
            # every call boundary (reporting the call's last step);
            # anything else would fire on a skewed subset of its steps
            cadences = {"log_every_steps": self.log_every_steps,
                        "sample_every_steps": self.sample_every_steps,
                        "activation_summary_steps":
                            self.activation_summary_steps,
                        "save_model_steps": self.save_model_steps,
                        "fid_every_steps": self.fid_every_steps}
            if self.nan_policy == "rollback":
                # the snapshot cadence is inert under the default policy,
                # so its value constrains steps_per_call only when armed
                cadences["rollback_snapshot_steps"] = \
                    self.rollback_snapshot_steps
            spc = self.steps_per_call
            bad = {k: v for k, v in cadences.items()
                   if v and v % spc != 0 and spc % v != 0}
            if bad:
                raise ValueError(
                    f"with steps_per_call={spc} every step cadence must be "
                    "0, a multiple of it (fires on schedule), or a divisor "
                    "of it (fires each call boundary); offending: "
                    f"{bad}")
        if self.n_critic > 1 and self.update_mode == "fused":
            raise ValueError(
                "update_mode='fused' (reference-parity single fused step) is "
                "defined only for n_critic=1")
        if self.pipeline_gd:
            if self.update_mode != "sequential":
                raise ValueError(
                    "pipeline_gd dispatches g_update AFTER d_update "
                    "(sequential semantics by construction); "
                    "update_mode='fused' has no pipelined equivalent")
            if self.model.num_classes:
                raise ValueError(
                    "pipeline_gd supports unconditional models only — the "
                    "stage programs do not thread class labels through the "
                    "fake stack")
            if self.steps_per_call != 1:
                raise ValueError(
                    f"pipeline_gd dispatches per-step stage programs; it "
                    f"does not compose with the scanned multi-step path "
                    f"(steps_per_call={self.steps_per_call} — set it to 1)")
        if self.progressive_fade_steps < 0:
            raise ValueError(
                f"progressive_fade_steps must be >= 0, got "
                f"{self.progressive_fade_steps}")
        if self.progressive_fade_steps and not self.progressive:
            raise ValueError(
                "progressive_fade_steps > 0 without --progressive is a "
                "silent no-op — set a --progressive schedule to fade into")
        if self.progressive:
            if self.model.attn_res:
                raise ValueError(
                    "--progressive does not compose with attn_res: the "
                    "attention site is anchored to one feature-map "
                    "resolution, which earlier phases may not contain "
                    "(and carrying attention projections across a stage "
                    "shift is undefined)")
            if self.fid_every_steps:
                raise ValueError(
                    "--progressive does not compose with fid_every_steps: "
                    "the probe's feature extractor and real-side "
                    "statistics are fixed-resolution; score offline per "
                    "phase via the evals CLI instead")
            if self.nan_policy == "rollback" \
                    and self.rollback_lr_backoff < 1.0:
                raise ValueError(
                    "--progressive does not compose with "
                    "rollback_lr_backoff < 1.0: the pre-warmed backoff "
                    "surface is per-phase and a mid-schedule rebuild "
                    "would recompile under the zero-recompile contract; "
                    "use rollback without LR backoff")
            from dcgan_tpu_torch.progressive.schedule import parse_schedule
            parse_schedule(self.progressive, model=self.model,
                           batch_size=self.batch_size,
                           max_steps=self.max_steps,
                           steps_per_call=self.steps_per_call,
                           grad_accum=self.grad_accum,
                           fade_steps=self.progressive_fade_steps)
        m = self.model
        if (self.loss == "wgan-gp" or self.r1_gamma > 0) and m.use_pallas \
                and (m.arch == "dcgan" or m.attn_res):
            # the JAX package's penalty step fails to trace exactly here (a
            # pallas_call has no second derivative): the DCGAN critic's
            # BatchNorm, and an attention block on the flash kernels in
            # any family; the residual critic is norm-free and G's images
            # reach D detached, so resnet and stylegan train it
            raise NotImplementedError(
                "a gradient penalty (loss='wgan-gp' or r1_gamma > 0) needs "
                "the critic's second derivative, which the reference cannot "
                "take through a Pallas kernel (the DCGAN stacks' BatchNorm "
                "or an attention block under use_pallas); train the "
                "penalty with use_pallas=False")
        if self.mesh.spatial:
            refused = [name for test, name in SPATIAL_UNPORTED if test(self)]
            if refused:
                raise NotImplementedError(
                    f"{', '.join(refused)} under a spatial mesh: the "
                    f"height-sharded step of these is {MESH_UNPORTED}")


def model_config_from_dict(d: Dict[str, Any]) -> ModelConfig:
    """A ModelConfig from a trainer `config.json` dict (its "model" block)
    or from a bare model dict. Unknown keys are reported and dropped, so a
    config written by a newer version still loads."""
    block = dict(d["model"]) if "model" in d else dict(d)
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = sorted(set(block) - names)
    if unknown:
        print(f"[dcgan_tpu_torch] ignoring unknown model config keys "
              f"{unknown}", file=sys.stderr)
    return ModelConfig(**{k: v for k, v in block.items() if k in names})


def load_model_config(directory: str) -> ModelConfig:
    """The ModelConfig of the `config.json` in `directory`."""
    path = os.path.join(directory, CONFIG_FILENAME)
    with open(path) as f:
        return model_config_from_dict(json.load(f))


def save_model_config(cfg: ModelConfig, directory: str) -> str:
    """Write `{"model": ...}` as `config.json` in `directory` (tmp + rename),
    in the trainer's format; returns the path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, CONFIG_FILENAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"model": dataclasses.asdict(cfg)}, f, indent=2,
                  sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


# TrainConfig fields of the JAX package that change what is trained and
# that the port does not implement, with their JAX defaults: a config.json
# that sets one otherwise raises instead of being trained without it (none
# is left; a field the port drops again goes here)
UNPORTED_TRAIN_FIELDS: Dict[str, Any] = {}


def config_to_dict(cfg: TrainConfig) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def config_from_dict(d: Dict[str, Any]) -> TrainConfig:
    """A TrainConfig from a `config.json` dict of either package.

    The mesh is read into the port's MeshConfig (whose unported settings
    raise NotImplementedError). The JAX package's fields the port has no
    use for (the multi-process fault tolerance, the compile cache) are
    reported once and dropped; one of
    UNPORTED_TRAIN_FIELDS away from its default raises
    NotImplementedError, as the port's own unported values do."""
    d = dict(d)
    model = model_config_from_dict({"model": d.pop("model", {})})
    unported = [f"{k}={d[k]!r}" for k, default in UNPORTED_TRAIN_FIELDS.items()
                if k in d and d[k] != default]
    if unported:
        raise NotImplementedError(
            "dcgan_tpu_torch does not train these settings of the config; "
            f"not ported yet: {', '.join(unported)}")
    names = {f.name for f in dataclasses.fields(TrainConfig)}
    ignored = sorted(set(d) - names)
    if ignored:
        print(f"[dcgan_tpu_torch] ignoring config keys the port does not "
              f"use: {ignored}", file=sys.stderr)
    rest = {k: v for k, v in d.items() if k in names}
    if "sample_grid" in rest:  # JSON round-trips tuples as lists
        rest["sample_grid"] = tuple(rest["sample_grid"])
    if isinstance(rest.get("mesh"), dict):
        rest["mesh"] = MeshConfig(**rest["mesh"])
    return TrainConfig(model=model, **rest)


def save_config(cfg: TrainConfig, directory: str) -> str:
    """Write config.json atomically (tmp + rename), in the JAX package's
    schema; returns the path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, CONFIG_FILENAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(config_to_dict(cfg), f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def load_config(directory: str) -> Optional[TrainConfig]:
    """The TrainConfig stored next to a checkpoint, or None if absent."""
    path = os.path.join(directory, CONFIG_FILENAME)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return config_from_dict(json.load(f))


# The ModelConfig knobs the checkpoint consumers (generate) expose as
# override flags, the JAX package's list
MODEL_OVERRIDE_FLAGS = ("arch", "output_size", "c_dim", "z_dim", "gf_dim",
                        "df_dim", "num_classes", "conditional_bn",
                        "attn_res", "attn_heads", "spectral_norm")


def add_model_override_flags(p) -> None:
    """Install the MODEL_OVERRIDE_FLAGS flags on an argparse parser, with
    default None so that "passed" differs from "omitted"; precedence is
    explicit flag > --preset > the checkpoint's config.json > ModelConfig
    defaults (resolve_model_config)."""
    import argparse

    p.add_argument("--arch", choices=["dcgan", "resnet", "stylegan"],
                   default=None,
                   help="match the checkpoint's model family")
    p.add_argument("--output_size", type=int, default=None)
    p.add_argument("--c_dim", type=int, default=None)
    p.add_argument("--z_dim", type=int, default=None)
    p.add_argument("--gf_dim", type=int, default=None)
    p.add_argument("--df_dim", type=int, default=None)
    p.add_argument("--num_classes", type=int, default=None)
    p.add_argument("--attn_res", type=int, default=None,
                   help="match the checkpoint's attention config "
                        "(presets supply it; explicit flag overrides)")
    p.add_argument("--attn_heads", type=int, default=None,
                   help="match the checkpoint's attention head count")
    p.add_argument("--spectral_norm", choices=["none", "d", "gd"],
                   default=None,
                   help="match the checkpoint's spectral-norm config")
    p.add_argument("--conditional_bn", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="match the checkpoint's conditional-BN config")


def resolve_model_config(checkpoint_dir: str, *, preset: Optional[str] = None,
                         overrides: Optional[Dict[str, Any]] = None
                         ) -> ModelConfig:
    """The architecture of a checkpoint consumer: explicit flag overrides
    > --preset > the checkpoint's own config.json > ModelConfig defaults.
    `overrides` values of None mean "not passed" and are dropped.

    A progressive run's config.json describes the schedule's final model,
    but a checkpoint saved mid-schedule holds an earlier phase's
    shallower tree: the newest step's phase tag (its integrity manifest's
    `progressive` entry) names that phase's resolution, and the resolved
    output_size adopts it (an explicit --output_size still wins), as the
    JAX package's sidecar tag does (`dcgan_tpu/config.py:1121-1180`)."""
    if preset:
        from dcgan_tpu_torch.presets import get_preset  # presets imports us

        base = get_preset(preset).model
    else:
        saved = load_config(checkpoint_dir)
        base = saved.model if saved is not None else ModelConfig()
        if saved is not None and saved.progressive:
            from dcgan_tpu_torch.utils.checkpoint import \
                latest_progressive_tag

            tag = latest_progressive_tag(checkpoint_dir)
            res = None if tag is None else int(tag["resolution"])
            if res is not None and res != base.output_size:
                print(f"[dcgan_tpu_torch] progressive checkpoint: latest "
                      f"step was saved at r{res} (schedule "
                      f"{saved.progressive!r} ends at "
                      f"r{base.output_size}); building the r{res} model",
                      file=sys.stderr)
                base = dataclasses.replace(base, output_size=res)
    given = {k: v for k, v in (overrides or {}).items() if v is not None}
    return dataclasses.replace(base, **given)


def consumer_train_config(checkpoint_dir: str, model: ModelConfig
                          ) -> TrainConfig:
    """The TrainConfig a checkpoint consumer builds its restore template
    from: the checkpoint's config.json (defaults without one) with
    `model` (resolve_model_config's) in place of its model, as one phase:
    a progressive schedule describes the final model, and `model` may be
    an earlier phase's."""
    saved = load_config(checkpoint_dir)
    return dataclasses.replace(saved if saved is not None else TrainConfig(),
                               model=model, progressive="",
                               progressive_fade_steps=0)
