"""Model and training configuration: copies of `dcgan_tpu/config.py`'s
`ModelConfig` and of the `TrainConfig` fields the port serves, and of its
`save_config` / `load_config`.

Same field names, defaults and validation as the JAX package's, so each
package's `config.json` loads in the other. The port serves
and trains the DCGAN stacks with or without the SAGAN additions (a
self-attention block at `attn_res`, spectral norm on D or on both nets,
the hinge loss) and with or without class conditioning (`num_classes`:
a one-hot of the label on G's z and as constant maps on D's image;
`conditional_bn`: G's BatchNorm affine per class), on the BCE, hinge or
WGAN-GP loss, with R1, n_critic, gradient accumulation, DiffAugment and
the f32/bf16/fp8 precision policies; the fields that select anything else
(another `arch`; the JAX package's `progressive` schedule and its
`nan_policy="rollback"`) raise `NotImplementedError` instead of being
silently ignored. So does a penalty (WGAN-GP, R1) on a kernel route
(`use_pallas`): the JAX package cannot differentiate a Pallas kernel
twice, so its penalties run on the plain route only, and so do the
port's. A sequence mesh for the attention does not exist in the port
yet: `ops/attention.py` refuses one.
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
    """DCGAN architecture knobs (field-for-field the JAX `ModelConfig`)."""

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
        # then what the port does not serve yet
        if self.arch != "dcgan":
            raise NotImplementedError(
                "dcgan_tpu_torch serves and trains the DCGAN stacks "
                "(with attention, spectral norm and class conditioning) "
                f"only; not ported yet: arch={self.arch!r}")


def celeba64(**overrides) -> ModelConfig:
    """The model of the `celeba64` preset: DCGAN 64x64, z=100, gf_dim=64,
    bf16 compute over f32 params (the reference's headline workload)."""
    return dataclasses.replace(ModelConfig(output_size=64), **overrides)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The run knobs of the training slice, field-for-field (names and
    defaults) the JAX `TrainConfig`'s."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
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
    log_every_steps: int = 1
    nan_check_steps: int = 100     # every N steps the step's metrics must
                                   # be finite, else the run raises
                                   # FloatingPointError (0 = off)
    nan_policy: str = "abort"      # a tripped NaN gate raises; the JAX
                                   # package's "rollback" is not ported
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
        if self.nan_policy == "rollback":
            raise NotImplementedError(
                "nan_policy='rollback' (restore the last good snapshot and "
                "train on) is not ported to dcgan_tpu_torch; the port "
                "aborts on a non-finite metric (nan_policy='abort')")
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
                        "save_model_steps": self.save_model_steps}
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
        if (self.loss == "wgan-gp" or self.r1_gamma > 0) \
                and self.model.use_pallas:
            # the JAX package's penalties fail on both of its kernel routes
            # (a pallas_call has no second derivative), so they run on the
            # plain route there and here
            raise NotImplementedError(
                "a gradient penalty (loss='wgan-gp' or r1_gamma > 0) needs "
                "the critic's second derivative, which the reference cannot "
                "take through a Pallas kernel (its penalties run on the "
                "plain route only); train the penalty with "
                "use_pallas=False")


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
# that sets one otherwise raises instead of being trained without it
UNPORTED_TRAIN_FIELDS = {"progressive": "", "nan_policy": "abort"}


def config_to_dict(cfg: TrainConfig) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def config_from_dict(d: Dict[str, Any]) -> TrainConfig:
    """A TrainConfig from a `config.json` dict of either package.

    The JAX package's fields the port has no use for (its mesh, fault
    tolerance, profiling, evals) are reported once and dropped; one of
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
    (The JAX package's progressive-schedule sidecars do not exist in the
    port's checkpoints.)"""
    if preset:
        from dcgan_tpu_torch.presets import get_preset  # presets imports us

        base = get_preset(preset).model
    else:
        saved = load_config(checkpoint_dir)
        base = saved.model if saved is not None else ModelConfig()
    given = {k: v for k, v in (overrides or {}).items() if v is not None}
    return dataclasses.replace(base, **given)
