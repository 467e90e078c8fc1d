"""Model and training configuration: copies of `dcgan_tpu/config.py`'s
`ModelConfig` and of the `TrainConfig` fields the port serves, and of its
`save_config` / `load_config`.

Same field names, defaults and validation as the JAX package's, so each
package's `config.json` loads in the other. The port serves
and trains the DCGAN stacks with or without the SAGAN additions (a
self-attention block at `attn_res`, spectral norm on D or on both nets,
the hinge loss); the fields that select anything else (another `arch`,
class conditioning, fp8 quantization; the wgan-gp loss, n_critic > 1,
gradient accumulation, a bf16/fp8 precision policy, DiffAugment) raise
`NotImplementedError` instead of being silently ignored. A sequence mesh
for the attention does not exist in the port yet: `ops/attention.py`
refuses one.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
from typing import Any, Dict, Optional, Tuple

CONFIG_FILENAME = "config.json"


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
    quant: str = ""
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
        # then what this slice of the port does not serve yet
        unserved = []
        if self.arch != "dcgan":
            unserved.append(f"arch={self.arch!r}")
        if self.num_classes:
            unserved.append(f"num_classes={self.num_classes}")
        if self.quant:
            unserved.append(f"quant={self.quant!r}")
        if unserved:
            raise NotImplementedError(
                "dcgan_tpu_torch serves and trains the DCGAN stacks "
                "(with attention and spectral norm) only; not ported yet: "
                f"{', '.join(unserved)}")


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
    loss: str = "gan"              # BCE non-saturating | "hinge"
    n_critic: int = 1              # D updates per G update
    update_mode: str = "sequential"  # D step, then G against the updated D;
                                     # "fused": both from the same params
    grad_accum: int = 1
    diffaug: str = ""
    grad_clip: float = 0.0         # >0 clips each net's grads by global norm
    label_smoothing: float = 0.0   # one-sided: D's real target 1 - eps
    g_ema_decay: float = 0.0       # 0: ema_gen mirrors the live G weights
    # data (TFRecord shards, data/pipeline.py)
    data_dir: str = "train"
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
    seed: int = 0
    precision: str = ""            # "" leaves the model dtypes; "f32"
                                   # forces float32 compute and params

    def __post_init__(self):
        # the JAX package's validation of these fields, with its messages
        if self.precision not in ("", "f32", "bf16", "fp8"):
            raise ValueError(
                f"precision must be one of '', 'f32', 'bf16', 'fp8', got "
                f"{self.precision!r}")
        if self.loss not in ("gan", "wgan-gp", "hinge"):
            raise ValueError(f"unknown loss {self.loss!r}")
        if self.update_mode not in ("sequential", "fused"):
            raise ValueError(f"unknown update_mode {self.update_mode!r}")
        if self.n_critic < 1:
            raise ValueError(f"n_critic must be >= 1, got {self.n_critic}")
        if self.grad_clip < 0:
            raise ValueError(f"grad_clip must be >= 0, got {self.grad_clip}")
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
        if self.max_corrupt_records < 0:
            raise ValueError(
                f"max_corrupt_records must be >= 0, got "
                f"{self.max_corrupt_records}")
        if self.prefetch_device_batches < 0:
            raise ValueError(
                f"prefetch_device_batches must be >= 0, got "
                f"{self.prefetch_device_batches}")
        # then what this slice of the port does not train yet
        unserved = []
        if self.loss not in ("gan", "hinge"):
            unserved.append(f"loss={self.loss!r}")
        if self.n_critic > 1:
            unserved.append(f"n_critic={self.n_critic}")
        if self.grad_accum > 1:
            unserved.append(f"grad_accum={self.grad_accum}")
        if self.precision not in ("", "f32"):
            unserved.append(f"precision={self.precision!r}")
        if self.diffaug:
            unserved.append(f"diffaug={self.diffaug!r}")
        if unserved:
            raise NotImplementedError(
                "dcgan_tpu_torch trains the BCE or hinge GAN step (n_critic "
                "1, no accumulation, model dtypes or f32, no augmentation) "
                "only; "
                f"not ported yet: {', '.join(unserved)}")
        if self.precision == "f32" and (self.model.compute_dtype,
                                        self.model.param_dtype) != (
                                            "float32", "float32"):
            # the JAX policy normalization: precision overrides the model's
            # dtype flags
            object.__setattr__(self, "model", dataclasses.replace(
                self.model, compute_dtype="float32", param_dtype="float32"))



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
UNPORTED_TRAIN_FIELDS = {"r1_gamma": 0.0, "progressive": "",
                         "pipeline_gd": False}


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
