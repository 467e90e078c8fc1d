"""Model configuration: `dcgan_tpu/config.py::ModelConfig`, kept as a copy.

Same field names, defaults and dcgan-arch validation as the JAX package's
`ModelConfig`, so a trainer's `config.json` "model" block reads here
unchanged. This slice serves the plain DCGAN generator only; the fields that
select anything else (another `arch`, class conditioning, attention,
spectral norm, fp8 quantization) raise `NotImplementedError` instead of
being silently ignored.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
from typing import Any, Dict, Optional

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
        if self.attn_res:
            unserved.append(f"attn_res={self.attn_res}")
        if self.spectral_norm != "none":
            unserved.append(f"spectral_norm={self.spectral_norm!r}")
        if self.quant:
            unserved.append(f"quant={self.quant!r}")
        if unserved:
            raise NotImplementedError(
                "dcgan_tpu_torch serves the plain DCGAN generator only; "
                f"not ported yet: {', '.join(unserved)}")


def celeba64(**overrides) -> ModelConfig:
    """The model of the `celeba64` preset: DCGAN 64x64, z=100, gf_dim=64,
    bf16 compute over f32 params (the reference's headline workload)."""
    return dataclasses.replace(ModelConfig(output_size=64), **overrides)



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
