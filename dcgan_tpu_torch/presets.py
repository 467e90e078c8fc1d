"""Named training presets (the counterpart of `dcgan_tpu/presets.py`).

This slice trains one: ``celeba64``, DCGAN 64x64 CelebA on one device,
z=100, batch 64, bf16 compute over f32 params, BCE non-saturating loss,
Adam(2e-4, beta1 0.5) on both nets (the reference's headline workload,
`dcgan_tpu/presets.py:52-56`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from dcgan_tpu_torch.config import ModelConfig, TrainConfig


def celeba64(**overrides) -> TrainConfig:
    """DCGAN 64x64 CelebA, single device (the reference's headline
    workload). Keyword arguments override TrainConfig fields."""
    cfg = TrainConfig(model=ModelConfig(output_size=64), batch_size=64)
    return dataclasses.replace(cfg, **overrides)


PRESETS: Dict[str, Callable[..., TrainConfig]] = {"celeba64": celeba64}


def get_preset(name: str, **overrides) -> TrainConfig:
    try:
        factory = PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown preset {name!r}; this port has "
                         f"{sorted(PRESETS)}") from None
    return factory(**overrides)
