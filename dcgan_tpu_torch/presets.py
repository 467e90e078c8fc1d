"""Named training presets (the counterpart of `dcgan_tpu/presets.py`).

Three presets, copied field for field from the JAX factories:
- ``celeba64``: DCGAN 64x64 CelebA on one device, z=100, batch 64, bf16
  compute over f32 params, BCE non-saturating loss, Adam(2e-4, beta1 0.5)
  on both nets (the reference's headline workload,
  `dcgan_tpu/presets.py:52-56`);
- ``sagan64``: the DCGAN 64x64 stacks with one self-attention block at
  32x32 in both nets, spectral norm on both, hinge loss, TTUR (D 4e-4,
  G 1e-4), beta1 0, G EMA 0.999, batch 64; attention on the flash kernels
  (use_pallas) and BatchNorm on plain ops (bn_pallas=False)
  (`dcgan_tpu/presets.py:97-123`);
- ``wgan-gp``: the DCGAN 64x64 stacks as a Wasserstein critic with the
  gradient penalty (weight 10), Adam(1e-4, beta1 0), 5 critic updates per
  generator update, each on fresh z against the same real batch, batch
  64, on the plain route (cuDNN convolutions, torch BatchNorm), where the
  penalty's double backward runs (`dcgan_tpu/presets.py:80-94`).
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


def sagan64(**overrides) -> TrainConfig:
    """Self-attention GAN on 64x64 (Zhang et al. 2018): attention at
    32x32, spectral norm on both nets, hinge loss, TTUR, beta1 0, G EMA.
    G's normalization is plain BatchNorm, not the paper's conditional BN.
    Keyword arguments override TrainConfig fields."""
    cfg = TrainConfig(
        model=ModelConfig(output_size=64, attn_res=32, spectral_norm="gd",
                          use_pallas=True, bn_pallas=False),
        batch_size=64, loss="hinge", beta1=0.0, d_learning_rate=4e-4,
        g_learning_rate=1e-4, g_ema_decay=0.999)
    return dataclasses.replace(cfg, **overrides)


def wgan_gp(**overrides) -> TrainConfig:
    """WGAN-GP on 64x64 (Gulrajani et al. 2017): critic and gradient
    penalty, lr 1e-4, beta1 0, n_critic 5. Keyword arguments override
    TrainConfig fields."""
    cfg = TrainConfig(model=ModelConfig(output_size=64), batch_size=64,
                      loss="wgan-gp", learning_rate=1e-4, beta1=0.0,
                      n_critic=5)
    return dataclasses.replace(cfg, **overrides)


PRESETS: Dict[str, Callable[..., TrainConfig]] = {"celeba64": celeba64,
                                                  "sagan64": sagan64,
                                                  "wgan-gp": wgan_gp}


def get_preset(name: str, **overrides) -> TrainConfig:
    try:
        factory = PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown preset {name!r}; this port has "
                         f"{sorted(PRESETS)}") from None
    return factory(**overrides)
