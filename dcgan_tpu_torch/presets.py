"""Named training presets (the counterpart of `dcgan_tpu/presets.py`).

Six of the JAX package's ten presets, copied field for field (over the
fields both TrainConfigs have) from the JAX factories:
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
  penalty's double backward runs (`dcgan_tpu/presets.py:80-94`);
- ``dcgan128``: the DCGAN stacks at 128x128, one more stride-2 stage in
  each net, batch 64 (`dcgan_tpu/presets.py:66-70`);
- ``cifar10-cond``: the class-conditional DCGAN on CIFAR-10, 32x32 RGB,
  10 classes (the label one-hot on G's z and as constant maps on D's
  image), batch 64 (`dcgan_tpu/presets.py:73-78`);
- ``sagan128``: sagan64's recipe at 128x128 with the attention at the
  64x64 stage, a 4096-token sequence on the flash kernels, BatchNorm on
  plain ops (`dcgan_tpu/presets.py:126-141`).

The other four raise a ValueError that names what each waits for
(UNPORTED): ``lsun64-dp8`` and ``sagan256-lc`` multi-GPU (a data mesh
of 8 devices; the shard_map backend), ``sngan-cifar10`` and
``stylegan64`` their model families (arch resnet, stylegan).
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


def dcgan128(**overrides) -> TrainConfig:
    """DCGAN 128x128: 5 stride-2 stages in each net, batch 64. Keyword
    arguments override TrainConfig fields."""
    cfg = TrainConfig(model=ModelConfig(output_size=128), batch_size=64)
    return dataclasses.replace(cfg, **overrides)


def cifar10_cond(**overrides) -> TrainConfig:
    """Class-conditional DCGAN on CIFAR-10 (32x32 RGB, 10 classes),
    batch 64. Keyword arguments override TrainConfig fields."""
    cfg = TrainConfig(model=ModelConfig(output_size=32, num_classes=10),
                      batch_size=64)
    return dataclasses.replace(cfg, **overrides)


def sagan128(**overrides) -> TrainConfig:
    """sagan64's recipe at 128x128 with the attention at the 64x64 stage
    (4096 tokens) on the flash kernels, BatchNorm on plain ops. Keyword
    arguments override TrainConfig fields."""
    cfg = TrainConfig(
        model=ModelConfig(output_size=128, attn_res=64, spectral_norm="gd",
                          use_pallas=True, bn_pallas=False),
        batch_size=64, loss="hinge", beta1=0.0, d_learning_rate=4e-4,
        g_learning_rate=1e-4, g_ema_decay=0.999)
    return dataclasses.replace(cfg, **overrides)


PRESETS: Dict[str, Callable[..., TrainConfig]] = {
    "celeba64": celeba64, "dcgan128": dcgan128,
    "cifar10-cond": cifar10_cond, "wgan-gp": wgan_gp, "sagan64": sagan64,
    "sagan128": sagan128}

# the JAX package's presets the port does not run, and what each waits for
UNPORTED = {
    "lsun64-dp8": "multi-GPU (a data-parallel mesh over 8 devices; the "
                  "port trains on one GPU)",
    "sagan256-lc": "multi-GPU (its config names the shard_map mesh "
                   "backend, which the port does not have)",
    "sngan-cifar10": "the resnet model family (arch='resnet')",
    "stylegan64": "the stylegan model family (arch='stylegan')",
}


def get_preset(name: str, **overrides) -> TrainConfig:
    if name in UNPORTED:
        raise ValueError(f"preset {name!r} is not ported to "
                         f"dcgan_tpu_torch yet: it waits for "
                         f"{UNPORTED[name]}")
    try:
        factory = PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown preset {name!r}; this port has "
                         f"{sorted(PRESETS)}") from None
    return factory(**overrides)
