"""Named training presets (the counterpart of `dcgan_tpu/presets.py`).

All ten of the JAX package's presets, copied field for field (over the
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
  plain ops (`dcgan_tpu/presets.py:126-141`);
- ``sngan-cifar10``: the residual family (models/resnet.py) on CIFAR-10,
  32x32, spectral norm on the norm-free critic, hinge loss, Adam(2e-4,
  beta1 0), 5 critic updates per G update, batch 64
  (`dcgan_tpu/presets.py:174-188`);
- ``stylegan64``: StyleGAN2-lite at 64x64 (models/stylegan.py) with the
  residual critic, lazy R1 (gamma 10 every 16th step), G EMA 0.999,
  batch 64 (`dcgan_tpu/presets.py:191-202`).

and the two that name a mesh, on the port's data parallelism over
processes (parallel/api.py, one process per GPU):
- ``lsun64-dp8``: DCGAN 64x64 on LSUN-bedroom over an 8-way data mesh,
  global batch 512 (64 a rank) (`dcgan_tpu/presets.py:59-63`):
  `torchrun --nproc_per_node 8 -m dcgan_tpu_torch.train --preset
  lsun64-dp8`;
- ``sagan256-lc``: the long-context configuration, 256x256 DCGAN stacks
  with attention over the 128x128 map (a 16 384-token sequence) on the
  flash kernels, spectral norm on D, hinge, TTUR, G EMA, batch 64, on
  the shard_map backend (every rank draws from its own folded seed), at
  any world size (`dcgan_tpu/presets.py:145-171`).

UNPORTED lists the JAX presets the port does not run: none is left.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from dcgan_tpu_torch.config import MeshConfig, ModelConfig, TrainConfig


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


def lsun64_dp8(**overrides) -> TrainConfig:
    """DCGAN 64x64 LSUN-bedroom, data-parallel over an 8-way data mesh
    (8 ranks), global batch 512. Keyword arguments override TrainConfig
    fields."""
    cfg = TrainConfig(model=ModelConfig(output_size=64),
                      mesh=MeshConfig(data=8), batch_size=64 * 8)
    return dataclasses.replace(cfg, **overrides)


def sagan256_lc(**overrides) -> TrainConfig:
    """The long-context configuration: 256x256 DCGAN stacks with
    attention over the 128x128 map (16 384 tokens) on the flash kernels,
    BatchNorm on plain ops, SN on D, hinge, TTUR, beta1 0, G EMA, batch
    64, the shard_map backend. Keyword arguments override TrainConfig
    fields."""
    cfg = TrainConfig(
        model=ModelConfig(output_size=256, attn_res=128, spectral_norm="d",
                          use_pallas=True, bn_pallas=False),
        mesh=MeshConfig(), backend="shard_map", batch_size=64,
        loss="hinge", beta1=0.0, d_learning_rate=4e-4,
        g_learning_rate=1e-4, g_ema_decay=0.999)
    return dataclasses.replace(cfg, **overrides)


def sngan_cifar10(**overrides) -> TrainConfig:
    """SNGAN on CIFAR-10 (32x32): residual G and D, the norm-free critic
    spectrally normalized, hinge loss, Adam(2e-4, beta1 0), 5 critic
    updates per G update. Keyword arguments override TrainConfig
    fields."""
    cfg = TrainConfig(
        model=ModelConfig(arch="resnet", output_size=32, spectral_norm="d"),
        batch_size=64, loss="hinge", learning_rate=2e-4, beta1=0.0,
        n_critic=5)
    return dataclasses.replace(cfg, **overrides)


def stylegan64(**overrides) -> TrainConfig:
    """StyleGAN2-lite at 64x64 with the residual critic, lazy R1 (gamma
    10, every 16th step) and G EMA 0.999. Keyword arguments override
    TrainConfig fields."""
    cfg = TrainConfig(model=ModelConfig(arch="stylegan", output_size=64),
                      batch_size=64, r1_gamma=10.0, r1_interval=16,
                      g_ema_decay=0.999)
    return dataclasses.replace(cfg, **overrides)


PRESETS: Dict[str, Callable[..., TrainConfig]] = {
    "celeba64": celeba64, "dcgan128": dcgan128,
    "cifar10-cond": cifar10_cond, "wgan-gp": wgan_gp, "sagan64": sagan64,
    "sagan128": sagan128, "sngan-cifar10": sngan_cifar10,
    "stylegan64": stylegan64, "lsun64-dp8": lsun64_dp8,
    "sagan256-lc": sagan256_lc}

# the JAX package's presets the port does not run, and what each waits for
UNPORTED: Dict[str, str] = {}


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
