"""dcgan_tpu_torch: the PyTorch/CUDA port of `dcgan_tpu`, for NVIDIA Hopper.

This package serves and trains the GAN generators and discriminators on
one GPU: the DCGAN stacks, plain (`celeba64`) or with the SAGAN additions
(`sagan64`: self-attention, spectral norm, hinge loss), the residual
family (`sngan-cifar10`) and StyleGAN2-lite (`stylegan64`): a request
queue, a continuous batcher, bucketed dispatch and the sampler; the
D-then-G train step and its trainer. Every Pallas kernel the JAX package runs on those paths is a
hand-written CUDA kernel here (`csrc/`, built with nvcc at first use by
`ops/_build.py`); every other op is plain PyTorch.

Conventions shared with the JAX package, so the two compare like with like:
NHWC activations, HWIO kernels, parameter trees as nested dicts with the
same names (`proj`, `bn0..`, `deconv1..`), `z [B, z_dim]` in and
`[B, S, S, c_dim]` float32 in tanh range out.

Entry points take `device="cuda"` by default and raise when no GPU is
present unless the caller passes `device="cpu"` explicitly. The package
imports neither `jax` nor `dcgan_tpu`.
"""

from dcgan_tpu_torch.config import ModelConfig
from dcgan_tpu_torch.device import resolve_device

__all__ = ["ModelConfig", "resolve_device"]
