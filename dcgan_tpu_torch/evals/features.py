"""Feature extractors for Fréchet-distance scoring (the counterpart of
`dcgan_tpu/evals/features.py`).

FID canonically uses InceptionV3 pool3 activations; no Inception weights
ship with the project, so scoring runs a pluggable `feature_fn: images
[B, H, W, C] in [-1, 1] (a tensor on any device, or a numpy array) ->
[B, D] float32 tensor` on the tower's device, over one conv tower:
`n_stages` stride-2 5x5 SAME convolutions (`ops/layers.py::conv2d_apply`,
cuDNN on the card), each followed by lrelu(0.2) and a global average
pool; the pooled vectors are concatenated and projected by `proj`.

- `make_random_feature_fn`: the port's fixed-seed untrained tower, drawn
  from an explicit `torch.Generator` by the port's `conv2d_init` (the
  same truncated normal, std 0.02, as the JAX package's) and a normal
  `proj` scaled by 1/sqrt(pooled width). The port does not reproduce
  `jax.random`'s stream, so its weights, and the surrogate scores they
  give, differ from the JAX package's default tower: they compare only
  with scores of the port's own tower at the same (size, c_dim,
  feature_dim, base_ch, seed).
- `make_npz_feature_fn`: a tower from an npz (`conv{i}/w` HWIO,
  `conv{i}/b`, `proj` [pooled, D]), the JAX package's schema and errors.
  `tools/export_feature_tower.py` writes the JAX package's own random
  tower in it, so both packages score with the same tower (the way to
  compare scores across packages), and converted trained weights load
  the same way.

The tower computes in float32 on every device: on the card its
convolutions and the projection run with TF32 off (the JAX tower asks for
float32), set around the tower's own calls and restored after them, so
the rest of the process keeps its settings.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Tuple, Union

import numpy as np
import torch

from dcgan_tpu_torch.device import resolve_device
from dcgan_tpu_torch.ops.layers import conv2d_apply, conv2d_init, lrelu

FeatureFn = Callable[[Union[np.ndarray, torch.Tensor]], torch.Tensor]


@contextlib.contextmanager
def full_f32(device: torch.device):
    """TF32 off for cuDNN convolutions and cuBLAS products on a CUDA
    device for the block, restored after it; a no-op on the CPU."""
    if device.type != "cuda":
        yield
        return
    conv = torch.backends.cudnn.allow_tf32
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = matmul


def _build_conv_stack(params: dict, device: torch.device) -> FeatureFn:
    """The tower's apply over `params` on `device`: strided conv stages ->
    per-stage global-average-pool features, concatenated and projected.
    Multi-scale pooling makes the embedding sensitive to both texture
    (early stages) and layout (late stages)."""
    params = {k: ({n: t.to(device, torch.float32) for n, t in v.items()}
                  if isinstance(v, dict) else v.to(device, torch.float32))
              for k, v in params.items()}
    n_stages = len([k for k in params if k.startswith("conv")])

    def feature_fn(images) -> torch.Tensor:
        if not isinstance(images, torch.Tensor):
            images = torch.from_numpy(np.asarray(images, np.float32))
        h = images.to(device, torch.float32)
        pooled = []
        with torch.no_grad(), full_f32(device):
            for i in range(n_stages):
                h = lrelu(conv2d_apply(params[f"conv{i}"], h,
                                       compute_dtype=torch.float32), 0.2)
                pooled.append(h.mean(dim=(1, 2)))
            return torch.cat(pooled, dim=-1) @ params["proj"]

    feature_fn.params = params
    return feature_fn


def make_random_feature_fn(image_size: int, c_dim: int = 3, *,
                           feature_dim: int = 512, base_ch: int = 32,
                           seed: int = 42,
                           device: Union[str, torch.device] = "cuda"
                           ) -> Tuple[FeatureFn, int]:
    """The port's fixed-seed untrained tower on `device`; returns
    (feature_fn, feature_dim). The weights are drawn on the CPU, so the
    same (image_size, c_dim, feature_dim, base_ch, seed) gives the same
    weights on every device and in every process."""
    dev = resolve_device(device)
    n_stages = max(1, int(np.log2(image_size / 4)))
    gen = torch.Generator().manual_seed(seed)
    params = {}
    in_ch, total = c_dim, 0
    for i in range(n_stages):
        out_ch = base_ch * (2 ** i)
        params[f"conv{i}"] = conv2d_init(gen, in_ch, out_ch)
        total += out_ch
        in_ch = out_ch
    # a normalized gaussian keeps the feature variance bounded, so the
    # covariances stay well-conditioned for sqrtm
    params["proj"] = torch.randn((total, feature_dim), generator=gen) \
        / math.sqrt(total)
    return _build_conv_stack(params, dev), feature_dim


def make_npz_feature_fn(weights_path: str, *,
                        device: Union[str, torch.device] = "cuda"
                        ) -> Tuple[FeatureFn, int]:
    """A tower on `device` from an .npz of arrays named `conv{i}/w`,
    `conv{i}/b` (HWIO kernels) and `proj` [total_pooled, D]; returns
    (feature_fn, feature_dim)."""
    dev = resolve_device(device)
    params: dict = {}
    with np.load(weights_path) as raw:
        i = 0
        while f"conv{i}/w" in raw:
            if f"conv{i}/b" not in raw:
                raise ValueError(
                    f"{weights_path}: conv{i}/w present but conv{i}/b "
                    "missing")
            params[f"conv{i}"] = {
                "w": torch.from_numpy(np.asarray(raw[f"conv{i}/w"])),
                "b": torch.from_numpy(np.asarray(raw[f"conv{i}/b"]))}
            i += 1
        if i == 0 or "proj" not in raw:
            raise ValueError(
                f"{weights_path}: expected conv0/w, conv0/b, ..., proj "
                "arrays")
        params["proj"] = torch.from_numpy(np.asarray(raw["proj"]))
    feature_dim = int(params["proj"].shape[1])
    return _build_conv_stack(params, dev), feature_dim
