"""DCGAN generator and sampler as init/apply functions on nested dicts of
tensors (the counterpart of `dcgan_tpu/models/dcgan.py:129-300`).

`generator(z)`: linear z -> gf*2^(k-1) * base^2, reshape to NHWC
[B, base, base, gf*2^(k-1)], BN + relu, then k stride-2 5x5 deconv stages
through gf*2^(k-2) .. gf with BN + relu, the last to c_dim followed by tanh.

Parameter and state names are the JAX package's: `proj`, `bn0..bn{k-1}`,
`deconv1..deconv{k}` with leaves `w`, `b`, `scale`, `bias`, `mean`, `var`,
so `convert.py` carries weights over by path. The stage routing is the JAX
routing: under `pallas_fused` the interior stages 1..k-1 run as one
`gemm_bias_scale_act` kernel each, the last deconv (to 3 channels) stays a
cuDNN transposed conv, and under `use_pallas` BN's epilogue is the
`scale_shift_act` kernel.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from dcgan_tpu_torch.config import ModelConfig
from dcgan_tpu_torch.device import resolve_device
from dcgan_tpu_torch.ops.fused import fused_conv_bn_act
from dcgan_tpu_torch.ops.layers import deconv2d_apply, deconv2d_init, \
    linear_apply, linear_init
from dcgan_tpu_torch.ops.norm import batch_norm_apply, batch_norm_init

Pytree = dict

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; expected one of "
                         f"{sorted(_DTYPES)}") from None


def _tree_to(tree: Pytree, device: torch.device) -> Pytree:
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def generator_init(cfg: ModelConfig, *, seed: int = 0,
                   device: Union[str, torch.device] = "cuda"
                   ) -> Tuple[Pytree, Pytree]:
    """(params, bn_state) drawn from a `torch.Generator` seeded with `seed`
    (on the CPU, then moved to `device`). The draws differ from JAX's
    threefry stream; parity tests carry JAX weights over with convert.py."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    k = cfg.num_up_layers
    dtype = torch_dtype(cfg.param_dtype)
    top_ch = cfg.gf_dim * (2 ** (k - 1))
    params: Pytree = {"proj": linear_init(
        gen, cfg.z_dim, top_ch * cfg.base_size * cfg.base_size, dtype=dtype)}
    state: Pytree = {}
    params["bn0"], state["bn0"] = batch_norm_init(gen, top_ch, dtype=dtype)
    in_ch = top_ch
    for i in range(1, k + 1):
        out_ch = cfg.c_dim if i == k else cfg.gf_dim * (2 ** (k - 1 - i))
        params[f"deconv{i}"] = deconv2d_init(
            gen, in_ch, out_ch, kernel=cfg.kernel_size, dtype=dtype)
        if i < k:
            params[f"bn{i}"], state[f"bn{i}"] = batch_norm_init(
                gen, out_ch, dtype=dtype)
        in_ch = out_ch
    return _tree_to(params, dev), _tree_to(state, dev)


def generator_apply(params: Pytree, state: Pytree, z: torch.Tensor, *,
                    cfg: ModelConfig, train: bool
                    ) -> Tuple[torch.Tensor, Pytree]:
    """z [B, z_dim] -> image [B, S, S, c_dim] float32 in tanh range, on
    z's device. train=False is the sampler path (running BN statistics,
    state returned unchanged); train=True comes with the training slice."""
    if train:
        raise NotImplementedError(
            "generator_apply(train=True) comes with the training slice")
    k = cfg.num_up_layers
    cdt = torch_dtype(cfg.compute_dtype)
    top_ch = cfg.gf_dim * (2 ** (k - 1))
    h = linear_apply(params["proj"], z.to(cdt), compute_dtype=cdt)
    h = h.reshape(-1, cfg.base_size, cfg.base_size, top_ch)
    h, _ = batch_norm_apply(params["bn0"], state["bn0"], h, train=False,
                            eps=cfg.bn_eps, act="relu",
                            use_pallas=cfg.bn_use_pallas)
    for i in range(1, k + 1):
        if cfg.pallas_fused and i < k:
            h, _ = fused_conv_bn_act(
                params[f"deconv{i}"], params[f"bn{i}"], state[f"bn{i}"], h,
                transpose=True, kernel=cfg.kernel_size, stride=2,
                train=False, eps=cfg.bn_eps, act="relu", compute_dtype=cdt)
        else:
            h = deconv2d_apply(params[f"deconv{i}"], h, compute_dtype=cdt)
            if i < k:
                h, _ = batch_norm_apply(
                    params[f"bn{i}"], state[f"bn{i}"], h, train=False,
                    eps=cfg.bn_eps, act="relu",
                    use_pallas=cfg.bn_use_pallas)
    # tanh in f32 after the last deconv, as the JAX package does
    return torch.tanh(h.float()), state


@torch.inference_mode()
def sampler_apply(params: Pytree, state: Pytree, z: torch.Tensor, *,
                  cfg: ModelConfig) -> torch.Tensor:
    """Inference-mode generation: generator_apply(train=False)."""
    img, _ = generator_apply(params, state, z, cfg=cfg, train=False)
    return img
