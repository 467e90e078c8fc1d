"""The StyleGAN2-lite generator, `ModelConfig(arch="stylegan")` (the
counterpart of `dcgan_tpu/models/stylegan.py`), paired with the residual
critic of models/resnet.py.

- z, pixel-normalized (its f32 mean square rounded to the compute dtype
  before the + 1e-8), through a 2-layer lrelu mapping network (`map0`,
  `map1`) to w [B, z_dim];
- a learned constant `const` [base, base, top_ch] (a bare array at the top
  of params, unit-normal at init), broadcast over the batch;
- k up-blocks: 2x nearest upsample, then two modulated 3x3 convolutions
  (`b{i}_conv1`, `b{i}_conv2`, styles `b{i}_style1`, `b{i}_style2`) with
  lrelu, and a modulated 1x1 tRGB (`b{i}_trgb`, style `b{i}_rgb_style`,
  no demodulation) whose output is added to the upsampled running RGB;
  tanh in f32 at the end.

A modulated conv is activation scaling, exact for a stride-1 bias-free
convolution: the input channels times s = 1 + affine(w), the convolution,
then (with demodulation) each output channel times rsqrt(sum over kh, kw,
cin of (W s)^2 + 1e-8), that norm in f32 throughout; the bias comes after
the demodulation. The convolution is cuDNN's, as in the other stacks.

G has no BatchNorm and no attention, so its state is `{}` and no kernel
of the port runs in it; `train` has no effect. A conditional model
concatenates the label's one-hot after z before the mapping network.
`capture` receives "w" (the mapped latents) besides "h1".."hk" and the
tanh output "h{k+1}".
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from dcgan_tpu_torch.config import ModelConfig
from dcgan_tpu_torch.device import resolve_device
from dcgan_tpu_torch.models.resnet import _g_channels, _upsample
from dcgan_tpu_torch.ops.labels import one_hot
from dcgan_tpu_torch.ops.layers import conv2d, conv2d_init, linear_apply, \
    linear_init, lrelu

Pytree = dict


def generator_init(cfg: ModelConfig, *, seed: int = 0,
                   device: Union[str, torch.device] = "cuda"
                   ) -> Tuple[Pytree, Pytree]:
    """(params, {}) drawn from a `torch.Generator` seeded with `seed`."""
    from dcgan_tpu_torch.models.dcgan import _tree_to, torch_dtype

    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    k = cfg.num_up_layers
    dtype = torch_dtype(cfg.param_dtype)
    chans = _g_channels(cfg)
    params: Pytree = {
        "map0": linear_init(gen, cfg.z_dim + cfg.num_classes, cfg.z_dim,
                            dtype=dtype),
        "map1": linear_init(gen, cfg.z_dim, cfg.z_dim, dtype=dtype),
        # the constant is the signal source: unit scale, not 0.02
        "const": torch.randn((cfg.base_size, cfg.base_size, chans[0]),
                             generator=gen).to(dtype),
    }
    for i in range(1, k + 1):
        cin, cout = chans[i - 1], chans[i]
        params[f"b{i}_style1"] = linear_init(gen, cfg.z_dim, cin,
                                             dtype=dtype)
        params[f"b{i}_conv1"] = conv2d_init(gen, cin, cout, kernel=3,
                                            dtype=dtype)
        params[f"b{i}_style2"] = linear_init(gen, cfg.z_dim, cout,
                                             dtype=dtype)
        params[f"b{i}_conv2"] = conv2d_init(gen, cout, cout, kernel=3,
                                            dtype=dtype)
        params[f"b{i}_rgb_style"] = linear_init(gen, cfg.z_dim, cout,
                                                dtype=dtype)
        params[f"b{i}_trgb"] = conv2d_init(gen, cout, cfg.c_dim, kernel=1,
                                           dtype=dtype)
    return _tree_to(params, dev), {}


def _mod_conv(layer: Pytree, style_layer: Pytree, x: torch.Tensor,
              w_lat: torch.Tensor, *, demod: bool,
              cdt: torch.dtype) -> torch.Tensor:
    """The modulated convolution as activation scaling (the JAX
    `_mod_conv`): s = 1 + affine(w) scales x's channels, the convolution
    runs in the compute dtype, then with `demod` each output channel is
    divided by its per-sample norm, computed in f32; the bias last."""
    s = 1.0 + linear_apply(style_layer, w_lat, compute_dtype=cdt)  # [B, cin]
    y = conv2d(x * s[:, None, None, :], layer["w"].to(cdt), stride=1)
    if demod:
        # sum over kh, kw once (style-independent), then per sample over
        # cin, in f32: bf16 sums would lose the low bits the rsqrt
        # amplifies
        w2 = torch.square(layer["w"].float()).sum(dim=(0, 1))  # [cin, cout]
        d = torch.rsqrt(torch.square(s.float()) @ w2 + 1e-8)  # [B, cout]
        y = y * d.to(cdt)[:, None, None, :]
    return y + layer["b"].to(cdt)


def generator_apply(params: Pytree, state: Pytree, z: torch.Tensor, *,
                    cfg: ModelConfig, train: bool,
                    labels: Optional[torch.Tensor] = None,
                    capture: Optional[dict] = None, group=None
                    ) -> Tuple[torch.Tensor, Pytree]:
    """z [B, z_dim] -> (image [B, S, S, c_dim] float32 in tanh range, {}).
    `train`, `state` and `group` have no effect: nothing depends on the
    batch."""
    from dcgan_tpu_torch.models.dcgan import torch_dtype

    del train, state, group
    k = cfg.num_up_layers
    cdt = torch_dtype(cfg.compute_dtype)
    if cfg.num_classes:
        if labels is None:
            raise ValueError("conditional generator requires labels")
        z = torch.cat([z, one_hot(labels, cfg.num_classes, z.dtype)],
                      dim=-1)
    # pixel norm: the f32 mean square rounded to cdt, then + 1e-8 in cdt
    # (JAX's weak-typed scalar)
    zn = z.to(cdt)
    ms = torch.square(zn.float()).mean(dim=-1, keepdim=True).to(cdt)
    zn = zn * torch.rsqrt(ms + torch.full((), 1e-8, dtype=cdt,
                                          device=z.device))
    w_lat = lrelu(linear_apply(params["map0"], zn, compute_dtype=cdt),
                  cfg.leak)
    w_lat = lrelu(linear_apply(params["map1"], w_lat, compute_dtype=cdt),
                  cfg.leak)
    if capture is not None:
        capture["w"] = w_lat
    const = params["const"].to(cdt)
    h = const.expand(z.shape[0], *const.shape)
    rgb = None
    for i in range(1, k + 1):
        h = _upsample(h)
        h = lrelu(_mod_conv(params[f"b{i}_conv1"], params[f"b{i}_style1"],
                            h, w_lat, demod=True, cdt=cdt), cfg.leak)
        h = lrelu(_mod_conv(params[f"b{i}_conv2"], params[f"b{i}_style2"],
                            h, w_lat, demod=True, cdt=cdt), cfg.leak)
        y = _mod_conv(params[f"b{i}_trgb"], params[f"b{i}_rgb_style"], h,
                      w_lat, demod=False, cdt=cdt)
        rgb = y if rgb is None else _upsample(rgb) + y
        if capture is not None:
            capture[f"h{i}"] = h
    out = torch.tanh(rgb.float())
    if capture is not None:
        capture[f"h{k + 1}"] = out
    return out, {}
