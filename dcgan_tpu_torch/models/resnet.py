"""The residual GAN family, `ModelConfig(arch="resnet")` (the counterpart
of `dcgan_tpu/models/resnet.py`): the residual architecture of WGAN-GP
(Gulrajani et al. 2017, appendix F) and SNGAN (Miyato et al. 2018, table
3), scaled by the same base_size * 2^k rule as the DCGAN stacks.

- generator: linear `proj` z -> [base, base, top_ch], then k residual
  up-blocks (`b{i}_bn1` + relu -> 2x nearest upsample -> 3x3 `b{i}_conv1`
  -> `b{i}_bn2` + relu -> 3x3 `b{i}_conv2`; the skip is the upsample, then
  a 1x1 `b{i}_skip` where the width changes), `bn_out` + relu -> 3x3
  `out_conv` -> tanh in f32;
- discriminator: norm-free. An "optimized" block 0 (conv3x3 -> relu ->
  conv3x3 -> avgpool; skip avgpool -> 1x1), then pre-activated blocks
  (relu -> conv3x3 -> relu -> conv3x3 -> avgpool, the skip likewise), relu,
  a global sum pool and the linear `head` to one f32 logit. Its state
  holds the spectral-norm vectors only (none without spectral norm).

Parameter and state names are the JAX package's, so `convert.py` carries
weights over by path. Every BatchNorm is ops/norm.py's `batch_norm_apply`
with the relu folded in: under `use_pallas` its train moments are the
`channel_moments` kernel and its epilogue `scale_shift_act` (forward and
backward), as in the DCGAN stacks. The convolutions are cuDNN's at stride
1 (`conv2d_apply`), as XLA's are in the reference; `attn_res` inserts the
same self-attention block as the DCGAN stacks (the flash kernels under
`use_pallas`), in G after block i when attn_res == base * 2^i (i < k, or
after `proj` at base), in D after block i when attn_res == output_size >>
(i + 1). Conditioning is dcgan.py's: the label's one-hot after z for G,
constant maps after the image for D; conditional_bn gives every G
BatchNorm per-class tables.

Rounding follows the JAX function: the 2x2 average pool and D's global
sum pool accumulate in f32 and round once to the compute dtype (`jnp.mean`
and `jnp.sum` of bf16 do), and the skip path upsamples before its 1x1
conv.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple, Union

import torch

from dcgan_tpu_torch.config import ModelConfig
from dcgan_tpu_torch.device import resolve_device
from dcgan_tpu_torch.ops.attention import attn_apply, attn_init
from dcgan_tpu_torch.ops.labels import one_hot
from dcgan_tpu_torch.ops.layers import conv2d_apply, conv2d_init, \
    linear_apply, linear_init
from dcgan_tpu_torch.ops.norm import batch_norm_apply, batch_norm_init

Pytree = dict


def _upsample(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsample, NHWC."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _avgpool(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, NHWC, accumulated in f32 and rounded once to x's
    dtype."""
    b, h, w, c = x.shape
    return x.float().reshape(b, h // 2, 2, w // 2, 2, c).mean(
        dim=(2, 4)).to(x.dtype)


def _g_channels(cfg: ModelConfig) -> List[int]:
    """G's width per stage: top_ch at base_size, halving as the resolution
    doubles and flooring at gf_dim (the last up-block keeps its width)."""
    k = cfg.num_up_layers
    return [cfg.gf_dim * (2 ** max(0, k - 1 - i)) for i in range(k + 1)]


def _d_channels(cfg: ModelConfig) -> List[int]:
    """D's width per block: df_dim at full resolution, doubling as the
    resolution halves."""
    return [cfg.df_dim * (2 ** i) for i in range(cfg.num_up_layers)]


def _attend(cfg: ModelConfig, params: Pytree, state: Pytree,
            new_state: Pytree, h: torch.Tensor, cdt: torch.dtype, sn: bool,
            train: bool) -> torch.Tensor:
    from dcgan_tpu_torch.models.dcgan import _sn_attn

    p = _sn_attn(params["attn"], state, new_state, train) if sn \
        else params["attn"]
    return attn_apply(p, h, compute_dtype=cdt, num_heads=cfg.attn_heads,
                      use_pallas=cfg.use_pallas)


# ---------------------------------------------------------------------------
# Generator
# ---------------------------------------------------------------------------

def generator_init(cfg: ModelConfig, *, seed: int = 0,
                   device: Union[str, torch.device] = "cuda"
                   ) -> Tuple[Pytree, Pytree]:
    """(params, bn_state) drawn from a `torch.Generator` seeded with
    `seed` (on the CPU, then moved to `device`)."""
    from dcgan_tpu_torch.models.dcgan import _sn_state_init, _tree_to, \
        torch_dtype

    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    k = cfg.num_up_layers
    dtype = torch_dtype(cfg.param_dtype)
    chans = _g_channels(cfg)
    bn_classes = cfg.num_classes if cfg.conditional_bn else 0
    params: Pytree = {"proj": linear_init(
        gen, cfg.z_dim + cfg.num_classes,
        chans[0] * cfg.base_size * cfg.base_size, dtype=dtype)}
    state: Pytree = {}

    def bn(name, ch):
        params[name], state[name] = batch_norm_init(
            gen, ch, dtype=dtype, num_classes=bn_classes)

    for i in range(1, k + 1):
        cin, cout = chans[i - 1], chans[i]
        bn(f"b{i}_bn1", cin)
        params[f"b{i}_conv1"] = conv2d_init(gen, cin, cout, kernel=3,
                                            dtype=dtype)
        bn(f"b{i}_bn2", cout)
        params[f"b{i}_conv2"] = conv2d_init(gen, cout, cout, kernel=3,
                                            dtype=dtype)
        if cin != cout:
            params[f"b{i}_skip"] = conv2d_init(gen, cin, cout, kernel=1,
                                               dtype=dtype)
    bn("bn_out", chans[k])
    params["out_conv"] = conv2d_init(gen, chans[k], cfg.c_dim, kernel=3,
                                     dtype=dtype)
    if cfg.attn_res:
        i = int(round(math.log2(cfg.attn_res / cfg.base_size)))
        params["attn"] = attn_init(gen, chans[i], dtype=dtype)
    if cfg.spectral_norm == "gd":
        _sn_state_init(gen, params, state)
    return _tree_to(params, dev), _tree_to(state, dev)


def generator_apply(params: Pytree, state: Pytree, z: torch.Tensor, *,
                    cfg: ModelConfig, train: bool,
                    labels: Optional[torch.Tensor] = None,
                    capture: Optional[dict] = None, group=None
                    ) -> Tuple[torch.Tensor, Pytree]:
    """z [B, z_dim] -> (image [B, S, S, c_dim] float32 in tanh range,
    state), as models/dcgan.py's generator_apply (the BN moments averaged
    over a process `group`'s ranks)."""
    from dcgan_tpu_torch.models.dcgan import _sn_layer, torch_dtype

    k = cfg.num_up_layers
    cdt = torch_dtype(cfg.compute_dtype)
    chans = _g_channels(cfg)
    new_state: Pytree = {}
    sn = cfg.spectral_norm == "gd"

    def layer(name):
        return _sn_layer(params, state, new_state, name, train) if sn \
            else params[name]

    def conv(name, x):
        return conv2d_apply(layer(name), x, stride=1, compute_dtype=cdt)

    bn_labels = labels if cfg.conditional_bn else None

    def bn(name, x):
        y, new_state[name] = batch_norm_apply(
            params[name], state[name], x, train=train,
            momentum=cfg.bn_momentum, eps=cfg.bn_eps, act="relu",
            use_pallas=cfg.bn_use_pallas, labels=bn_labels, group=group)
        return y

    if cfg.num_classes:
        if labels is None:
            raise ValueError("conditional generator requires labels")
        z = torch.cat([z, one_hot(labels, cfg.num_classes, z.dtype)],
                      dim=-1)
    h = linear_apply(layer("proj"), z.to(cdt), compute_dtype=cdt)
    h = h.reshape(-1, cfg.base_size, cfg.base_size, chans[0])
    if cfg.attn_res == cfg.base_size:
        h = _attend(cfg, params, state, new_state, h, cdt, sn, train)
    if capture is not None:
        capture["h0"] = h
    for i in range(1, k + 1):
        r = conv(f"b{i}_conv1", _upsample(bn(f"b{i}_bn1", h)))
        r = conv(f"b{i}_conv2", bn(f"b{i}_bn2", r))
        s = _upsample(h)
        if f"b{i}_skip" in params:
            s = conv(f"b{i}_skip", s)
        h = r + s
        if cfg.attn_res == cfg.base_size * (2 ** i) and i < k:
            h = _attend(cfg, params, state, new_state, h, cdt, sn, train)
        if capture is not None:
            capture[f"h{i}"] = h
    h = conv("out_conv", bn("bn_out", h))
    out = torch.tanh(h.float())
    if capture is not None:
        capture[f"h{k + 1}"] = out
    return out, new_state


# ---------------------------------------------------------------------------
# Discriminator
# ---------------------------------------------------------------------------

def discriminator_init(cfg: ModelConfig, *, seed: int = 0,
                       device: Union[str, torch.device] = "cuda"
                       ) -> Tuple[Pytree, Pytree]:
    """(params, state) of the norm-free critic; the state holds the
    spectral-norm vectors (spectral_norm "d" or "gd"), else nothing."""
    from dcgan_tpu_torch.models.dcgan import _sn_state_init, _tree_to, \
        torch_dtype

    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    k = cfg.num_up_layers
    dtype = torch_dtype(cfg.param_dtype)
    chans = _d_channels(cfg)
    params: Pytree = {}
    state: Pytree = {}
    in_ch = cfg.c_dim + cfg.num_classes
    for i in range(k):
        out_ch = chans[i]
        params[f"b{i}_conv1"] = conv2d_init(gen, in_ch, out_ch, kernel=3,
                                            dtype=dtype)
        params[f"b{i}_conv2"] = conv2d_init(gen, out_ch, out_ch, kernel=3,
                                            dtype=dtype)
        if in_ch != out_ch:
            params[f"b{i}_skip"] = conv2d_init(gen, in_ch, out_ch, kernel=1,
                                               dtype=dtype)
        in_ch = out_ch
    params["head"] = linear_init(gen, in_ch, 1, dtype=dtype)
    if cfg.attn_res:
        i = int(round(math.log2(cfg.output_size / cfg.attn_res)))
        params["attn"] = attn_init(gen, chans[i - 1], dtype=dtype)
    if cfg.spectral_norm in ("d", "gd"):
        _sn_state_init(gen, params, state)
    return _tree_to(params, dev), _tree_to(state, dev)


def discriminator_apply(params: Pytree, state: Pytree, image: torch.Tensor,
                        *, cfg: ModelConfig, train: bool,
                        labels: Optional[torch.Tensor] = None,
                        capture: Optional[dict] = None, group=None
                        ) -> Tuple[torch.Tensor, torch.Tensor, Pytree]:
    """image [B, S, S, c] -> (sigmoid(logit), logit [B, 1] float32,
    state). The residual critic is norm-free: no collective, whatever
    the `group`."""
    from dcgan_tpu_torch.models.dcgan import _sn_layer, torch_dtype

    k = cfg.num_up_layers
    cdt = torch_dtype(cfg.compute_dtype)
    new_state: Pytree = {}
    sn = cfg.spectral_norm in ("d", "gd")

    def layer(name):
        return _sn_layer(params, state, new_state, name, train) if sn \
            else params[name]

    def conv(name, x):
        return conv2d_apply(layer(name), x, stride=1, compute_dtype=cdt)

    h = image.to(cdt)
    if cfg.num_classes:
        if labels is None:
            raise ValueError("conditional discriminator requires labels")
        maps = one_hot(labels, cfg.num_classes, h.dtype)[:, None, None, :]
        h = torch.cat([h, maps.expand(*h.shape[:3], cfg.num_classes)],
                      dim=-1)
    for i in range(k):
        # block 0 takes the raw pixels without a pre-activation
        r = h if i == 0 else torch.relu(h)
        r = conv(f"b{i}_conv2", torch.relu(conv(f"b{i}_conv1", r)))
        r = _avgpool(r)
        s = _avgpool(h)
        if f"b{i}_skip" in params:
            s = conv(f"b{i}_skip", s)
        h = r + s
        if cfg.attn_res and cfg.attn_res == cfg.output_size >> (i + 1):
            h = _attend(cfg, params, state, new_state, h, cdt, sn, train)
        if capture is not None:
            capture[f"h{i}"] = h
    # the global sum pool in f32, rounded once, as jnp.sum of bf16
    h = torch.relu(h).float().sum(dim=(1, 2)).to(cdt)
    logit = linear_apply(layer("head"), h, compute_dtype=cdt).float()
    if capture is not None:
        capture["logit"] = logit
    return torch.sigmoid(logit), logit, new_state
