"""DCGAN generator, discriminator and sampler as init/apply functions on
nested dicts of tensors (the counterpart of `dcgan_tpu/models/dcgan.py:
129-449`). The entry points dispatch on `cfg.arch` as the JAX module's
do: "resnet" to models/resnet.py, "stylegan" to models/stylegan.py's
generator and resnet's critic.

`generator(z)`: linear z -> gf*2^(k-1) * base^2, reshape to NHWC
[B, base, base, gf*2^(k-1)], BN + relu, then k stride-2 5x5 deconv stages
through gf*2^(k-2) .. gf with BN + relu, the last to c_dim followed by tanh.
`discriminator(image)`: k stride-2 5x5 conv stages through df .. df*2^(k-1),
lrelu, with BN on every stage but the first, then a linear `head` on the
NHWC-flattened map to one logit (f32).

Parameter and state names are the JAX package's: `proj`, `bn0..bn{k-1}`,
`deconv1..deconv{k}` in G, `conv0..conv{k-1}`, `bn1..bn{k-1}`, `head` in D,
with leaves `w`, `b`, `scale`, `bias`, `mean`, `var`, so `convert.py` carries
weights over by path. The stage routing is the JAX routing: under
`pallas_fused` the interior stages (G 1..k-1, D 1..k-1) run as the fused
stage of ops/fused.py (one `gemm_bias_scale_act` kernel at inference,
`gemm_bias_moments` + `scale_shift_act` in training); G's last deconv (to 3
channels) and D's first conv stay cuDNN convolutions; under `use_pallas`
BN's moments and epilogue are the `channel_moments` and `scale_shift_act`
kernels.

Class conditioning (`num_classes` K > 0, `dcgan_tpu/models/dcgan.py:
143-162, 226-240, 325, 383-390`): G's `proj` takes z_dim + K inputs, the
label's one-hot in z's dtype concatenated after z; D's `conv0` takes
c_dim + K channels, the one-hot as constant maps in the compute dtype
concatenated after the image (so DiffAugment, which transforms the image
before D, never touches the maps); `conditional_bn` gives every G
BatchNorm per-class [K, C] scale and bias tables (ops/norm.py). A label
outside [0, K) gives JAX's answers: a zero one-hot, the clamped table row
(ops/labels.py). A conditional model raises without labels.

SAGAN additions (`dcgan_tpu/models/dcgan.py:64-103, 242-286, 416-421`):
`attn_res` inserts one self-attention block (`attn`, ops/attention.py) in
G after bn0 when attn_res == base_size, or after interior stage i when
attn_res == base_size * 2^i, and in D after stage i when attn_res ==
output_size >> (i + 1); under `use_pallas` it runs on the flash kernels.
`spectral_norm` ("d": D only, "gd": both nets) divides every weight of a
layer with a `w` (proj, deconv*, conv*, head) and of the four attention
sublayers by its power-iterated largest singular value (ops/spectral.py);
the u vectors are the state leaves `sn_<layer>` and `sn_attn_<sub>` beside
the BN moments, advanced on every train=True apply.

train=True uses batch BN statistics and returns the EMA-updated state
(detached); train=False uses the running statistics.

fp8 (`quant="fp8"`, the fp8 precision policy): the interior stages whose
feature maps reach _FP8_MIN_RES pixels quantize both GEMM operands
(`_stage_quant`, `dcgan_tpu/models/dcgan.py:103-114`); G's last deconv and
D's first conv never do. No stage of a 64 px model reaches 64 px inside
(its interior maps top out at 32), so the policy bites from 128 px up.

Under a spatial mesh (`spatial=`, parallel/spatial.py; the DCGAN stacks
only) every map is the rank's block of rows: G's projection keeps the
rank's rows of its map, the convs and deconvs exchange halo rows, the
attention runs sequence-parallel over the model axis
(`cfg.attn_seq_strategy`), D's head sums its partial products over the
model axis, and G returns the rank's rows of the images.

`capture`, a dict, receives the post-activation tensors under the JAX
names, for `summarize`: "h0".."hk" in G (hk the tanh output), "h0"..
"h{k-1}" and "logit" in D.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from dcgan_tpu_torch.config import ModelConfig
from dcgan_tpu_torch.device import resolve_device
from dcgan_tpu_torch.ops.attention import SUBLAYERS, attn_apply, attn_init
from dcgan_tpu_torch.ops.fused import fused_conv_bn_act
from dcgan_tpu_torch.ops.labels import one_hot
from dcgan_tpu_torch.ops.layers import conv2d_apply, conv2d_init, \
    deconv2d_apply, deconv2d_init, linear_apply, linear_init, lrelu
from dcgan_tpu_torch.ops.norm import batch_norm_apply, batch_norm_init
from dcgan_tpu_torch.ops.spectral import spectral_normalize, \
    spectral_u_init

Pytree = dict

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; expected one of "
                         f"{sorted(_DTYPES)}") from None


_FP8_MIN_RES = 64


def _stage_quant(cfg: ModelConfig, res: int) -> str:
    """The quantization of an interior stage whose feature map is `res`
    pixels on a side: cfg.quant at res >= _FP8_MIN_RES, else none."""
    return cfg.quant if res >= _FP8_MIN_RES else ""


def _no_spatial(cfg: ModelConfig, spatial) -> None:
    if spatial is not None:
        raise NotImplementedError(
            f"arch={cfg.arch!r} under a spatial mesh is not ported to "
            "dcgan_tpu_torch yet (ROADMAP Queue A item 7)")


def _tree_to(tree: Pytree, device: torch.device) -> Pytree:
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _family_g(cfg: ModelConfig):
    """The module of cfg.arch's generator, None for the DCGAN stacks
    (`dcgan_tpu/models/dcgan.py:131-137, 199-213`)."""
    if cfg.arch == "resnet":
        from dcgan_tpu_torch.models import resnet

        return resnet
    if cfg.arch == "stylegan":
        from dcgan_tpu_torch.models import stylegan

        return stylegan
    return None


# ---------------------------------------------------------------------------
# Spectral norm and the attention block
# ---------------------------------------------------------------------------

def _sn_state_init(gen: torch.Generator, params: Pytree,
                   state: Pytree) -> None:
    """One u vector per weight of `params` (and of the attention block's
    sublayers), in sorted layer order, as the sn_* leaves of `state`."""
    for name in sorted(params):
        p = params[name]
        if "w" in p:
            state[f"sn_{name}"] = spectral_u_init(gen, p["w"].shape[-1])
        elif name == "attn":
            for sub in SUBLAYERS:
                state[f"sn_attn_{sub}"] = spectral_u_init(
                    gen, p[sub]["w"].shape[-1])


def _sn_layer(params: Pytree, state: Pytree, new_state: Pytree, name: str,
              train: bool) -> Pytree:
    """params[name] with its weight spectrally normalized; the advanced
    (train) or stored (eval) u goes into new_state."""
    w_sn, new_state[f"sn_{name}"] = spectral_normalize(
        params[name]["w"], state[f"sn_{name}"], train=train)
    return {**params[name], "w": w_sn}


def _sn_attn(params_attn: Pytree, state: Pytree, new_state: Pytree,
             train: bool) -> Pytree:
    out = dict(params_attn)
    for sub in SUBLAYERS:
        w_sn, new_state[f"sn_attn_{sub}"] = spectral_normalize(
            params_attn[sub]["w"], state[f"sn_attn_{sub}"], train=train)
        out[sub] = {**params_attn[sub], "w": w_sn}
    return out


def generator_init(cfg: ModelConfig, *, seed: int = 0,
                   device: Union[str, torch.device] = "cuda"
                   ) -> Tuple[Pytree, Pytree]:
    """(params, bn_state) drawn from a `torch.Generator` seeded with `seed`
    (on the CPU, then moved to `device`). The draws differ from JAX's
    threefry stream; parity tests carry JAX weights over with convert.py.
    cfg.arch selects the family (models/resnet.py, models/stylegan.py)."""
    family = _family_g(cfg)
    if family is not None:
        return family.generator_init(cfg, seed=seed, device=device)
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    k = cfg.num_up_layers
    dtype = torch_dtype(cfg.param_dtype)
    top_ch = cfg.gf_dim * (2 ** (k - 1))
    params: Pytree = {"proj": linear_init(
        gen, cfg.z_dim + cfg.num_classes,
        top_ch * cfg.base_size * cfg.base_size, dtype=dtype)}
    state: Pytree = {}
    bn_classes = cfg.num_classes if cfg.conditional_bn else 0
    params["bn0"], state["bn0"] = batch_norm_init(
        gen, top_ch, dtype=dtype, num_classes=bn_classes)
    in_ch = top_ch
    for i in range(1, k + 1):
        out_ch = cfg.c_dim if i == k else cfg.gf_dim * (2 ** (k - 1 - i))
        params[f"deconv{i}"] = deconv2d_init(
            gen, in_ch, out_ch, kernel=cfg.kernel_size, dtype=dtype)
        if i < k:
            params[f"bn{i}"], state[f"bn{i}"] = batch_norm_init(
                gen, out_ch, dtype=dtype, num_classes=bn_classes)
        in_ch = out_ch
    if cfg.attn_res:
        # stage 0 (base_size) has top_ch channels, stage i gf * 2^(k-1-i)
        i = int(round(math.log2(cfg.attn_res / cfg.base_size)))
        ch = top_ch if i == 0 else cfg.gf_dim * (2 ** (k - 1 - i))
        params["attn"] = attn_init(gen, ch, dtype=dtype)
    if cfg.spectral_norm == "gd":
        # drawn after every layer, so the layers' draws do not depend on
        # the flag
        _sn_state_init(gen, params, state)
    return _tree_to(params, dev), _tree_to(state, dev)


def generator_apply(params: Pytree, state: Pytree, z: torch.Tensor, *,
                    cfg: ModelConfig, train: bool,
                    labels: Optional[torch.Tensor] = None,
                    capture: Optional[dict] = None, group=None,
                    spatial=None) -> Tuple[torch.Tensor, Pytree]:
    """z [B, z_dim] -> (image [B, S, S, c_dim] float32 in tanh range,
    state), on z's device. train=False is the sampler path (running BN
    statistics, stored SN vectors, the state returned unchanged);
    train=True normalizes with batch statistics and returns the updated
    state, the moments averaged over the ranks of a process `group` (the
    JAX `axis_name`). A conditional model needs `labels` [B]. Under
    `spatial` the image is the rank's rows [B, S / n, S, c_dim]."""
    family = _family_g(cfg)
    if family is not None:
        _no_spatial(cfg, spatial)
        return family.generator_apply(params, state, z, cfg=cfg,
                                      train=train, labels=labels,
                                      capture=capture, group=group)
    k = cfg.num_up_layers
    cdt = torch_dtype(cfg.compute_dtype)
    top_ch = cfg.gf_dim * (2 ** (k - 1))
    new_state: Pytree = {}
    sn = cfg.spectral_norm == "gd"

    def layer(name):
        return _sn_layer(params, state, new_state, name, train) if sn \
            else params[name]

    def attend(h):
        p = _sn_attn(params["attn"], state, new_state, train) if sn \
            else params["attn"]
        return attn_apply(p, h, compute_dtype=cdt, num_heads=cfg.attn_heads,
                          seq_mesh=None if spatial is None else spatial.ring,
                          seq_strategy=cfg.attn_seq_strategy,
                          use_pallas=cfg.use_pallas)

    bn_labels = labels if cfg.conditional_bn else None

    def bn(name, h):
        return batch_norm_apply(params[name], state[name], h, train=train,
                                momentum=cfg.bn_momentum, eps=cfg.bn_eps,
                                act="relu", use_pallas=cfg.bn_use_pallas,
                                labels=bn_labels, group=group)

    if cfg.num_classes:
        if labels is None:
            raise ValueError("conditional generator requires labels")
        z = torch.cat([z, one_hot(labels, cfg.num_classes, z.dtype)],
                      dim=-1)
    h = linear_apply(layer("proj"), z.to(cdt), compute_dtype=cdt)
    h = h.reshape(-1, cfg.base_size, cfg.base_size, top_ch)
    if spatial is not None:
        h = spatial.rows(h)
    h, new_state["bn0"] = bn("bn0", h)
    if cfg.attn_res == cfg.base_size:
        h = attend(h)
    if capture is not None:
        capture["h0"] = h
    for i in range(1, k + 1):
        quant = "" if i == k else _stage_quant(cfg,
                                               cfg.base_size * (2 ** i))
        if cfg.pallas_fused and i < k:
            h, new_state[f"bn{i}"] = fused_conv_bn_act(
                layer(f"deconv{i}"), params[f"bn{i}"], state[f"bn{i}"], h,
                transpose=True, kernel=cfg.kernel_size, stride=2,
                train=train, momentum=cfg.bn_momentum, eps=cfg.bn_eps,
                act="relu", compute_dtype=cdt, quant=quant, group=group)
        else:
            h = deconv2d_apply(layer(f"deconv{i}"), h, compute_dtype=cdt,
                               quant=quant, spatial=spatial)
            if i < k:
                h, new_state[f"bn{i}"] = bn(f"bn{i}", h)
        if i < k:
            if cfg.attn_res == cfg.base_size * (2 ** i):
                h = attend(h)
            if capture is not None:
                capture[f"h{i}"] = h
    # tanh in f32 after the last deconv, as the JAX package does
    out = torch.tanh(h.float())
    if capture is not None:
        capture[f"h{k}"] = out
    return out, new_state


@torch.inference_mode()
def sampler_apply(params: Pytree, state: Pytree, z: torch.Tensor, *,
                  cfg: ModelConfig, labels: Optional[torch.Tensor] = None,
                  spatial=None) -> torch.Tensor:
    """Inference-mode generation: generator_apply(train=False) (the
    rank's rows under `spatial`)."""
    img, _ = generator_apply(params, state, z, cfg=cfg, train=False,
                             labels=labels, spatial=spatial)
    return img


# ---------------------------------------------------------------------------
# Discriminator
# ---------------------------------------------------------------------------

def discriminator_init(cfg: ModelConfig, *, seed: int = 0,
                       device: Union[str, torch.device] = "cuda"
                       ) -> Tuple[Pytree, Pytree]:
    """(params, bn_state) of D drawn from a `torch.Generator` seeded with
    `seed`. Stage 0 has no BN, as in the JAX package (and the reference,
    which creates a `d_bn0` it never uses). The resnet and stylegan
    families share the residual critic of models/resnet.py."""
    if cfg.arch in ("resnet", "stylegan"):
        from dcgan_tpu_torch.models import resnet

        return resnet.discriminator_init(cfg, seed=seed, device=device)
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    k = cfg.num_up_layers
    dtype = torch_dtype(cfg.param_dtype)
    params: Pytree = {}
    state: Pytree = {}
    in_ch = cfg.c_dim + cfg.num_classes
    for i in range(k):
        out_ch = cfg.df_dim * (2 ** i)
        params[f"conv{i}"] = conv2d_init(gen, in_ch, out_ch,
                                         kernel=cfg.kernel_size, dtype=dtype)
        if i > 0:
            params[f"bn{i}"], state[f"bn{i}"] = batch_norm_init(
                gen, out_ch, dtype=dtype)
        in_ch = out_ch
    flat = cfg.base_size * cfg.base_size * cfg.df_dim * (2 ** (k - 1))
    params["head"] = linear_init(gen, flat, 1, dtype=dtype)
    if cfg.attn_res:
        # stage i's output map is output_size / 2^(i+1), df * 2^i channels
        i = int(round(math.log2(cfg.output_size / cfg.attn_res))) - 1
        params["attn"] = attn_init(gen, cfg.df_dim * (2 ** i), dtype=dtype)
    if cfg.spectral_norm in ("d", "gd"):
        _sn_state_init(gen, params, state)
    return _tree_to(params, dev), _tree_to(state, dev)


def discriminator_apply(params: Pytree, state: Pytree, image: torch.Tensor,
                        *, cfg: ModelConfig, train: bool,
                        labels: Optional[torch.Tensor] = None,
                        capture: Optional[dict] = None, group=None,
                        spatial=None
                        ) -> Tuple[torch.Tensor, torch.Tensor, Pytree]:
    """image [B, S, S, c] -> (sigmoid(logit), logit [B, 1] float32,
    state); a process `group` as in generator_apply. A conditional model
    needs `labels` [B]. Under `spatial` the image is the rank's rows and
    the logit the whole image's, the same on every model rank."""
    if cfg.arch in ("resnet", "stylegan"):
        from dcgan_tpu_torch.models import resnet

        _no_spatial(cfg, spatial)
        return resnet.discriminator_apply(params, state, image, cfg=cfg,
                                          train=train, labels=labels,
                                          capture=capture, group=group)
    k = cfg.num_up_layers
    cdt = torch_dtype(cfg.compute_dtype)
    new_state: Pytree = {}
    sn = cfg.spectral_norm in ("d", "gd")

    def layer(name):
        return _sn_layer(params, state, new_state, name, train) if sn \
            else params[name]

    def attend(h):
        p = _sn_attn(params["attn"], state, new_state, train) if sn \
            else params["attn"]
        return attn_apply(p, h, compute_dtype=cdt, num_heads=cfg.attn_heads,
                          seq_mesh=None if spatial is None else spatial.ring,
                          seq_strategy=cfg.attn_seq_strategy,
                          use_pallas=cfg.use_pallas)

    h = image.to(cdt)
    if cfg.num_classes:
        if labels is None:
            raise ValueError("conditional discriminator requires labels")
        maps = one_hot(labels, cfg.num_classes, h.dtype)[:, None, None, :]
        h = torch.cat([h, maps.expand(*h.shape[:3], cfg.num_classes)],
                      dim=-1)
    for i in range(k):
        quant = _stage_quant(cfg, cfg.output_size >> i)
        if cfg.pallas_fused and i > 0:
            h, new_state[f"bn{i}"] = fused_conv_bn_act(
                layer(f"conv{i}"), params[f"bn{i}"], state[f"bn{i}"], h,
                transpose=False, kernel=cfg.kernel_size, stride=2,
                train=train, momentum=cfg.bn_momentum, eps=cfg.bn_eps,
                act="lrelu", leak=cfg.leak, compute_dtype=cdt, quant=quant,
                group=group)
        elif i > 0:
            h = conv2d_apply(layer(f"conv{i}"), h, compute_dtype=cdt,
                             quant=quant, spatial=spatial)
            h, new_state[f"bn{i}"] = batch_norm_apply(
                params[f"bn{i}"], state[f"bn{i}"], h, train=train,
                momentum=cfg.bn_momentum, eps=cfg.bn_eps, act="lrelu",
                leak=cfg.leak, use_pallas=cfg.bn_use_pallas, group=group)
        else:
            h = lrelu(conv2d_apply(layer(f"conv{i}"), h, compute_dtype=cdt,
                                   spatial=spatial), cfg.leak)
        if cfg.attn_res and cfg.attn_res == cfg.output_size >> (i + 1):
            h = attend(h)
        if capture is not None:
            capture[f"h{i}"] = h
    # the head's rows are laid out for the NHWC flatten
    h = h.reshape(h.shape[0], -1)
    if spatial is None:
        logit = linear_apply(layer("head"), h, compute_dtype=cdt).float()
    else:
        logit = spatial.head(layer("head"), h, cdt).float()
    if capture is not None:
        capture["logit"] = logit
    return torch.sigmoid(logit), logit, new_state


# ---------------------------------------------------------------------------
# Whole GAN
# ---------------------------------------------------------------------------

def gan_init(cfg: ModelConfig, *, seed: int = 0,
             device: Union[str, torch.device] = "cuda"
             ) -> Tuple[Pytree, Pytree]:
    """Both nets: (params, state) = ({"gen", "disc"}, {"gen", "disc"}), G
    drawn from `seed` and D from `seed + 1`."""
    g_params, g_state = generator_init(cfg, seed=seed, device=device)
    d_params, d_state = discriminator_init(cfg, seed=seed + 1, device=device)
    return ({"gen": g_params, "disc": d_params},
            {"gen": g_state, "disc": d_state})
