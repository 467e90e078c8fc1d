"""Differentiable augmentation for GAN training (DiffAugment, Zhao et al.
2020, arXiv:2006.10738; the counterpart of `dcgan_tpu/ops/augment.py`).

Every input the discriminator sees, real and generated, in D's step and in
G's, is augmented with a transform drawn for it alone. The transforms are
differentiable in x, so G's gradient flows through them.

Policies (comma-separated in TrainConfig.diffaug), on NHWC batches:
- "color": per example, brightness x + U(-0.5, 0.5), saturation (x -
  mean_c) * U(0, 2) + mean_c, contrast (x - mean) * U(0.5, 1.5) + mean;
- "translation": a shift of U{-H/8 .. H/8} rows and U{-W/8 .. W/8}
  columns per example, zero-filled: a gather on the zero-padded canvas;
- "cutout": a half-size square zeroed per example, its corner drawn so
  that the square may hang off the border (U{0 .. H - (ch mod 2)} - ch/2
  rows, likewise columns).

The JAX package draws inside its compiled step from a key. Here the
randomness comes in as explicit draw tensors, made by `draw_augment` from a
`torch.Generator` (or, in the parity tests, recomputed from the JAX keys):
a flat dict keyed "<i>/<field>" for the i-th policy of the chain, with
fields brightness, saturation, contrast (f32), ty, tx (translation) and
oy, ox (cutout, the corner already offset by -size/2), each [batch]. A
step's draws are made outside the step, so a captured step reads them
from its input slots.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from dcgan_tpu_torch.config import DIFFAUG_POLICIES as POLICIES
from dcgan_tpu_torch.config import parse_policy

__all__ = ["POLICIES", "parse_policy", "draw_augment", "diff_augment"]

Draws = Dict[str, torch.Tensor]


def _uniform(gen: torch.Generator, batch: int, lo: float, hi: float,
             device) -> torch.Tensor:
    return torch.rand((batch,), generator=gen, device=device) \
        * (hi - lo) + lo


def _randint(gen: torch.Generator, batch: int, lo: int, hi: int,
             device) -> torch.Tensor:
    """U{lo .. hi - 1}, int32."""
    return torch.randint(lo, hi, (batch,), generator=gen, device=device,
                         dtype=torch.int32)


def draw_augment(policy: Sequence[str], batch: int, size: int,
                 generator: torch.Generator) -> Draws:
    """The draws of one augmented batch of `batch` images `size` pixels
    on a side, for the policy chain `policy` (see the module docstring),
    on the generator's device; {} for no policy. Drawn in the chain's
    order, each policy's fields in the order listed."""
    out: Draws = {}
    dev = generator.device
    for i, name in enumerate(policy):
        if name == "color":
            out[f"{i}/brightness"] = _uniform(generator, batch, -0.5, 0.5,
                                              dev)
            out[f"{i}/saturation"] = _uniform(generator, batch, 0.0, 2.0,
                                              dev)
            out[f"{i}/contrast"] = _uniform(generator, batch, 0.5, 1.5, dev)
        elif name == "translation":
            m = size // 8
            out[f"{i}/ty"] = _randint(generator, batch, -m, m + 1, dev)
            out[f"{i}/tx"] = _randint(generator, batch, -m, m + 1, dev)
        elif name == "cutout":
            c = size // 2
            for field in ("oy", "ox"):
                out[f"{i}/{field}"] = _randint(
                    generator, batch, 0, size + (1 - c % 2), dev) - c // 2
        else:
            raise ValueError(f"unknown diffaug policy {name!r}; available: "
                             f"{POLICIES}")
    return out


def _color(x: torch.Tensor, d: Draws) -> torch.Tensor:
    shp = (x.shape[0], 1, 1, 1)
    x = x + d["brightness"].to(x.dtype).view(shp)
    mean_c = x.mean(dim=-1, keepdim=True)
    x = (x - mean_c) * d["saturation"].to(x.dtype).view(shp) + mean_c
    mean_all = x.mean(dim=(1, 2, 3), keepdim=True)
    return (x - mean_all) * d["contrast"].to(x.dtype).view(shp) + mean_all


def _translation(x: torch.Tensor, d: Draws) -> torch.Tensor:
    b, h, w, _ = x.shape
    my, mx = h // 8, w // 8
    pad = F.pad(x, (0, 0, mx, mx, my, my))
    rows = torch.arange(h, device=x.device)[None, :] + my \
        - d["ty"].long()[:, None]                            # [B, H]
    cols = torch.arange(w, device=x.device)[None, :] + mx \
        - d["tx"].long()[:, None]                            # [B, W]
    batch = torch.arange(b, device=x.device)[:, None, None]
    return pad[batch, rows[:, :, None], cols[:, None, :]]    # [B, H, W, C]


def _cutout(x: torch.Tensor, d: Draws) -> torch.Tensor:
    _, h, w, _ = x.shape
    ch, cw = h // 2, w // 2
    oy = d["oy"].long()[:, None, None]
    ox = d["ox"].long()[:, None, None]
    yy = torch.arange(h, device=x.device)[None, :, None]
    xx = torch.arange(w, device=x.device)[None, None, :]
    inside = (yy >= oy) & (yy < oy + ch) & (xx >= ox) & (xx < ox + cw)
    return x * (1.0 - inside[..., None].to(x.dtype))


_FNS = {"color": _color, "translation": _translation, "cutout": _cutout}


def diff_augment(x: torch.Tensor, draws: Draws,
                 policy: Sequence[str]) -> torch.Tensor:
    """The policy chain over [B, H, W, C] images with the draws of
    `draw_augment` (the same draws give the same augmentation)."""
    for i, name in enumerate(policy):
        prefix = f"{i}/"
        x = _FNS[name](x, {k[len(prefix):]: v for k, v in draws.items()
                           if k.startswith(prefix)})
    return x
