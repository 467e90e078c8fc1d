"""The ranks of the spatial-mesh tests (tests/test_torch_spatial.py):
functions that `dcgan_tpu_torch/testing/multihost.py::run_world` calls in
each spawned process with the rank's World. This module imports torch and
the port only (the spawned ranks never load JAX); every input comes in as
numpy, and every output goes back as numpy or floats."""

from __future__ import annotations

import numpy as np
import torch

from dcgan_tpu_torch import convert
from dcgan_tpu_torch.config import MeshConfig, ModelConfig, TrainConfig
from dcgan_tpu_torch.ops import attention as A
from dcgan_tpu_torch.ops.flash_attention import ring_flash_attention
from dcgan_tpu_torch.ops.layers import conv2d_apply, deconv2d_apply
from dcgan_tpu_torch.parallel.api import make_parallel_train
from dcgan_tpu_torch.parallel.collectives import COUNTS
from dcgan_tpu_torch.parallel.spatial import make_spatial


def _t(a):
    return torch.from_numpy(np.array(a))


def halo_ops(world, *, cases):
    """Each case ({"op": "conv" | "deconv", "x", "w", "b", "g"}: the whole
    input map, the weights and the whole output's cotangent, numpy) on
    the rank's rows over a model axis of every rank: the rank's output
    rows and its gradients (its rows of x's, its partial w's and b's)."""
    sp = make_spatial(world, 1, world.size)
    out = []
    for c in cases:
        fn = conv2d_apply if c["op"] == "conv" else deconv2d_apply
        x = sp.rows(_t(c["x"])).clone().requires_grad_(True)
        p = {"w": _t(c["w"]).requires_grad_(True),
             "b": _t(c["b"]).requires_grad_(True)}
        before = sum(COUNTS.values())
        y = fn(p, x, spatial=sp)
        (y * sp.rows(_t(c["g"]))).sum().backward()
        out.append({"y": y.detach().numpy(), "gx": x.grad.numpy(),
                    "gw": p["w"].grad.numpy(), "gb": p["b"].grad.numpy(),
                    "collectives": sum(COUNTS.values()) - before})
    return out


def ring_ops(world, *, q, k, v, g, heads, scale):
    """The three strategies over the world's GroupRing (every rank one
    block of the sequence, dim 1 of the whole numpy q, k, v): the rank's
    rows of each output and its q, k, v gradients under the cotangent g."""
    sp = make_spatial(world, 1, world.size)
    out = {}
    for name in ("ring", "ulysses", "ring_flash"):
        qs, ks, vs = (sp.rows(_t(a)).clone().requires_grad_(True)
                      for a in (q, k, v))
        if name == "ulysses":
            o = A.ulysses_attention(qs, ks, vs, ring=sp.ring,
                                    num_heads=heads, scale=scale)
        elif name == "ring":
            o = A.ring_attention(qs, ks, vs, ring=sp.ring, scale=scale)
        else:
            o = ring_flash_attention(qs, ks, vs, scale=scale, ring=sp.ring)
        (o.float() * sp.rows(_t(g))).sum().backward()
        out[name] = [t.detach().float().numpy()
                     for t in (o, qs.grad, ks.grad, vs.grad)]
    return out


def halo_and_ring(world, *, cases, attn):
    """halo_ops on `cases` and ring_ops on `attn` in one world."""
    return {"halo": halo_ops(world, cases=cases),
            "ring": ring_ops(world, **attn)}


def make_cfg(model_kw, train_kw, mesh_kw):
    return TrainConfig(model=ModelConfig(**model_kw),
                       mesh=MeshConfig(**mesh_kw), **train_kw)


def spatial_train(world, *, model_kw, train_kw, mesh_kw, state, steps,
                  sample_z=None, grads_only=False, summary=None):
    """`len(steps)` train steps of the rank's spatial programs from the
    numpy JAX-tree `state` (the port's own init from seed 0 when None),
    each step {"images", "z", "draws"} global numpy arrays (the rank takes
    its data index's rows, the programs its rows of the images). Returns
    the flat final state, the metrics per step, the collectives issued,
    with `sample_z` the gathered sampler images, and with `summary`
    ({"images", "z"}, global) `summarize`'s statistics on the final
    state. `grads_only`: the gradients of the first step at the init."""
    cfg = make_cfg(model_kw, train_kw, mesh_kw)
    par = make_parallel_train(cfg, world)
    p = par.programs
    st = p["init"](seed=0, device="cpu") if state is None else \
        convert.train_state_from_jax(state, device="cpu")
    metrics = []
    if grads_only:
        s = steps[0]
        g, _ = par.fns.grads(st, par.rows(_t(s["images"])),
                             par.rows(_t(s["z"])),
                             par._draw_rows({k: _t(v) for k, v in
                                             s["draws"].items()}))
        return {f"{net}/{k}": v.numpy() for net in ("gen", "disc")
                for k, v in convert.flatten(g[net]).items()}
    before = dict(COUNTS)
    for s in steps:
        z = par.rows(_t(s["z"]))
        draws = par._draw_rows({k: _t(v) for k, v in s["draws"].items()})
        st, m = p["train_step"](st, par.rows(_t(s["images"])), z, draws)
        metrics.append({k: float(v) for k, v in m.items()})
    out = {"state": {k: (v.float() if v.dtype == torch.bfloat16
                         else v).numpy()
                     for k, v in convert.flatten(st).items()},
           "metrics": metrics,
           "collectives": {k: COUNTS[k] - before[k] for k in COUNTS}}
    if sample_z is not None:
        out["sample"] = p["sampler"](st, _t(sample_z)).numpy()
    if summary is not None:
        stats = p["summarize"](st, par.share(_t(summary["images"])),
                               par.share(_t(summary["z"])))
        out["summary"] = {name: {k: (v.numpy() if torch.is_tensor(v)
                                     else v) for k, v in d.items()}
                          for name, d in stats.items()}
    return out
