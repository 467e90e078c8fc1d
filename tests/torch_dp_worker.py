"""The ranks of the data-parallel tests (tests/test_torch_parallel*.py):
functions that `dcgan_tpu_torch/testing/multihost.py::run_world` calls in
each spawned process with the rank's World. This module imports torch and
the port only (the spawned ranks never load JAX); every input comes in as
numpy, and every output goes back as numpy or floats."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dcgan_tpu_torch import convert
from dcgan_tpu_torch.config import MeshConfig, ModelConfig, TrainConfig
from dcgan_tpu_torch.parallel.api import make_parallel_train, rank_rows


def make_cfg(model_kw, train_kw, backend="gspmd", data=-1):
    return TrainConfig(model=ModelConfig(**model_kw), backend=backend,
                       mesh=MeshConfig(data=data), **train_kw)


def flat_numpy(state):
    """{path: numpy} over a port state (bf16 leaves as float32)."""
    out = {}
    for k, v in convert.flatten(state).items():
        out[k] = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return out


def local_images(par, images):
    """The rank's share of a global numpy batch: its rank_rows under the
    gspmd draws (the global step's microbatch layout), its contiguous
    share under shard_map (each JAX shard's local batch)."""
    t = torch.from_numpy(np.array(images))
    w = par.world
    if w.size == 1:
        return t
    if par.folds_rank:
        return par.share(t)
    return t.index_select(0, rank_rows(t.shape[0], w.rank, w.size,
                                       par.cfg.grad_accum))


def local_draws(par, z, draws):
    """The rank's (z, draws): gspmd's rows of the global draws, or under
    shard_map the rank's own entry of per-rank lists."""
    if par.folds_rank:
        z, draws = z[par.world.rank], draws[par.world.rank]
        return (torch.from_numpy(np.array(z)),
                {k: torch.from_numpy(np.array(v)) for k, v in draws.items()})
    z = torch.from_numpy(np.array(z))
    d = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    return par.rows(z), par._draw_rows(d)


def train(world, *, model_kw, train_kw, backend, state, steps, probes=None,
          stages=False):
    """`len(steps)` steps of the rank's train_step (or, with stages, of the
    pipelined gen_fakes / d_update / g_update) from the numpy JAX-tree
    `state` (the port's own init from seed 0 when None); each step is {"images", "z", "draws"} (global numpy arrays,
    per-rank lists under shard_map). Returns the flat final state, the
    metrics per step, and with `probes` ({"state", "sample_z",
    "eval_images", "eval_z", "summary_images", "summary_z"}) the
    sampler's images, eval_losses and summarize on probes["state"] (a
    numpy JAX-tree state: the reference's final one, so that the probes
    are compared on the same weights)."""
    cfg = make_cfg(model_kw, train_kw, backend)
    par = make_parallel_train(cfg, world)
    p = par.programs
    st = p["init"](seed=0, device="cpu") if state is None else \
        convert.train_state_from_jax(state, device="cpu")
    metrics = []
    fakes = None
    for s in steps:
        images = local_images(par, s["images"])
        if stages:
            _, draws = local_draws(par, s["z"], s["draws"])
            if fakes is None:
                fakes = p["gen_fakes"](st, draws)
            st, dm = p["d_update"](st, images, fakes, draws)
            st, fakes, gm = p["g_update"](st, draws)
            m = {**dm, **gm}
        else:
            z, draws = local_draws(par, s["z"], s["draws"])
            st, m = p["train_step"](st, images, z, draws)
        metrics.append({k: float(v) for k, v in m.items()})
    out = {"state": flat_numpy(st), "metrics": metrics}
    if probes:
        st = convert.train_state_from_jax(probes["state"], device="cpu")
        t = {k: torch.from_numpy(np.array(v)) for k, v in probes.items()
             if k not in ("summary_z", "state")}
        out["sample"] = p["sampler"](st, t["sample_z"]).numpy()
        out["eval"] = {k: float(v) for k, v in p["eval_losses"](
            st, local_images(par, probes["eval_images"]),
            t["eval_z"]).items()}
        sz = probes["summary_z"]
        sz = sz[world.rank] if par.folds_rank else sz
        z = torch.from_numpy(np.array(sz))
        z = z if par.folds_rank else par.share(z)
        stats = p["summarize"](st, par.share(t["summary_images"]), z)
        out["summary"] = {name: {k: (v.numpy() if torch.is_tensor(v)
                                     else v) for k, v in d.items()}
                          for name, d in stats.items()}
    return out


def collectives_identity(world):
    """Each collective helper on a world (of size 1 in the tests) against
    its input, bit for bit."""
    from dcgan_tpu_torch.parallel import collectives as C

    g = torch.Generator().manual_seed(3)
    x = torch.randn(5, 3, generator=g)
    tree = {"a": torch.randn(4, generator=g),
            "b": {"c": torch.randn(2, 2, generator=g).bfloat16()}}
    m, ms = torch.rand(3, generator=g), torch.rand(3, generator=g)
    leaf = m.clone().requires_grad_(True)
    sm, sms = C.synced_moments(world.group, leaf, ms)
    (sm * 2.0 + sms).sum().backward()
    lo, hi = C.min_max(world.group, x.min(), x.max())
    mt = C.mean_tree(world.group, tree)
    return {
        "mean_over": torch.equal(C.mean_over(world.group, x), x),
        "mean_scalars": all(torch.equal(a, b) for a, b in zip(
            C.mean_scalars(world.group, [x[0, 0], x[1, 1]]),
            [x[0, 0], x[1, 1]])),
        "mean_tree": torch.equal(mt["a"], tree["a"])
        and torch.equal(mt["b"]["c"], tree["b"]["c"]),
        "gather_rows": torch.equal(C.gather_rows(world.group, x), x),
        "min_max": torch.equal(lo, x.min()) and torch.equal(hi, x.max()),
        "synced_moments": torch.equal(sm, m) and torch.equal(sms, ms)
        and torch.equal(leaf.grad, torch.full_like(m, 2.0)),
        "world": dataclasses.asdict(dataclasses.replace(world, group=None)),
    }


def cli_train(world, *, argv):
    """The trainer CLI (`python -m dcgan_tpu_torch.train argv`) in this
    rank; the final state, flat."""
    from dcgan_tpu_torch.train import cli

    return {"state": flat_numpy(cli.main(list(argv)))}
