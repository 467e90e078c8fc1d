"""The JAX step's random draws, recomputed from its keys for the port.

The JAX train step draws z, the critic iterations' z, WGAN-GP's
interpolation weights and DiffAugment's transforms inside its program from
one key (`dcgan_tpu/train/steps.py::train_step`); the port takes them as
arguments (`dcgan_tpu_torch/train/steps.py::draw_step`'s layout). These
helpers follow the JAX key schedule:

- z and `gp_key` from `split(key)` (`split(key, 3)` with the third the
  augmentation key when DiffAugment is on);
- n_critic > 1: `split(gp_key, n_critic)`, then per iteration `split` into
  its z key and its gp key, and `fold_in(iter_key, 3)` for augmentation;
- grad_accum K > 1: `split(gpk, K)` and `split(aug_key, K)` per update,
  microbatch j on its own key;
- DiffAugment: `fold_in(key, idx)` per D input (0 real, 1 fake, 2 G's
  fake), then `fold_in(key, i)` per policy and each function's own splits;
- the pipelined stage programs (`stage_draws`): each folds its tag into
  the step's key (d_update 0, g_update 1, gen_fakes 2) and draws as above.
"""

from __future__ import annotations

import importlib.util
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcgan_tpu.ops.augment import parse_policy


def uniform(key, shape, lo=0.0, hi=1.0):
    return np.asarray(jax.random.uniform(key, shape, minval=lo, maxval=hi,
                                         dtype=jnp.float32))


def aug_draws(key, policy, batch, size):
    """`diff_augment(x, key, policy)`'s draws for a batch of `batch`
    images `size` pixels on a side, in draw_augment's layout."""
    out = {}
    for i, name in enumerate(policy):
        k = jax.random.fold_in(key, i)
        shp = (batch, 1, 1, 1)
        if name == "color":
            kb, ks, kc = jax.random.split(k, 3)
            out[f"{i}/brightness"] = uniform(kb, shp, -0.5, 0.5).reshape(-1)
            out[f"{i}/saturation"] = uniform(ks, shp, 0.0, 2.0).reshape(-1)
            out[f"{i}/contrast"] = uniform(kc, shp, 0.5, 1.5).reshape(-1)
        elif name == "translation":
            ky, kx = jax.random.split(k)
            m = size // 8
            out[f"{i}/ty"] = np.asarray(jax.random.randint(
                ky, (batch,), -m, m + 1)).astype(np.int32)
            out[f"{i}/tx"] = np.asarray(jax.random.randint(
                kx, (batch,), -m, m + 1)).astype(np.int32)
        else:
            ky, kx = jax.random.split(k)
            c = size // 2
            for field, kk in (("oy", ky), ("ox", kx)):
                out[f"{i}/{field}"] = (np.asarray(jax.random.randint(
                    kk, (batch, 1, 1), 0, size + (1 - c % 2)))
                    - c // 2).reshape(-1).astype(np.int32)
    return out


def _concat(parts):
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def step_draws(cfg, key, batch):
    """(z, draws) of the JAX step on `key` for a batch of `batch`, as
    numpy: z [batch, z_dim] and the port's draws dict."""
    policy = parse_policy(cfg.diffaug)
    m = cfg.model
    n_micro = cfg.grad_accum
    if policy:
        z_key, gp_key, aug_key = jax.random.split(key, 3)
    else:
        z_key, gp_key = jax.random.split(key)
        aug_key = None
    z = uniform(z_key, (batch, m.z_dim), -1.0, 1.0)
    out = {}

    def per_micro(k):
        return [k] if n_micro == 1 else list(jax.random.split(k, n_micro))

    def critic(prefix, gpk, augk):
        mb = batch // n_micro
        if cfg.loss == "wgan-gp":
            out[prefix + "eps"] = np.concatenate(
                [uniform(k, (mb, 1, 1, 1)).reshape(-1)
                 for k in per_micro(gpk)])
        if policy:
            for idx, which in ((0, "real"), (1, "fake")):
                d = _concat([aug_draws(jax.random.fold_in(k, idx), policy,
                                       mb, m.output_size)
                             for k in per_micro(augk)])
                out.update({f"{prefix}{which}/{k}": v
                            for k, v in d.items()})

    if cfg.n_critic == 1:
        critic("critic0/", gp_key, aug_key)
    else:
        for i, ik in enumerate(jax.random.split(gp_key, cfg.n_critic)):
            zk, gpk = jax.random.split(ik)
            out[f"critic{i}/z"] = uniform(zk, (batch, m.z_dim), -1.0, 1.0)
            critic(f"critic{i}/", gpk,
                   jax.random.fold_in(ik, 3) if policy else None)
    if policy:
        d = _concat([aug_draws(jax.random.fold_in(k, 2), policy,
                               batch // n_micro, m.output_size)
                     for k in per_micro(aug_key)])
        out.update({f"g/{k}": v for k, v in d.items()})
    return z, out


def stage_draws(cfg, key, batch):
    """The draws of the JAX stage programs on `key` (all three take the
    step's key and fold in their tag: d_update 0, g_update 1, gen_fakes
    2; `dcgan_tpu/train/steps.py:774-885`), in `steps.draw_stages`'
    layout, as numpy."""
    policy = parse_policy(cfg.diffaug)
    m = cfg.model
    n_micro = cfg.grad_accum
    mb = batch // n_micro
    out = {}

    def per_micro(k):
        return [k] if n_micro == 1 else list(jax.random.split(k, n_micro))

    def slot_z(k):
        # _fake_stack's slot: _critic_streams' z key
        return uniform(jax.random.split(k)[0], (batch, m.z_dim), -1.0, 1.0)

    iter_keys = jax.random.split(jax.random.fold_in(key, 0), cfg.n_critic)
    for i, ik in enumerate(iter_keys):
        p = f"d/critic{i}/"
        _, gpk = jax.random.split(ik)
        if cfg.loss == "wgan-gp":
            out[p + "eps"] = np.concatenate(
                [uniform(k, (mb, 1, 1, 1)).reshape(-1)
                 for k in per_micro(gpk)])
        if policy:
            augk = jax.random.fold_in(ik, 3)
            for idx, which in ((0, "real"), (1, "fake")):
                d = _concat([aug_draws(jax.random.fold_in(k, idx), policy,
                                       mb, m.output_size)
                             for k in per_micro(augk)])
                out.update({f"{p}{which}/{k}": v for k, v in d.items()})
    gk = jax.random.fold_in(key, 1)
    if policy:
        z_key, extra_key, aug_key = jax.random.split(gk, 3)
    else:
        z_key, extra_key = jax.random.split(gk)
    out["g/z"] = uniform(z_key, (batch, m.z_dim), -1.0, 1.0)
    if cfg.n_critic > 1:
        out["g/extra_z"] = np.stack(
            [slot_z(k) for k in jax.random.split(extra_key,
                                                 cfg.n_critic - 1)])
    if policy:
        d = _concat([aug_draws(jax.random.fold_in(k, 2), policy, mb,
                               m.output_size)
                     for k in per_micro(aug_key)])
        out.update({f"g/aug/{k}": v for k, v in d.items()})
    out["fill/z"] = np.stack(
        [slot_z(k) for k in jax.random.split(jax.random.fold_in(key, 2),
                                             cfg.n_critic)])
    return out


def tree_shapes(tree, prefix=""):
    """{path: shape} over a nested dict of arrays or tensors, an empty
    subtree as {path: "{}"}."""
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(tree_shapes(v, p) or {p: "{}"})
        else:
            out[p] = tuple(v.shape)
    return out


def export_tool():
    """tools/export_torch_checkpoint.py as a module (the JAX <-> port
    checkpoint converter)."""
    path = pathlib.Path(__file__).resolve().parent.parent / "tools" / \
        "export_torch_checkpoint.py"
    spec = importlib.util.spec_from_file_location("export_torch_checkpoint",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def to_torch(draws):
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


ROUTES = {"plain": {},
          "use_pallas": {"use_pallas": True},
          "fused": {"use_pallas": True, "pallas_fused": True}}


def numpy_init(init, seed=0):
    """A train state in the tree of the JAX package's `init(key)` (from
    eval_shape: JAX draws nothing, so no per-process compile of its
    random ops), filled from a numpy seed as the init fills it: weights
    N(0, 0.02) cut at 2 sigma, BN scales 1 + the same noise, biases,
    Adam moments and counts 0, running variances 1, the EMA a copy of
    G's weights and step 0; a learned constant (stylegan's `const`)
    N(0, 1) and spectral norm's u vectors unit normals, as the init
    draws them."""
    shapes = jax.eval_shape(init, jax.random.key(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        top, name = path[0].key, getattr(path[-1], "key", None)
        if top == "params" and name in ("w", "scale"):
            noise = np.clip(rng.normal(0, 0.02, leaf.shape), -0.04, 0.04)
            return (noise + (name == "scale")).astype(leaf.dtype)
        if top == "params" and name == "const":
            return rng.normal(size=leaf.shape).astype(leaf.dtype)
        if top == "bn" and str(name).startswith("sn_"):
            u = rng.normal(size=leaf.shape)
            return (u / np.linalg.norm(u)).astype(leaf.dtype)
        if top == "params" and name not in ("b", "bias"):
            raise ValueError(f"numpy_init: no rule for {path}")
        return np.full(leaf.shape, 1 if name == "var" else 0, leaf.dtype)
    state = jax.tree_util.tree_map_with_path(fill, shapes)
    state["ema_gen"] = jax.tree_util.tree_map(np.copy,
                                              state["params"]["gen"])
    return state


def run_both(train_kw, route="plain", *, steps=2, batch=4, size=16,
             dim=8, dtype="float32", start=0, penalties=None,
             resync=False, model_kw=None, labels=None,
             numpy_weights=False):
    """`steps` steps of the JAX package's jitted train_step and of the
    port's from one state (JAX's init, carried over), on the same numpy
    images and the JAX draws; the state step starts at `start`.
    `penalties`, when given, is passed per step to the port as its
    `penalty` flag (None: the port reads the state's step). resync=True
    carries JAX's state over again before each step, so that every step
    of the port starts from JAX's state. A conditional model (num_classes
    in model_kw) gets numpy labels per step, drawn after the images, with
    every class once in each batch of at least num_classes, or the
    `labels` array given at every step. numpy_weights=True starts from
    `numpy_init`'s state instead of JAX's init.

    Returns (JAX metrics per step, port metrics per step, JAX state as
    numpy, port state, JAX initial params as numpy)."""
    from dcgan_tpu.config import ModelConfig as JModelConfig
    from dcgan_tpu.config import TrainConfig as JTrainConfig
    from dcgan_tpu.train import steps as jsteps
    from dcgan_tpu_torch import convert
    from dcgan_tpu_torch.config import ModelConfig, TrainConfig
    from dcgan_tpu_torch.train import steps as tsteps

    mk = dict(output_size=size, gf_dim=dim, df_dim=dim, z_dim=8,
              compute_dtype=dtype, **ROUTES[route], **(model_kw or {}))
    jcfg = JTrainConfig(model=JModelConfig(**mk), batch_size=batch,
                        **train_kw)
    tcfg = TrainConfig(model=ModelConfig(**mk), batch_size=batch,
                       **train_kw)
    jfns = jsteps.make_train_step(jcfg)
    jstate = numpy_init(jfns.init) if numpy_weights \
        else jfns.init(jax.random.key(0))
    jstate["step"] = jnp.asarray(start, jnp.int32)
    init_params = jax.device_get(jstate["params"])
    tstate = convert.train_state_from_jax(jax.device_get(jstate),
                                          device="cpu")
    jstep = jax.jit(jfns.train_step)
    tstep = tsteps.make_train_step(tcfg).train_step
    rng = np.random.default_rng(1)
    jm, tm = [], []
    for i in range(steps):
        images = np.tanh(rng.normal(size=(batch, size, size, 3))).astype(
            np.float32)
        k = mk.get("num_classes", 0)
        step_labels = rng.permutation(np.arange(batch) % k).astype(
            np.int32) if k else None
        if labels is not None:
            step_labels = labels
        key = jax.random.fold_in(jax.random.key(5), i)
        z, draws = step_draws(jcfg, key, batch)
        if resync:
            tstate = convert.train_state_from_jax(jax.device_get(jstate),
                                                  device="cpu")
        jstate, jout = jstep(jstate, jnp.asarray(images), key,
                             *(() if step_labels is None
                               else (jnp.asarray(step_labels),)))
        tstate, tout = tstep(tstate, torch.from_numpy(images),
                             torch.from_numpy(z.copy()), to_torch(draws),
                             None if step_labels is None
                             else torch.from_numpy(step_labels),
                             penalty=None if penalties is None
                             else penalties[i])
        jm.append({k: float(v) for k, v in jout.items()})
        tm.append({k: float(v) for k, v in tout.items()})
    return jm, tm, jax.device_get(jstate), tstate, init_params


def flat_state(state_t):
    """{path: numpy} over params, bn, opt and ema_gen of a port state
    (bfloat16 leaves as float32)."""
    from dcgan_tpu_torch import convert

    def np_of(t):
        return t.float().numpy() if t.dtype == torch.bfloat16 \
            else t.numpy()
    out = {}
    for group in ("params", "bn", "ema_gen"):
        for k, v in convert.flatten(state_t[group]).items():
            out[f"{group}/{k}"] = np_of(v)
    for net in ("gen", "disc"):
        for m in ("mu", "nu"):
            for k, v in convert.flatten(state_t["opt"][net][m]).items():
                out[f"opt/{net}/{m}/{k}"] = np_of(v)
        out[f"opt/{net}/count"] = state_t["opt"][net]["count"].numpy()
    out["step"] = state_t["step"].numpy()
    return out


PRE_BN = re.compile(r"(proj|deconv[1-9]|conv[1-9])/b$|bn[0-9]+/mean$")


def assert_f32_state(jstate, tstate, *, lr=2e-4, steps=1, rtol=1e-5,
                     pre_bn=PRE_BN):
    """Every leaf of params, bn, opt and ema_gen within 1e-5 abs + rtol x
    its largest value, but the biases that feed a BatchNorm and the
    running means they shift (the paths `pre_bn` matches): their true
    gradient is 0, Adam's normalized step follows the sign of f32
    rounding noise, and they are held to Adam's own bound, 2 * lr * steps
    (tests/test_torch_train.py's rule)."""
    from dcgan_tpu_torch import convert

    want = flat_state(convert.train_state_from_jax(jstate, device="cpu"))
    got = flat_state(tstate)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, path
        bound = 2 * lr * steps if pre_bn.search(path) \
            else 1e-5 + rtol * np.abs(w).max()
        err = float(np.abs(g.astype(np.float64) - w).max())
        assert err <= bound, (path, err, bound)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's intra-op pool held to one thread for the module that imports
    this fixture. The port's CPU tests run small ops on tensors of a few
    kilobytes between numpy and JAX calls, where the pool's threads only
    wait on each other: with it at the core count a runner test takes ~30
    times as long, and the test workers beside it slow down too."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
