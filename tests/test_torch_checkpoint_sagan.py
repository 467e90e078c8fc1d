"""A tiny SAGAN's port checkpoint in the JAX package, on the CPU: two port
steps from a state with gamma = 0.5 in both attention blocks, the
Checkpointer's save, `tools/export_torch_checkpoint.py::port_to_jax_state`
(attention weights and the spectral-norm `sn_*` vectors carried), then one
JAX `train_step` and one port step on the same images and z, and both
samplers on the grafted state. Tolerances are tests/test_torch_attention.py's
(losses 1e-5; every leaf 1e-5 + 1e-5 of its scale) and
tests/test_torch_models.py's (f32 images 1e-4). The leaves whose true
gradient is 0 (the biases that feed a BatchNorm, the running means they
shift, the attention's key bias) move on the sign of f32 rounding noise, so
they are held to Adam's own bound for the one step both packages take: with
beta1 0 a step at count t moves a leaf by at most d_lr * sqrt(t) (the step's
own gradient alone in v-hat), and the two packages' noise may differ in sign,
so 2 * d_lr * sqrt(3) at count 3."""

import importlib.util
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dcgan_tpu.config import ModelConfig as JModelConfig
from dcgan_tpu.presets import sagan64 as j_sagan64
from dcgan_tpu.train import steps as jsteps
from dcgan_tpu_torch import convert
from dcgan_tpu_torch.config import ModelConfig, save_config
from dcgan_tpu_torch.models.dcgan import sampler_apply
from dcgan_tpu_torch.presets import sagan64
from dcgan_tpu_torch.train import steps
from dcgan_tpu_torch.train.trainer import METRIC_KEYS
from dcgan_tpu_torch.utils.checkpoint import Checkpointer
from torch_jax_draws import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the dense route (attention without the flash kernels' plain versions)
TINY = dict(output_size=16, gf_dim=16, df_dim=16, z_dim=8, attn_res=8,
            spectral_norm="gd", compute_dtype="float32")
GAMMA = 0.5
BATCH = 4
D_LR = 4e-4
PRE_BN = re.compile(r"(proj|deconv[1-9]|conv[1-9]|attn/key)/b$|"
                    r"bn[0-9]+/mean$")


def _tool():
    spec = importlib.util.spec_from_file_location(
        "export_torch_checkpoint",
        ROOT / "tools" / "export_torch_checkpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _with_gamma(tree):
    """The tree with every attention block's gamma set to GAMMA."""
    return {k: ({**v, "gamma": np.float32(GAMMA)} if k == "attn"
                else _with_gamma(v) if isinstance(v, dict) else v)
            for k, v in tree.items()}


def _inputs(seed):
    images = np.tanh(np.random.default_rng(seed).normal(
        size=(BATCH, 16, 16, 3))).astype(np.float32)
    key = jax.random.fold_in(jax.random.key(5), seed)
    z_key, _ = jax.random.split(key)
    z = np.array(jax.random.uniform(z_key, (BATCH, 8), minval=-1.0,
                                    maxval=1.0, dtype=jnp.float32))
    return images, key, z


def test_port_checkpoint_steps_and_samples_in_jax(tmp_path):
    jcfg = j_sagan64(model=JModelConfig(**TINY), batch_size=BATCH)
    cfg = sagan64(model=ModelConfig(**TINY), batch_size=BATCH,
                  checkpoint_dir=str(tmp_path))
    jfns = jsteps.make_train_step(jcfg)
    template = jax.device_get(jax.jit(jfns.init)(jax.random.key(0)))
    start = {**template, "params": _with_gamma(template["params"]),
             "ema_gen": _with_gamma(template["ema_gen"])}
    state = convert.train_state_from_jax(start, device="cpu")
    tstep = steps.make_train_step(cfg).train_step
    for i in range(2):
        images, _, z = _inputs(i)
        state, _ = tstep(state, torch.from_numpy(images),
                         torch.from_numpy(z))
    save_config(cfg, str(tmp_path))
    ck = Checkpointer(str(tmp_path))
    ck.save(2, state)
    ck.wait()

    jstate = _tool().port_to_jax_state(str(tmp_path), template)
    _assert_graft_exact(jstate, state)
    assert np.asarray(jstate["bn"]["disc"]["sn_attn_key"]).size > 1
    jstate = jax.tree_util.tree_map(jnp.asarray, jstate)

    zs = np.random.default_rng(3).uniform(-1, 1, (6, 8)).astype(np.float32)
    jimg = np.asarray(jax.jit(jfns.sample)(jstate, jnp.asarray(zs)))
    timg = sampler_apply(state["ema_gen"], state["bn"]["gen"],
                         torch.from_numpy(zs), cfg=cfg.model).numpy()
    assert np.abs(jimg - timg).max() <= 1e-4

    images, key, z = _inputs(2)
    jnew, jm = jax.jit(jfns.train_step)(jstate, jnp.asarray(images), key)
    tnew, tm = tstep(state, torch.from_numpy(images), torch.from_numpy(z))
    for k in METRIC_KEYS:
        assert abs(float(jm[k]) - float(tm[k])) <= 1e-5, k
    want = convert.flatten(convert.train_state_from_jax(
        jax.device_get(jnew), device="cpu"))
    got = convert.flatten(tnew)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        if path.startswith("opt/"):
            if PRE_BN.search(path):
                continue
            bound = 1e-5 + 1e-4 * float(w.abs().max())
        elif PRE_BN.search(path):
            bound = 2 * D_LR * np.sqrt(3)
        else:
            bound = 1e-5 + 1e-5 * float(w.abs().max())
        err = float((got[path].double() - w.double()).abs().max())
        assert err <= bound, (path, err, bound)


def _assert_graft_exact(jstate, port_state):
    """Back through train_state_from_jax, the grafted state equals the
    port's bit for bit: every leaf, the sn_* vectors and gamma included."""
    back = convert.flatten(convert.train_state_from_jax(
        jax.device_get(jstate), device="cpu"))
    flat = convert.flatten(port_state)
    assert sorted(back) == sorted(flat)
    for k in flat:
        assert torch.equal(back[k], flat[k]), k
    assert float(flat["params/gen/attn/gamma"]) != 0.0
