#!/usr/bin/env python3
"""Convert training checkpoints between `dcgan_tpu` (Orbax) and its
PyTorch port `dcgan_tpu_torch` (npz + integrity manifest).

JAX -> port, on a host where JAX and Orbax are installed:

    python tools/export_torch_checkpoint.py --checkpoint_dir JAX_RUN \
        --out_dir PORT_RUN

restores the newest intact Orbax checkpoint of JAX_RUN with the JAX
`Checkpointer.restore_latest` into `init_train_state`'s template (the
architecture from JAX_RUN's config.json), converts it with the port's
`convert.train_state_from_jax`, and writes it with the port's Checkpointer
together with the port's config.json. The port then serves it
(`python -m dcgan_tpu_torch.serve --checkpoint_dir PORT_RUN`) or trains on
from it (`python -m dcgan_tpu_torch.train --checkpoint_dir PORT_RUN`).

Port -> JAX: `port_to_jax_state(port_dir, template)` restores the newest
intact checkpoint of the port's directory and grafts it into a JAX
training-state pytree of the same config (`template`, e.g.
`init_train_state`'s), each net's optax state rebuilt by position from the
port's (count, mu, nu).

A progressive run's phase tag crosses both ways. A JAX checkpoint saved
mid-schedule holds an earlier phase's tree and names the phase in its
sharding sidecar (`"progressive": {"phase", "resolution"}`): `export`
builds its restore template at that resolution and writes the tag into
the port's manifest, so the port resumes in that phase. The other way,
`dcgan_tpu_torch.utils.checkpoint.latest_progressive_tag(port_dir)` reads
the tag of the port's newest step (and `port_to_jax_state` restores at
its resolution); set it as the JAX Checkpointer's `progressive_tag` before
the save, which writes it into the sidecar of a state placed on a mesh.

bfloat16 leaves (the bf16 and fp8 precision policies) cross both ways
bit for bit: a JAX bfloat16 array is read through its uint16 view
(`convert.leaf_from_numpy`), and a port leaf comes out as its uint16 bits
and is viewed as the template leaf's bfloat16 dtype.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, List, Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

Pytree = Any


def port_to_jax_state(port_dir: str, template: Pytree) -> Pytree:
    """The newest intact checkpoint of the port's `port_dir` as a JAX
    training state shaped like `template` (numpy leaves)."""
    from dcgan_tpu_torch import convert
    from dcgan_tpu_torch.config import consumer_train_config, load_config, \
        resolve_model_config
    from dcgan_tpu_torch.train.steps import init_train_state
    from dcgan_tpu_torch.utils.checkpoint import Checkpointer

    cfg = load_config(port_dir)
    if cfg is None:
        raise FileNotFoundError(f"no config.json in {port_dir}")
    # a progressive run's newest step may hold an earlier phase's tree
    cfg = consumer_train_config(port_dir, resolve_model_config(port_dir))
    restored = Checkpointer(port_dir).restore_latest(
        init_train_state(cfg, device="cpu"))
    if restored is None:
        raise FileNotFoundError(f"no checkpoint under {port_dir}")
    return graft_to_jax(convert.train_state_to_numpy(restored), template)


def graft_to_jax(state: Pytree, template: Pytree) -> Pytree:
    """A port state as numpy (`convert.train_state_to_numpy`) grafted into
    a JAX training state shaped like `template` (whose leaves need only a
    shape and a dtype: `jax.eval_shape`'s do)."""
    import jax
    import numpy as np

    def as_template(a, b):
        # a bfloat16 leaf's uint16 bits as the template's bfloat16 dtype
        if a.dtype.name == "bfloat16" and b.dtype == np.uint16:
            return b.view(a.dtype)
        return b

    def with_empty(tmpl, tree):
        # the port's flat paths keep no empty subtree (the BN state of a D
        # with one stage): the template's come back
        if isinstance(tmpl, dict):
            return {k: with_empty(v, tree.get(k, {})) for k, v in
                    tmpl.items()}
        return tree

    out = dict(template)
    for group in ("params", "bn", "ema_gen"):
        # the same tree, or raises
        out[group] = jax.tree_util.tree_map(
            as_template, template[group],
            with_empty(template[group], state[group]))
    out["step"] = state["step"]
    out["opt"] = {}
    for net, opt in template["opt"].items():
        leaves, treedef = jax.tree_util.tree_flatten(opt)
        count, mu, nu = state["opt"][net]
        # optax.chain(clip or identity, adam) holds, in flatten order,
        # ScaleByAdamState(count, mu, nu) then ScaleByScheduleState(count)
        new = [count, *jax.tree_util.tree_leaves(mu),
               *jax.tree_util.tree_leaves(nu), count]
        if len(new) != len(leaves):
            raise ValueError(
                f"opt/{net}: the JAX optimizer state has {len(leaves)} "
                f"leaves, the port's checkpoint gives {len(new)}")
        new = [as_template(a, b) for a, b in zip(leaves, new)]
        for i, (a, b) in enumerate(zip(leaves, new)):
            if tuple(a.shape) != tuple(b.shape):
                raise ValueError(f"opt/{net} leaf {i}: {a.shape} in the "
                                 f"template, {b.shape} in the checkpoint")
        out["opt"][net] = jax.tree_util.tree_unflatten(treedef, new)
    return out


def export(checkpoint_dir: str, out_dir: str) -> int:
    """Write the newest intact Orbax checkpoint of `checkpoint_dir` in the
    port's format under `out_dir`; returns its step."""
    import dataclasses

    import jax
    import numpy as np

    from dcgan_tpu.config import _progressive_checkpoint_resolution
    from dcgan_tpu.config import config_to_dict
    from dcgan_tpu.config import load_config as jax_load_config
    from dcgan_tpu.elastic import sidecar
    from dcgan_tpu.train.steps import init_train_state as jax_init
    from dcgan_tpu.utils.checkpoint import Checkpointer as JaxCheckpointer
    from dcgan_tpu_torch import convert
    from dcgan_tpu_torch.config import config_from_dict, save_config
    from dcgan_tpu_torch.utils.checkpoint import Checkpointer

    jcfg = jax_load_config(checkpoint_dir)
    if jcfg is None:
        raise FileNotFoundError(f"no config.json in {checkpoint_dir}")
    # the port's config first: a config the port cannot train raises here
    cfg = config_from_dict(config_to_dict(jcfg))
    # a checkpoint saved mid-schedule holds the tree of the phase its
    # sidecar names
    tcfg = jcfg
    res = _progressive_checkpoint_resolution(checkpoint_dir) \
        if jcfg.progressive else None
    if res is not None:
        tcfg = dataclasses.replace(
            jcfg, progressive="", progressive_fade_steps=0,
            model=dataclasses.replace(jcfg.model, output_size=res))
    jckpt = JaxCheckpointer(checkpoint_dir)
    try:
        # the template's shapes and dtypes, without running (or compiling)
        # the init
        template = jax.tree_util.tree_map(
            lambda s: jax.device_put(np.zeros(s.shape, s.dtype)),
            jax.eval_shape(lambda key: jax_init(key, tcfg),
                           jax.random.key(0)))
        restored = jckpt.restore_latest(template)
    finally:
        jckpt.close()
    if restored is None:
        raise FileNotFoundError(f"no checkpoint under {checkpoint_dir}")
    state = convert.train_state_from_jax(jax.device_get(restored),
                                         device="cpu")
    step = int(state["step"])
    save_config(cfg, out_dir)
    ckpt = Checkpointer(out_dir, async_save=False)
    ckpt.progressive_tag = (sidecar.read(checkpoint_dir, step) or {}).get(
        "progressive")
    ckpt.save(step, state)
    return step


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="write the newest intact Orbax checkpoint of a "
                    "dcgan_tpu run as a dcgan_tpu_torch checkpoint")
    p.add_argument("--checkpoint_dir", required=True,
                   help="the JAX run's checkpoint directory")
    p.add_argument("--out_dir", required=True,
                   help="the port's checkpoint directory to write")
    args = p.parse_args(argv)
    step = export(args.checkpoint_dir, args.out_dir)
    print(f"exported step {step} of {args.checkpoint_dir} to "
          f"{args.out_dir}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
