"""Weights in and out of the port.

- `generator_from_jax(params_np, state_np)`: the JAX generator's `params`
  and `bn` pytrees, as nested dicts of numpy arrays (`jax.device_get` of
  them), become the port's tensors. The trees have the same names, so this
  is a leaf-by-leaf copy; nothing is transposed (both packages keep HWIO
  kernels and `[in, out]` linear weights). Nested subtrees (the attention
  block's `attn/query/w`, ...) and the spectral-norm `sn_*` state vectors
  carry over the same way.
- `train_state_from_jax(state_np)`: the JAX `init_train_state` pytree (as
  numpy) becomes the port's training state (`train/steps.py`): params, BN
  state, both Adam states, the EMA mirror and the step.
  `train_state_to_numpy(state)` is its inverse: nested numpy arrays with
  optax's (count, mu, nu) per net, which the JAX side grafts into its
  optimizer state by position (`tools/export_torch_checkpoint.py`).
- `save_weights(path, cfg, params, state)` / `load_weights(path)`: an
  `.npz` keyed by pytree path (`params/deconv1/w`, `state/bn0/mean`) with a
  `config.json` beside it, in the trainer's format (`{"model": {...}}`), so
  the JAX package's `load_config` reads it too.

A training checkpoint of the port (`utils/checkpoint.py`) is its state
tree through `flatten`; an Orbax checkpoint of the JAX package is converted
to it, and back, by `tools/export_torch_checkpoint.py` on a host with JAX.

bfloat16 leaves (the bf16 and fp8 precision policies): numpy has no
bfloat16, so an npz holds such a leaf as its uint16 bit pattern and lists
its path in the `BF16_PATHS` entry (`to_npz_arrays`, `from_npz_arrays`):
the state restores bit for bit. A JAX bfloat16 array (an `ml_dtypes`
numpy array) is read through its uint16 view, by its dtype's name, so
nothing here imports `ml_dtypes`.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from dcgan_tpu_torch.config import ModelConfig, load_model_config, \
    save_model_config
from dcgan_tpu_torch.device import resolve_device

Pytree = dict

_SEP = "/"
# the npz entry that lists the paths of the leaves stored as bfloat16 bits
BF16_PATHS = "__bfloat16__"


def flatten(tree: Pytree, prefix: str = "") -> Dict[str, object]:
    """{"deconv1": {"w": x}} -> {"deconv1/w": x}, keys sorted."""
    out: Dict[str, object] = {}
    for name in sorted(tree):
        if _SEP in name:
            raise ValueError(f"tree key {name!r} contains {_SEP!r}")
        path = f"{prefix}{_SEP}{name}" if prefix else name
        value = tree[name]
        if isinstance(value, dict):
            out.update(flatten(value, path))
        else:
            out[path] = value
    return out


def unflatten(flat: Dict[str, object],
              like: Optional[Pytree] = None) -> Pytree:
    """The inverse of `flatten`. A flat dict holds no empty subtree (the
    state of a generator without BatchNorm, of a critic without spectral
    norm); `like`, a tree of the same layout, gives them back."""
    tree: Pytree = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split(_SEP)
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = value
    if like is not None:
        _add_empty(tree, like)
    return tree


def _add_empty(tree: Pytree, like: Pytree) -> None:
    for name, sub in like.items():
        if isinstance(sub, dict):
            _add_empty(tree.setdefault(name, {}), sub)


def leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host as numpy; a bfloat16 one as its uint16 bit
    pattern."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def leaf_from_numpy(a, bfloat16: bool = False) -> torch.Tensor:
    """A numpy array as a tensor: a JAX bfloat16 array (ml_dtypes) or, with
    bfloat16=True, a uint16 bit pattern becomes a bfloat16 tensor with the
    same bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a, bfloat16 = a.view(np.uint16), True
    if bfloat16:
        if a.dtype != np.uint16:
            raise TypeError(f"bfloat16 bits must be uint16, got {a.dtype}")
        return torch.from_numpy(np.ascontiguousarray(a).view(
            np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def to_npz_arrays(flat: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """{path: tensor} as the arrays of an npz, bfloat16 leaves as bits
    with their paths in BF16_PATHS."""
    out = {path: leaf_to_numpy(t) for path, t in flat.items()}
    bf16 = sorted(p for p, t in flat.items() if t.dtype == torch.bfloat16)
    if bf16:
        out[BF16_PATHS] = np.array(bf16)
    return out


def from_npz_arrays(arrays: Dict[str, np.ndarray]
                    ) -> Dict[str, torch.Tensor]:
    """The inverse of `to_npz_arrays`, on the host."""
    arrays = dict(arrays)
    bf16 = set(arrays.pop(BF16_PATHS, np.array([], dtype=str)).tolist())
    return {path: leaf_from_numpy(a, path in bf16)
            for path, a in arrays.items()}


def _to_torch(tree: Pytree, device: torch.device) -> Pytree:
    return unflatten({path: leaf_from_numpy(leaf).to(device)
                      for path, leaf in flatten(tree).items()}, like=tree)


def generator_from_jax(params_np: Pytree, state_np: Pytree, *,
                       device: Union[str, torch.device] = "cuda"
                       ) -> Tuple[Pytree, Pytree]:
    """The JAX generator's (params, bn_state) as the port's tensors."""
    dev = resolve_device(device)
    return _to_torch(params_np, dev), _to_torch(state_np, dev)


def train_state_from_jax(state_np: Pytree, *,
                         device: Union[str, torch.device] = "cuda"
                         ) -> Pytree:
    """The JAX training state as the port's.

    optax's state for each net is (EmptyState(), (ScaleByAdamState(count,
    mu, nu), ScaleByScheduleState(count))), read here by position; the
    port keeps one count per net, which equals both of optax's."""
    dev = resolve_device(device)

    def opt(chain) -> Pytree:
        adam, sched = chain[1][0], chain[1][1]
        count, mu, nu = adam[0], adam[1], adam[2]
        if int(np.asarray(count)) != int(np.asarray(sched[0])):
            raise ValueError(f"Adam count {count} != schedule count "
                             f"{sched[0]}")
        return {"mu": _to_torch(mu, dev), "nu": _to_torch(nu, dev),
                "count": torch.tensor(int(np.asarray(count)),
                                      dtype=torch.int32, device=dev)}

    return {
        "params": _to_torch(state_np["params"], dev),
        "bn": _to_torch(state_np["bn"], dev),
        "opt": {net: opt(state_np["opt"][net]) for net in ("gen", "disc")},
        "ema_gen": _to_torch(state_np["ema_gen"], dev),
        "step": torch.tensor(int(np.asarray(state_np["step"])),
                             dtype=torch.int32, device=dev),
    }


def train_state_to_numpy(state: Pytree) -> Pytree:
    """The port's training state as nested numpy arrays in the JAX state's
    layout, with each net's optimizer state as optax's leaves (count, mu,
    nu); the inverse of `train_state_from_jax`. bfloat16 leaves come out
    as their uint16 bits (`leaf_to_numpy`)."""
    def tree(t: Pytree) -> Pytree:
        return unflatten({path: leaf_to_numpy(leaf)
                          for path, leaf in flatten(t).items()}, like=t)

    def scalar(t: torch.Tensor) -> np.ndarray:
        return np.asarray(int(t), dtype=np.int32)

    return {
        "params": tree(state["params"]),
        "bn": tree(state["bn"]),
        "opt": {net: (scalar(state["opt"][net]["count"]),
                      tree(state["opt"][net]["mu"]),
                      tree(state["opt"][net]["nu"]))
                for net in ("gen", "disc")},
        "ema_gen": tree(state["ema_gen"]),
        "step": scalar(state["step"]),
    }


def _config_dir(path: str) -> str:
    return os.path.dirname(os.path.abspath(path))


def save_weights(path: str, cfg: ModelConfig, params: Pytree,
                 state: Pytree) -> str:
    """Write params and BN state to `path` (.npz) and `cfg` as config.json
    in the same directory; returns the npz path."""
    arrays = to_npz_arrays({**{f"params{_SEP}{k}": v
                                for k, v in flatten(params).items()},
                             **{f"state{_SEP}{k}": v
                                for k, v in flatten(state).items()}})
    directory = _config_dir(path)
    os.makedirs(directory, exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    save_model_config(cfg, directory)
    return path


def load_weights(path: str, *, device: Union[str, torch.device] = "cuda"
                 ) -> Tuple[ModelConfig, Pytree, Pytree]:
    """(cfg, params, state) from an npz written by save_weights and the
    config.json beside it, with the tensors on `device`."""
    dev = resolve_device(device)
    cfg = load_model_config(_config_dir(path))
    with np.load(path) as data:
        flat = from_npz_arrays({name: data[name] for name in data.files})
    groups: Dict[str, Dict[str, torch.Tensor]] = {"params": {}, "state": {}}
    for name, t in flat.items():
        group, _, rest = name.partition(_SEP)
        if group not in groups or not rest:
            raise ValueError(f"{path}: unexpected array {name!r}")
        groups[group][rest] = t.to(dev)
    return cfg, unflatten(groups["params"]), unflatten(groups["state"])
