"""Weights in and out of the port.

- `generator_from_jax(params_np, state_np)`: the JAX generator's `params`
  and `bn` pytrees, as nested dicts of numpy arrays (`jax.device_get` of
  them), become the port's tensors. The trees have the same names, so this
  is a leaf-by-leaf copy; nothing is transposed (both packages keep HWIO
  kernels and `[in, out]` linear weights).
- `save_weights(path, cfg, params, state)` / `load_weights(path)`: an
  `.npz` keyed by pytree path (`params/deconv1/w`, `state/bn0/mean`) with a
  `config.json` beside it, in the trainer's format (`{"model": {...}}`), so
  the JAX package's `load_config` reads it too.

Reading an Orbax checkpoint needs JAX; exporting one to this `.npz` is a
later item of the port.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple, Union

import numpy as np
import torch

from dcgan_tpu_torch.config import ModelConfig, load_model_config, \
    save_model_config
from dcgan_tpu_torch.device import resolve_device

Pytree = dict

_SEP = "/"


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


def unflatten(flat: Dict[str, object]) -> Pytree:
    tree: Pytree = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split(_SEP)
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = value
    return tree


def _to_torch(tree: Pytree, device: torch.device) -> Pytree:
    return unflatten({path: torch.from_numpy(np.array(leaf)).to(device)
                      for path, leaf in flatten(tree).items()})


def _to_numpy(tree: Pytree) -> Dict[str, np.ndarray]:
    out = {}
    for path, leaf in flatten(tree).items():
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            raise TypeError(f"{path}: bfloat16 leaves have no numpy dtype; "
                            "store parameters in float32 (param_dtype)")
        out[path] = t.numpy()
    return out


def generator_from_jax(params_np: Pytree, state_np: Pytree, *,
                       device: Union[str, torch.device] = "cuda"
                       ) -> Tuple[Pytree, Pytree]:
    """The JAX generator's (params, bn_state) as the port's tensors."""
    dev = resolve_device(device)
    return _to_torch(params_np, dev), _to_torch(state_np, dev)


def _config_dir(path: str) -> str:
    return os.path.dirname(os.path.abspath(path))


def save_weights(path: str, cfg: ModelConfig, params: Pytree,
                 state: Pytree) -> str:
    """Write params and BN state to `path` (.npz) and `cfg` as config.json
    in the same directory; returns the npz path."""
    arrays = {f"params{_SEP}{k}": v for k, v in _to_numpy(params).items()}
    arrays.update({f"state{_SEP}{k}": v for k, v in _to_numpy(state).items()})
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
        flat = {name: data[name] for name in data.files}
    groups: Dict[str, Dict[str, np.ndarray]] = {"params": {}, "state": {}}
    for name, arr in flat.items():
        group, _, rest = name.partition(_SEP)
        if group not in groups or not rest:
            raise ValueError(f"{path}: unexpected array {name!r}")
        groups[group][rest] = arr
    return (cfg, _to_torch(unflatten(groups["params"]), dev),
            _to_torch(unflatten(groups["state"]), dev))
