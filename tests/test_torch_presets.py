"""The port's presets against the JAX package's factories: every preset
the port registers equals the JAX one over the fields both TrainConfigs
have, its model field for field, and the JAX package has no preset the
port lacks (the two that name a mesh, lsun64-dp8 and sagan256-lc, pinned
with their mesh and backend); the CLI offers exactly the port's presets,
and their overrides apply as in JAX.
The trainer CLI's flags that the JAX CLI also has (its names, types and
choices) give the JAX CLI's TrainConfig for the same arguments.
"""

import dataclasses

import pytest

from dcgan_tpu import presets as jpresets
from dcgan_tpu_torch import presets
from dcgan_tpu_torch.config import TrainConfig
from dcgan_tpu_torch.train import cli
from torch_jax_draws import one_torch_thread  # noqa: F401

PORTED = ["celeba64", "dcgan128", "cifar10-cond", "wgan-gp", "sagan64",
          "sagan128", "sngan-cifar10", "stylegan64", "lsun64-dp8",
          "sagan256-lc"]
# the presets that name a mesh: (mesh fields, backend) of the JAX factory
MESH_PRESETS = {
    "lsun64-dp8": ({"data": 8, "model": 1, "spatial": False,
                    "shard_opt": False, "zero_stage": 1}, "gspmd"),
    "sagan256-lc": ({"data": -1, "model": 1, "spatial": False,
                     "shard_opt": False, "zero_stage": 1}, "shard_map")}


def _shared_fields():
    jax_fields = {f.name for f in dataclasses.fields(
        jpresets.celeba64().__class__)}
    return sorted({f.name for f in dataclasses.fields(TrainConfig)}
                  & jax_fields - {"model"})


def test_every_jax_preset_is_ported_or_refused():
    assert sorted(presets.PRESETS) == sorted(PORTED)
    assert sorted(PORTED) == sorted(jpresets.PRESETS)
    assert presets.UNPORTED == {}


@pytest.mark.parametrize("name", PORTED)
def test_preset_equals_jax_factory(name):
    want = jpresets.get_preset(name)
    got = presets.get_preset(name)
    for field in _shared_fields():
        assert getattr(got, field) == getattr(want, field), field
    assert dataclasses.asdict(got.model) == dataclasses.asdict(want.model)
    # overrides reach the TrainConfig as in the JAX factory
    assert presets.get_preset(name, batch_size=8).batch_size == \
        jpresets.get_preset(name, batch_size=8).batch_size == 8


@pytest.mark.parametrize("name", sorted(MESH_PRESETS))
def test_mesh_preset_pins_mesh_and_backend(name):
    """The presets that name a mesh: every field both TrainConfigs have
    equal to the JAX factory's, the mesh (field by field, and as the
    MeshConfig both packages compare equal) and the backend the JAX
    factory's values."""
    want, got = jpresets.get_preset(name), presets.get_preset(name)
    mesh, backend = MESH_PRESETS[name]
    assert dataclasses.asdict(got.mesh) == dataclasses.asdict(want.mesh) \
        == mesh
    assert got.mesh == want.mesh and want.mesh == got.mesh
    assert got.backend == want.backend == backend
    for field in _shared_fields():
        assert getattr(got, field) == getattr(want, field), field
    assert dataclasses.asdict(got.model) == dataclasses.asdict(want.model)


def test_unknown_preset_lists_the_ports():
    with pytest.raises(ValueError, match="cifar10-cond"):
        presets.get_preset("nope")


def test_cli_offers_the_ported_presets():
    choices = next(a.choices for a in cli.build_parser()._actions
                   if a.dest == "preset")
    assert sorted(choices) == sorted(PORTED)
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        ["--preset", "sagan128", "--gf_dim", "16"]))
    want = jpresets.sagan128()
    assert cfg.model.attn_res == want.model.attn_res == 64
    assert cfg.model.gf_dim == 16 and cfg.g_ema_decay == want.g_ema_decay


# flag -> a value other than every preset's, as the JAX CLI spells it
JAX_FLAGS = {"learning_rate": "3e-4", "d_learning_rate": "5e-4",
             "g_learning_rate": "1.5e-4", "beta1": "0.25",
             "warmup_steps": "7", "g_ema_decay": "0.99",
             "label_smoothing": "0.1", "spectral_norm": "gd",
             "attn_heads": "2", "c_dim": "1", "arch": "stylegan",
             "nan_policy": "rollback", "rollback_snapshot_steps": "20",
             "max_rollbacks": "5", "rollback_lr_backoff": "0.5",
             "async_services": "false", "flight_recorder_steps": "16",
             "collective_timeout_secs": "30", "profile_dir": "traces",
             "profile_start_step": "3", "profile_num_steps": "7",
             "profile_trigger": "trace_now", "timing_window": "9",
             "seq_strategy": "ulysses"}
