"""Continued from test_torch_presets.py: The port's presets against the JAX
package's factories."""

import dataclasses

import pytest

from dcgan_tpu import presets as jpresets
from dcgan_tpu_torch import presets
from dcgan_tpu_torch.train import cli
from torch_jax_draws import one_torch_thread  # noqa: F401
from test_torch_presets import JAX_FLAGS, _shared_fields  # noqa: F401


@pytest.mark.parametrize("flag", sorted(JAX_FLAGS))
def test_trainer_flag_equals_the_jax_cli(flag):
    """Each flag parses with the JAX CLI's name and type; with the preset
    it lands on the TrainConfig as the JAX CLI's preset path puts it
    (apply_overrides over explicit_flags), and every other field keeps
    the preset's value."""
    from dcgan_tpu.train import cli as jcli

    # label smoothing is BCE's alone; every other flag on a ported preset
    # of the new families
    preset = "celeba64" if flag == "label_smoothing" else "sngan-cifar10"
    argv = ["--preset", preset, f"--{flag}", JAX_FLAGS[flag]]
    if flag == "attn_heads":
        argv += ["--attn_res", "16"]
    want = jcli.apply_overrides(jpresets.get_preset(preset),
                                jcli.explicit_flags(argv))
    got = cli.config_from_args(cli.build_parser().parse_args(argv))
    for field in _shared_fields():
        assert getattr(got, field) == getattr(want, field), field
    assert dataclasses.asdict(got.model) == dataclasses.asdict(want.model)
    default = presets.get_preset(preset)
    changed = {f for f in _shared_fields()
               if getattr(got, f) != getattr(default, f)}
    changed |= {f"model.{k}" for k, v in dataclasses.asdict(
        got.model).items() if getattr(default.model, k) != v}
    assert changed and len(changed) <= 2, changed
