"""The port's presets against the JAX package's factories: every preset
the port registers equals the JAX one over the fields both TrainConfigs
have, its model field for field; every JAX preset the port does not
register raises a ValueError that names what it waits for; the CLI
offers exactly the port's presets, and their overrides apply as in JAX.
"""

import dataclasses

import pytest

from dcgan_tpu import presets as jpresets
from dcgan_tpu_torch import presets
from dcgan_tpu_torch.config import TrainConfig
from dcgan_tpu_torch.train import cli

PORTED = ["celeba64", "dcgan128", "cifar10-cond", "wgan-gp", "sagan64",
          "sagan128"]
UNPORTED = {"lsun64-dp8": "multi-GPU", "sagan256-lc": "multi-GPU",
            "sngan-cifar10": "resnet", "stylegan64": "stylegan"}


def _shared_fields():
    jax_fields = {f.name for f in dataclasses.fields(
        jpresets.celeba64().__class__)}
    return sorted({f.name for f in dataclasses.fields(TrainConfig)}
                  & jax_fields - {"model"})


def test_every_jax_preset_is_ported_or_refused():
    assert sorted(presets.PRESETS) == sorted(PORTED)
    assert sorted(PORTED + list(UNPORTED)) == sorted(jpresets.PRESETS)
    assert sorted(presets.UNPORTED) == sorted(UNPORTED)


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


@pytest.mark.parametrize("name,waits_for", sorted(UNPORTED.items()))
def test_unported_preset_names_what_it_waits_for(name, waits_for):
    jpresets.get_preset(name)   # the JAX package builds it
    with pytest.raises(ValueError, match="not ported") as e:
        presets.get_preset(name)
    assert name in str(e.value) and waits_for in str(e.value)


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
