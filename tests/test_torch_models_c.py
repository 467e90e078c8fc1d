"""Continued from test_torch_models.py: The port's generator and discriminator
against `dcgan_tpu`'s on shared weights and inputs."""

import dataclasses
import json

import pytest

from dcgan_tpu.config import ModelConfig as JModelConfig
from dcgan_tpu.config import config_to_dict
from dcgan_tpu.config import TrainConfig as JTrainConfig
from dcgan_tpu.presets import celeba64 as j_celeba64
from dcgan_tpu_torch.config import ModelConfig, celeba64, \
    model_config_from_dict
from torch_jax_draws import one_torch_thread  # noqa: F401


class TestConfig:
    def test_same_fields_and_defaults_as_jax(self):
        assert dataclasses.asdict(ModelConfig()) == \
            dataclasses.asdict(JModelConfig())

    def test_celeba64_is_the_presets_model(self):
        assert dataclasses.asdict(celeba64()) == \
            dataclasses.asdict(j_celeba64().model)
        assert celeba64(use_pallas=True).use_pallas

    def test_reads_a_trainer_config_json(self):
        d = json.loads(json.dumps(config_to_dict(JTrainConfig(
            model=JModelConfig(output_size=32, gf_dim=16)))))
        cfg = model_config_from_dict(d)
        assert cfg.output_size == 32 and cfg.gf_dim == 16
        assert cfg.num_up_layers == 3

    @pytest.mark.parametrize("kw", [
        {"arch": "resnet"}, {"arch": "resnet", "num_classes": 10},
        {"arch": "stylegan"}, {"arch": "stylegan", "num_classes": 10},
        {"arch": "resnet", "quant": "fp8"}])
    def test_unserved_fields_raise(self, kw):
        """The model families the port once refused are served: each
        config equals the JAX ModelConfig field for field. What raises is
        the JAX package's own check, with its message: no attention site
        in the stylegan family."""
        assert dataclasses.asdict(ModelConfig(**kw)) == \
            dataclasses.asdict(JModelConfig(**kw))
        bad = dict(kw, arch="stylegan", attn_res=8)
        with pytest.raises(ValueError):
            JModelConfig(**bad)
        with pytest.raises(ValueError, match="no attention site"):
            ModelConfig(**bad)

    def test_fp8_quant_is_served(self):
        """quant="fp8" (set by the fp8 precision policy) constructs, equal
        to the JAX ModelConfig."""
        assert dataclasses.asdict(ModelConfig(quant="fp8")) == \
            dataclasses.asdict(JModelConfig(quant="fp8"))

    @pytest.mark.parametrize("kw", [
        {"output_size": 48}, {"arch": "vit"}, {"pallas_fused": True},
        {"bn_pallas": True}, {"quant": "int4"}])
    def test_jax_validation_kept(self, kw):
        with pytest.raises(ValueError):
            JModelConfig(**kw)
        with pytest.raises(ValueError):
            ModelConfig(**kw)
