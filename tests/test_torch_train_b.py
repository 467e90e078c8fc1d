"""Continued from test_torch_train.py: The port's training step against
`dcgan_tpu`'s on the CPU."""

import dataclasses

import pytest

from dcgan_tpu.config import ModelConfig as JModelConfig
from dcgan_tpu.config import TrainConfig as JTrainConfig
from dcgan_tpu.presets import celeba64 as j_celeba64
from dcgan_tpu_torch.config import ModelConfig, TrainConfig
from dcgan_tpu_torch.presets import celeba64
from dcgan_tpu_torch.train import steps
from torch_jax_draws import one_torch_thread  # noqa: F401
from test_torch_train import TRAIN_FIELDS  # noqa: F401


class TestConfig:
    def test_fields_and_defaults_equal_jax(self):
        jt = JTrainConfig()
        for name in TRAIN_FIELDS:
            if name != "model":
                assert getattr(TrainConfig(), name) == getattr(jt, name), \
                    name
        assert dataclasses.asdict(TrainConfig().model) == \
            dataclasses.asdict(jt.model)

    def test_celeba64_preset_equals_jax(self):
        jt = j_celeba64()
        t = celeba64()
        for name in TRAIN_FIELDS:
            if name != "model":
                assert getattr(t, name) == getattr(jt, name), name
        assert dataclasses.asdict(t.model) == dataclasses.asdict(jt.model)

    @pytest.mark.parametrize("make,match", [
        (lambda: TrainConfig(loss="wgan-gp",
                             model=ModelConfig(use_pallas=True)),
         "second derivative"),
        (lambda: TrainConfig(r1_gamma=10.0, model=ModelConfig(
            use_pallas=True, pallas_fused=True)), "second derivative"),
        (lambda: TrainConfig(r1_gamma=1.0, model=ModelConfig(
            use_pallas=True, bn_pallas=False, attn_res=32)),
         "second derivative"),
        # the rollback NaN policy is ported in every family: these two
        # cases keep their ids and now build a config equal to the JAX one
        pytest.param(lambda: TrainConfig(nan_policy="rollback",
                                         model=ModelConfig(arch="resnet")),
                     None, id="<lambda>-not ported0"),
        pytest.param(lambda: TrainConfig(nan_policy="rollback",
                                         model=ModelConfig(
                                             arch="stylegan",
                                             num_classes=10)),
                     None, id="<lambda>-not ported1")])
    def test_unserved_fields_raise(self, make, match):
        """What the port does not train: a penalty whose critic meets a
        kernel route (the JAX package cannot differentiate a Pallas
        kernel twice). The rollback NaN policy is ported in every family:
        its cases (match None) equal the JAX config and build the step."""
        if match is not None:
            with pytest.raises(NotImplementedError, match=match):
                make()
            return
        cfg = make()
        want = JTrainConfig(nan_policy="rollback",
                            model=JModelConfig(**dataclasses.asdict(
                                cfg.model)))
        for name in TRAIN_FIELDS:
            if name != "model":
                assert getattr(cfg, name) == getattr(want, name), name
        assert dataclasses.asdict(cfg.model) == dataclasses.asdict(
            want.model)
        assert steps.make_train_step(cfg).train_step is not None

    @pytest.mark.parametrize("kw", [
        {"loss": "wgan-gp"}, {"n_critic": 5}, {"grad_accum": 2},
        {"precision": "bf16"}, {"diffaug": "color"},
        {"precision": "fp8"}, {"r1_gamma": 10.0, "r1_interval": 4},
        {"loss": "hinge", "n_critic": 2, "grad_accum": 4,
         "diffaug": "color,translation,cutout", "precision": "bf16",
         "model": "fused"}])
    def test_served_fields_equal_jax(self, tmp_path, kw):
        """The settings of the penalty slice construct in the port, equal
        to the JAX package's normalized config, and each package's
        config.json loads in the other."""
        if kw.get("model") == "fused":
            kw = dict(kw)
            del kw["model"]
            jt = JTrainConfig(model=JModelConfig(
                use_pallas=True, pallas_fused=True), **kw)
            t = TrainConfig(model=ModelConfig(
                use_pallas=True, pallas_fused=True), **kw)
        else:
            jt, t = JTrainConfig(**kw), TrainConfig(**kw)
        for name in TRAIN_FIELDS:
            if name != "model":
                assert getattr(t, name) == getattr(jt, name), name
        assert dataclasses.asdict(t.model) == dataclasses.asdict(jt.model)
        from dcgan_tpu import config as j_config
        from dcgan_tpu_torch import config as t_config

        t_config.save_config(t, str(tmp_path / "port"))
        assert j_config.load_config(str(tmp_path / "port")) == jt
        j_config.save_config(jt, str(tmp_path / "jax"))
        assert t_config.load_config(str(tmp_path / "jax")) == t
