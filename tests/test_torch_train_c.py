"""Continued from test_torch_train.py: The port's training step against
`dcgan_tpu`'s on the CPU."""

import json

import numpy as np
import pytest

from dcgan_tpu.config import ModelConfig as JModelConfig
from dcgan_tpu.config import TrainConfig as JTrainConfig
from dcgan_tpu.data.synthetic import synthetic_batches as j_synthetic
from dcgan_tpu.utils.profiling import StepTimer as JStepTimer
from dcgan_tpu_torch.config import ModelConfig, TrainConfig
from dcgan_tpu_torch.data.synthetic import synthetic_batches
from dcgan_tpu_torch.presets import celeba64
from dcgan_tpu_torch.train import cli
from dcgan_tpu_torch.train.trainer import METRIC_KEYS
from torch_jax_draws import one_torch_thread  # noqa: F401


class TestConfig:
    @pytest.mark.parametrize("kw", [
        {"loss": "l2"}, {"update_mode": "both"}, {"grad_clip": -1.0},
        {"label_smoothing": 0.5}, {"g_ema_decay": 1.0},
        {"lr_schedule": "step"}, {"warmup_steps": 10, "max_steps": 10},
        {"precision": "fp16"}, {"batch_size": 6, "grad_accum": 4},
        {"r1_gamma": -1.0}, {"r1_gamma": 1.0, "loss": "wgan-gp"},
        {"r1_interval": 0}, {"r1_interval": 4}, {"diffaug": "flip"},
        {"n_critic": 2, "update_mode": "fused"},
        {"model": "quant"}])
    def test_jax_validation_kept(self, kw):
        if kw.get("model") == "quant":
            # model.quant set without the precision policy
            with pytest.raises(ValueError, match="precision policy"):
                JTrainConfig(model=JModelConfig(quant="fp8"))
            with pytest.raises(ValueError, match="precision policy"):
                TrainConfig(model=ModelConfig(quant="fp8"))
            return
        with pytest.raises(ValueError):
            JTrainConfig(**kw)
        with pytest.raises(ValueError):
            TrainConfig(**kw)

    def test_precision_f32_forces_the_model_dtypes(self):
        assert TrainConfig(precision="f32").model.compute_dtype == "float32"
        assert JTrainConfig(precision="f32").model.compute_dtype == \
            "float32"


class TestDataAndTrainer:
    def test_synthetic_batches_equal_jax(self):
        a, b = synthetic_batches(4, 8, seed=7), j_synthetic(4, 8, seed=7)
        for _ in range(3):
            np.testing.assert_array_equal(next(a), next(b))

    def test_cli_writes_jax_event_format(self, tmp_path):
        """Two steps through `python -m dcgan_tpu_torch.train`'s entry
        point on the CPU: events.jsonl has one scalars event per step in
        the JAX package's format, with its loss keys and, once the timer
        has two ticks, exactly the JAX StepTimer's perf/* keys."""
        state = cli.main([
            "--preset", "celeba64", "--synthetic", "--max_steps", "2",
            "--device", "cpu", "--output_size", "16", "--gf_dim", "8",
            "--df_dim", "8", "--z_dim", "8", "--batch_size", "4",
            "--use_pallas", "--pallas_fused",
            "--checkpoint_dir", str(tmp_path)])
        assert int(state["step"]) == 2
        events = [json.loads(line) for line in
                  (tmp_path / "events.jsonl").read_text().splitlines()]
        assert [e["step"] for e in events] == [1, 2]
        timer = JStepTimer(images_per_step=4)
        for t in (0.0, 1.0):
            timer.tick(t)
        perf_keys = set(timer.summary())
        for e in events:
            assert set(e) == {"kind", "step", "time", "values"}
            assert e["kind"] == "scalars" and isinstance(e["time"], float)
            assert all(np.isfinite(v) for v in e["values"].values())
        assert set(events[0]["values"]) == set(METRIC_KEYS)
        assert set(events[1]["values"]) == set(METRIC_KEYS) | perf_keys

    def test_cli_needs_synthetic(self, tmp_path):
        """Without --synthetic the trainer reads --data_dir's TFRecord
        shards (the default data_dir, "train", when none is given): an
        empty directory fails and names it."""
        with pytest.raises(FileNotFoundError,
                           match=f"no TFRecord shards in {tmp_path}"):
            cli.main(["--max_steps", "1", "--device", "cpu", "--data_dir",
                      str(tmp_path), "--checkpoint_dir",
                      str(tmp_path / "run")])

    def test_flags_override_the_preset(self):
        args = cli.build_parser().parse_args(
            ["--batch_size", "8", "--use_pallas", "--update_mode", "fused",
             "--synthetic"])
        cfg = cli.config_from_args(args)
        assert cfg.batch_size == 8 and cfg.update_mode == "fused"
        assert cfg.model.use_pallas and not cfg.model.pallas_fused
        assert cfg.max_steps == celeba64().max_steps
