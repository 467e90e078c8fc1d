"""The port trainer's NaN gate and preemption stop, against the JAX
trainer's (`dcgan_tpu/train/trainer.py:289-311, 1162-1198`).

- A NaN learning rate poisons D in the first update, so the G loss
  (against the updated D) is already NaN at step 1: both trainers raise
  FloatingPointError naming step 1 (the JAX trainer's
  `test_nan_check_aborts_with_context`), with the same message but for
  the values, and the port writes no checkpoint of the poisoned state.
  Under steps_per_call 2 the gate checks every step of a call on its
  cadence.
- nan_policy="rollback" (ported) loads from a JAX config.json with the
  JAX values and trains; its validation is the JAX package's.
- SIGTERM at step 3 of a trainer in a subprocess (CPU, tiny model,
  synthetic data): exit 0 after "received signal", a checkpoint at step 3
  or later, and the directory resumes (the JAX test at
  `tests/test_trainer.py:305-370`, on the port).
"""

import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import time

import pytest

from dcgan_tpu.config import ModelConfig as JModelConfig
from dcgan_tpu.config import TrainConfig as JTrainConfig
from dcgan_tpu.train.trainer import train as j_train
from dcgan_tpu_torch.config import ModelConfig, TrainConfig, \
    config_from_dict, load_config
from dcgan_tpu_torch.train import cli, trainer
from dcgan_tpu_torch.utils.checkpoint import Checkpointer
from torch_jax_draws import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(output_size=16, gf_dim=8, df_dim=8, compute_dtype="float32")


def _cfg(cls, mcls, tmp_path, **kw):
    base = dict(model=mcls(**MODEL), batch_size=8,
                checkpoint_dir=str(tmp_path / "ckpt"),
                sample_dir=str(tmp_path / "samples"), sample_every_steps=0,
                save_summaries_secs=0.0, save_model_secs=1e9,
                activation_summary_steps=0)
    base.update(kw)
    return cls(**base)


def _message(err):
    """The message with the metric values taken out."""
    return re.sub(r"\{.*\}", "{...}", str(err)).replace(
        "dcgan_tpu_torch", "dcgan_tpu")


def test_nan_gate_matches_jax(tmp_path):
    jcfg = _cfg(JTrainConfig, JModelConfig, tmp_path / "jax",
                learning_rate=float("nan"), nan_check_steps=1)
    tcfg = _cfg(TrainConfig, ModelConfig, tmp_path / "port",
                learning_rate=float("nan"), nan_check_steps=1,
                tensorboard=False)
    with pytest.raises(FloatingPointError, match="step 1") as je:
        j_train(jcfg, synthetic_data=True, max_steps=5)
    with pytest.raises(FloatingPointError, match="step 1") as te:
        trainer.train(tcfg, synthetic_data=True, max_steps=5, device="cpu")
    assert te.value.step == je.value.step == 1
    assert _message(te.value).replace(str(tmp_path / "port"), "D") == \
        _message(je.value).replace(str(tmp_path / "jax"), "D")
    assert "nan" in str(te.value) and "g_loss" in str(te.value)
    # nothing of the poisoned state was saved
    assert Checkpointer(tcfg.checkpoint_dir).latest_step() is None


def test_nan_gate_checks_every_step_of_a_call(tmp_path, monkeypatch):
    """steps_per_call 2 with nan_check_steps 1: a non-finite value in the
    first step of a call trips the gate at that step, not the call's
    last; off the cadence (nan_check_steps 4) the gate stays quiet."""
    real = trainer.StepRunner.step

    def poisoned(self, *a, **k):
        out = real(self, *a, **k)
        if out.shape[0] == 2:
            out[0, 0] = float("inf")
        return out
    monkeypatch.setattr(trainer.StepRunner, "step", poisoned)
    cfg = _cfg(TrainConfig, ModelConfig, tmp_path, steps_per_call=2,
               nan_check_steps=1, tensorboard=False)
    with pytest.raises(FloatingPointError) as e:
        trainer.train(cfg, synthetic_data=True, max_steps=5, device="cpu")
    assert e.value.step == 3   # the warm-up step 1, a step to 2, then 3-4
    quiet = dataclasses.replace(cfg, nan_check_steps=4,
                                checkpoint_dir=str(tmp_path / "quiet"))
    state = trainer.train(quiet, synthetic_data=True, max_steps=4,
                          device="cpu")
    assert int(state["step"]) == 4


def test_rollback_is_refused_by_name(tmp_path):
    """nan_policy="rollback" is ported: a JAX config.json that arms it
    (with its snapshot cadence, budget and backoff) loads into the JAX
    config's values and trains; the policy's validation stays the JAX
    package's."""
    with pytest.raises(ValueError, match="needs the NaN gate"):
        TrainConfig(nan_policy="rollback", nan_check_steps=0)
    with pytest.raises(ValueError, match="nan_policy must be"):
        TrainConfig(nan_policy="skip")
    jcfg = JTrainConfig(model=JModelConfig(**MODEL), nan_policy="rollback",
                        batch_size=8, rollback_snapshot_steps=2,
                        max_rollbacks=1, rollback_lr_backoff=0.5,
                        flight_recorder_steps=8, async_services=False,
                        collective_timeout_secs=120.0,
                        checkpoint_dir=str(tmp_path / "ckpt"),
                        sample_dir=str(tmp_path / "samples"),
                        sample_every_steps=0, activation_summary_steps=0,
                        tensorboard=False)
    d = json.loads(json.dumps(dataclasses.asdict(jcfg)))
    cfg = config_from_dict(d)
    for f in dataclasses.fields(TrainConfig):
        if f.name != "model":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    state = trainer.train(cfg, synthetic_data=True, max_steps=2,
                          device="cpu")
    assert int(state["step"]) == 2
    d["nan_policy"] = "abort"
    assert config_from_dict(d).nan_check_steps == jcfg.nan_check_steps
    assert cli.config_from_args(cli.build_parser().parse_args(
        ["--nan_check_steps", "0"])).nan_check_steps == 0


def test_sigterm_checkpoints_and_resumes(tmp_path):
    code = f"""
from dcgan_tpu_torch.config import ModelConfig, TrainConfig
from dcgan_tpu_torch.train.trainer import train
cfg = TrainConfig(model=ModelConfig(output_size=16, gf_dim=8, df_dim=8,
                                    z_dim=8, compute_dtype="float32"),
                  batch_size=4, checkpoint_dir={str(tmp_path / "ck")!r},
                  sample_dir={str(tmp_path / "sm")!r},
                  sample_every_steps=0, activation_summary_steps=0,
                  save_summaries_secs=1e9, save_model_secs=1e9,
                  tensorboard=False, log_every_steps=1)
train(cfg, synthetic_data=True, max_steps=100000, device="cpu")
print("TRAIN_RETURNED", flush=True)
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        saw_step = False
        deadline = time.time() + 120
        for line in proc.stdout:
            if " step 3 " in line:
                saw_step = True
                proc.send_signal(signal.SIGTERM)
                break
            if time.time() > deadline:
                break
        assert saw_step, "the trainer never reached step 3"
        out = proc.stdout.read()
        rc = proc.wait(timeout=60)
        assert rc == 0, out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert "received signal 15" in out and "TRAIN_RETURNED" in out
    step = Checkpointer(str(tmp_path / "ck")).latest_step()
    assert step is not None and step >= 3
    cfg = load_config(str(tmp_path / "ck"))
    state = trainer.train(cfg, synthetic_data=True, max_steps=step + 2,
                          device="cpu")
    assert int(state["step"]) == step + 2


def test_handlers_are_restored_after_train(tmp_path):
    before = (signal.getsignal(signal.SIGTERM),
              signal.getsignal(signal.SIGINT))
    cfg = _cfg(TrainConfig, ModelConfig, tmp_path, tensorboard=False)
    trainer.train(cfg, synthetic_data=True, max_steps=1, device="cpu")
    assert (signal.getsignal(signal.SIGTERM),
            signal.getsignal(signal.SIGINT)) == before
