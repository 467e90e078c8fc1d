"""The port trainer's observability on the CPU: the scheduled and the
triggered torch.profiler windows digested into perf/device/*, the
startup breakdown and its row, --timing_window, the flight recorder's
startup_partial, the five flags' config.json parity with the JAX package,
and the device rows against the JAX trainer's. Tiny configs (16 px,
gf/df 8, batch 8), synthetic data."""

import dataclasses
import json
import os
import socket

import pytest
from torch_jax_draws import one_torch_thread  # noqa: F401

from dcgan_tpu import config as j_config
from dcgan_tpu.config import ModelConfig as JModelConfig
from dcgan_tpu.config import TrainConfig as JTrainConfig
from dcgan_tpu.train.trainer import train as j_train
from dcgan_tpu_torch import config
from dcgan_tpu_torch.config import ModelConfig, TrainConfig
from dcgan_tpu_torch.train import cli, flight_recorder, trainer
from dcgan_tpu_torch.utils import trace
from dcgan_tpu_torch.utils.checkpoint import Checkpointer

MODEL = dict(output_size=16, gf_dim=8, df_dim=8, compute_dtype="float32")
DEVICE_KEYS = {f"perf/device/{k}" for k in (
    "compute_ms", "collective_ms", "idle_gap_ms", "span_ms", "step_ms",
    "overlap_frac")}
PHASES = ("init", "restore", "data", "warmup")
FIVE = dict(profile_dir="/runs/tr", profile_start_step=3,
            profile_num_steps=7, profile_trigger="/runs/trigger",
            timing_window=9)


def _cfg(cls, mcls, root, **kw):
    base = dict(model=mcls(**MODEL), batch_size=8,
                checkpoint_dir=str(root / "ck"), sample_dir=str(root / "sm"),
                sample_every_steps=0, save_summaries_secs=0.0,
                save_model_secs=1e9, activation_summary_steps=0,
                tensorboard=False, log_every_steps=1)
    base.update(kw)
    return cls(**base)


def _rows(cfg):
    with open(os.path.join(cfg.checkpoint_dir, "events.jsonl")) as f:
        return [(e["step"], e["values"]) for e in map(json.loads, f)
                if e["kind"] == "scalars"]


def _device_rows(cfg):
    return [(s, v) for s, v in _rows(cfg) if "perf/device/step_ms" in v]


def _train(cfg, steps):
    return trainer.train(cfg, synthetic_data=True, max_steps=steps,
                         device="cpu")


def test_scheduled_window_writes_a_device_row(tmp_path, capsys):
    """profile_dir, start 1, 2 steps, 5 in all: one window opened at 1
    (its warm-up call), recording [2, 4), its trace named after the
    host, one perf/device row at step 4 with compute_ms > 0 and the step
    the busiest program's median."""
    cfg = _cfg(TrainConfig, ModelConfig, tmp_path,
               profile_dir=str(tmp_path / "tr"), profile_start_step=1,
               profile_num_steps=2)
    _train(cfg, 5)
    rows = _device_rows(cfg)
    assert [s for s, _ in rows] == [4]
    row = rows[0][1]
    assert DEVICE_KEYS <= set(row) and row["perf/device/compute_ms"] > 0
    path = trace.find_trace(str(tmp_path / "tr"), host=socket.gethostname())
    assert os.path.basename(path).startswith(socket.gethostname() + ".")
    d = trace.digest(path)
    assert (d["source"], d["program"], d["program_n"]) == \
        ("cpu", "train_step", 2)
    assert row["perf/device/step_ms"] == d["program_ms_median"]
    assert row["perf/device/compute_ms"] == d["compute_ms"]
    out = capsys.readouterr().out
    assert "trace digest (ending step 4, cpu track, top program " \
        "'train_step' x2)" in out


def test_trigger_is_consumed_and_digested_once(tmp_path, capsys):
    """A trigger touched before the run: a window at the first boundary
    (the eager first call its warm-up) recording 2 steps under
    checkpoint_dir/trace, the file consumed, one row."""
    trig = tmp_path / "trigger"
    trig.touch()
    cfg = _cfg(TrainConfig, ModelConfig, tmp_path,
               profile_trigger=str(trig), profile_num_steps=2)
    _train(cfg, 6)
    assert not trig.exists()
    rows = _device_rows(cfg)
    assert [s for s, _ in rows] == [3]
    assert rows[0][1]["perf/device/compute_ms"] > 0
    assert trace.find_trace(os.path.join(cfg.checkpoint_dir, "trace"))
    assert capsys.readouterr().out.count("trace digest") == 1


def test_window_over_a_first_call_and_k_calls(tmp_path):
    """A recorded window holds the sampler's eager first call (its
    warm-up) and its run under the row's name; a window over calls of
    K = 2 divides the busiest program's median by 2 (its warm-up call is
    one of them)."""
    cfg = _cfg(TrainConfig, ModelConfig, tmp_path,
               profile_dir=str(tmp_path / "tr"), profile_start_step=1,
               profile_num_steps=2, sample_every_steps=3,
               sample_grid=(2, 2), sample_size=4)
    _train(cfg, 4)
    d = trace.digest(trace.find_trace(str(tmp_path / "tr")))
    rows = {r["program"]: r["n"] for r in d["rows"]}
    assert rows == {"train_step": 2, "sampler": 2}
    k2 = dataclasses.replace(cfg, checkpoint_dir=str(tmp_path / "k2"),
                             profile_dir=str(tmp_path / "tr2"),
                             profile_start_step=2, profile_num_steps=4,
                             steps_per_call=2, sample_every_steps=0)
    _train(k2, 8)
    rows = _device_rows(k2)
    assert [s for s, _ in rows] == [8]
    d = trace.digest(trace.find_trace(str(tmp_path / "tr2")))
    assert (d["program"], d["program_n"]) == ("multi_step@k2", 2)
    assert rows[0][1]["perf/device/step_ms"] == d["program_ms_median"] / 2


def test_pipelined_window_sums_the_stages(tmp_path):
    cfg = _cfg(TrainConfig, ModelConfig, tmp_path, pipeline_gd=True,
               profile_dir=str(tmp_path / "tr"), profile_start_step=1,
               profile_num_steps=3)
    _train(cfg, 5)
    (_, row), = _device_rows(cfg)
    d = trace.digest(trace.find_trace(str(tmp_path / "tr")))
    stages = {r["program"]: r["ms_median"] for r in d["rows"]}
    assert {"d_update", "g_update"} <= set(stages)
    assert row["perf/device/step_ms"] == pytest.approx(
        stages["d_update"] + stages["g_update"])


def test_timing_window_bounds_the_window(tmp_path, monkeypatch):
    """--timing_window 3: every StepTimer the trainer builds holds the
    last 3 steps, and the logged max is the max of those."""
    made = []

    class Spy(trainer.StepTimer):
        def __init__(self, **kw):
            super().__init__(**kw)
            made.append(self)

    monkeypatch.setattr(trainer, "StepTimer", Spy)
    run = tmp_path / "run"
    cli.main(["--preset", "celeba64", "--synthetic", "--max_steps", "6",
              "--device", "cpu", "--output_size", "16", "--gf_dim", "8",
              "--df_dim", "8", "--z_dim", "8", "--batch_size", "4",
              "--checkpoint_dir", str(run), "--sample_dir",
              str(tmp_path / "sm"), "--sample_every_steps", "0",
              "--log_every_steps", "1", "--timing_window", "3",
              "--activation_summary_steps", "0"])
    assert made and all(t.window == 3 for t in made)
    timer = made[-1]
    assert len(timer) == 3
    cfg = config.load_config(str(run))
    assert cfg.timing_window == 3
    last = _rows(cfg)[-1][1]
    assert last["perf/step_ms_max"] == pytest.approx(
        1e3 * max(timer._durations))


def test_startup_row_under_aot_warmup_only(tmp_path, capsys):
    """The startup line is always printed; the perf/startup/* row is
    written under --aot_warmup, with total_ms at least the phases' sum,
    and a resumed run's row carries the restore's verify stats."""
    plain = _cfg(TrainConfig, ModelConfig, tmp_path / "plain")
    _train(plain, 2)
    assert not any(k.startswith("perf/startup/")
                   for _, v in _rows(plain) for k in v)
    assert "[dcgan_tpu_torch] startup {" in capsys.readouterr().out
    cfg = _cfg(TrainConfig, ModelConfig, tmp_path / "aot", aot_warmup=True)
    _train(cfg, 2)
    _train(cfg, 4)                    # resumed at step 2
    rows = [(s, v) for s, v in _rows(cfg) if "perf/startup/total_ms" in v]
    assert [s for s, _ in rows] == [1, 3]
    for _, v in rows:
        assert {f"perf/startup/{p}_ms" for p in PHASES} <= set(v)
        assert v["perf/startup/total_ms"] >= sum(
            v[f"perf/startup/{p}_ms"] for p in PHASES)
    assert "perf/restore/verify_files" not in rows[0][1]
    assert {"perf/restore/verify_files", "perf/restore/verify_bytes",
            "perf/restore/verify_cached_bytes",
            "perf/restore/verify_ms"} <= set(rows[1][1])
    assert rows[1][1]["perf/restore/verify_bytes"] > 0


def test_restore_failure_dumps_startup_partial(tmp_path, monkeypatch):
    """A run that dies in its restore: the flight recorder's dump carries
    the startup phases it got through, and no total."""
    cfg = _cfg(TrainConfig, ModelConfig, tmp_path)
    _train(cfg, 1)

    def broken(self, template):
        raise OSError("restore failed")

    monkeypatch.setattr(Checkpointer, "restore_latest", broken)
    with pytest.raises(OSError, match="restore failed"):
        _train(cfg, 3)
    header, _ = flight_recorder.read_dump(
        flight_recorder.recorder_path(cfg.checkpoint_dir))
    assert header["reason"] == "exception"
    partial = header["startup_partial"]
    assert {"perf/startup/data_ms", "perf/startup/init_ms",
            "perf/startup/restore_ms"} == set(partial)


def test_jax_config_with_the_five_fields_loads(tmp_path):
    """A JAX config.json that sets the five fields loads into the port's
    TrainConfig with the same values, and back."""
    jcfg = JTrainConfig(**FIVE)
    j_config.save_config(jcfg, str(tmp_path / "jax"))
    cfg = config.load_config(str(tmp_path / "jax"))
    for name, value in FIVE.items():
        assert getattr(cfg, name) == getattr(jcfg, name) == value
    assert {f.name for f in dataclasses.fields(TrainConfig)} >= set(FIVE)
    defaults = TrainConfig()
    for name in FIVE:
        assert getattr(defaults, name) == getattr(JTrainConfig(), name)
    config.save_config(cfg, str(tmp_path / "port"))
    assert j_config.load_config(str(tmp_path / "port")) == jcfg


def test_device_rows_match_the_jax_trainer(tmp_path):
    """The same window in both trainers (the port's warm-up call and 2
    recorded steps, JAX's 3 steps from the same boundary): one
    perf/device row at the same step with the same keys, each trainer's
    startup row (under aot_warmup) with the same perf/startup/* keys."""
    kw = dict(profile_start_step=1, aot_warmup=True)
    jcfg = _cfg(JTrainConfig, JModelConfig, tmp_path / "jax",
                profile_dir=str(tmp_path / "jax_tr"), profile_num_steps=3,
                **kw)
    tcfg = _cfg(TrainConfig, ModelConfig, tmp_path / "port",
                profile_dir=str(tmp_path / "port_tr"), profile_num_steps=2,
                **kw)
    j_train(jcfg, synthetic_data=True, max_steps=4)
    _train(tcfg, 4)
    jrows, trows = _device_rows(jcfg), _device_rows(tcfg)
    assert [s for s, _ in jrows] == [s for s, _ in trows] == [4]
    assert set(jrows[0][1]) == set(trows[0][1]) == DEVICE_KEYS

    def startup_keys(cfg):
        return {k for _, v in _rows(cfg) for k in v
                if k.startswith("perf/startup/")}
    assert startup_keys(jcfg) == startup_keys(tcfg) == {
        f"perf/startup/{p}_ms" for p in PHASES + ("total",)}
