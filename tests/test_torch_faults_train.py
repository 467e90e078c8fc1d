"""The port trainer's fault tolerance end to end, on the CPU, against the
JAX trainer's (`dcgan_tpu/train/trainer.py:1140-1346`): the NaN abort's
flight-recorder dump, the rollback, the runner's in-place restore, the
async and inline services, the event-key inventory, the serve worker's
replica fault, and the port drill's smoke set. Tiny configs (16 px,
gf/df 8, batch 8), synthetic data."""

import json
import os
import subprocess
import sys

import pytest
import torch

from dcgan_tpu.config import ModelConfig as JModelConfig
from dcgan_tpu.config import TrainConfig as JTrainConfig
from dcgan_tpu.testing import chaos as j_chaos
from dcgan_tpu.train import event_keys as j_event_keys
from dcgan_tpu.train import flight_recorder as j_flight
from dcgan_tpu.train.trainer import train as j_train
from dcgan_tpu_torch.config import ModelConfig, TrainConfig
from dcgan_tpu_torch.testing import chaos
from dcgan_tpu_torch.train import event_keys, flight_recorder, rollback, \
    trainer
from dcgan_tpu_torch.train.steps import make_train_step, tree_leaves
from dcgan_tpu_torch.train.warmup import StepRunner
from torch_jax_draws import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(output_size=16, gf_dim=8, df_dim=8, compute_dtype="float32")


@pytest.fixture(autouse=True)
def no_plan():
    chaos.reset()
    j_chaos.reset()
    yield
    chaos.reset()
    j_chaos.reset()


def _cfg(cls, mcls, root, **kw):
    base = dict(model=mcls(**MODEL), batch_size=8,
                checkpoint_dir=str(root / "ck"), sample_dir=str(root / "sm"),
                sample_every_steps=0, save_summaries_secs=0.0,
                save_model_secs=1e9, activation_summary_steps=0,
                tensorboard=False, log_every_steps=1)
    base.update(kw)
    return cls(**base)


def _events(cfg):
    with open(os.path.join(cfg.checkpoint_dir, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def _comparable(events):
    """The events without the wall-clock fields: each event's `time` and
    the StepTimer's `perf/*` step times."""
    out = []
    for e in events:
        e = {k: v for k, v in e.items() if k not in ("time", "wall_time")}
        if "values" in e and isinstance(e["values"], dict):
            e["values"] = {k: v for k, v in e["values"].items()
                           if not k.startswith("perf/step_ms")
                           and k not in ("perf/steps_per_sec",
                                         "perf/images_per_sec",
                                         "perf/host_ms_mean",
                                         "perf/dispatch_occupancy")}
        out.append(e)
    return out


def _normalized(cfg, root) -> str:
    """The comparable events as JSON, the run's directory named "D"."""
    return json.dumps(_comparable(_events(cfg))).replace(str(root), "D")


def _covered(key: str) -> bool:
    """`key` is in the port's EVENT_KEYS, by name or by a `prefix/*`."""
    return key in event_keys.EVENT_KEYS or any(
        k.endswith("/*") and key.startswith(k[:-1])
        for k in event_keys.EVENT_KEYS)


def _rollback_rows(events):
    return [(e["step"], e["values"]["anomaly/rollbacks"]) for e in events
            if e["kind"] == "scalars" and "anomaly/rollbacks" in e["values"]]


def test_nan_abort_dump_matches_jax(tmp_path):
    """NaN at step 3 under the abort policy: both trainers raise at step 3
    and dump a ring with the same header keys and record keys, the same
    count, and the failing step last with a tripped gate."""
    kw = dict(nan_check_steps=1)
    jcfg = _cfg(JTrainConfig, JModelConfig, tmp_path / "jax", **kw)
    tcfg = _cfg(TrainConfig, ModelConfig, tmp_path / "port", **kw)
    j_chaos.set_plan(j_chaos.FaultPlan(nan_at_step=3))
    with pytest.raises(FloatingPointError, match="at step 3"):
        j_train(jcfg, synthetic_data=True, max_steps=6)
    chaos.set_plan(chaos.FaultPlan(nan_at_step=3))
    with pytest.raises(FloatingPointError, match="at step 3"):
        trainer.train(tcfg, synthetic_data=True, max_steps=6, device="cpu")
    jh, jr = j_flight.read_dump(j_flight.recorder_path(jcfg.checkpoint_dir))
    th, tr = flight_recorder.read_dump(
        flight_recorder.recorder_path(tcfg.checkpoint_dir))
    assert set(th) == set(jh)
    assert (th["reason"], th["step"], th["records"]) == \
        (jh["reason"], jh["step"], jh["records"]) == ("nan-abort", 3, 3)
    assert [set(r) for r in tr] == [set(r) for r in jr]
    assert [(r["step"], r["gate"]) for r in tr] == \
        [(r["step"], r["gate"]) for r in jr] == [(1, "ok"), (2, "ok"),
                                                 (3, "trip")]
    assert set(tr[-1]["counters"]) == set(jr[-1]["counters"])
    assert set(tr[-1]["metrics"]) == set(jr[-1]["metrics"])


def test_rollback_matches_jax(tmp_path):
    """NaN at step 4 on a gate every 2 steps, snapshots every 2, a save
    every step: both trainers restore step 2, drop the step-3 checkpoint
    saved inside the poisoned window, write anomaly/rollbacks at the same
    steps and finish at step 4. The port reads each call's metrics back at
    once, which is the JAX trainer's inline consumption, so the JAX run
    takes async_services=False (with its lag-by-one it saves step 4
    before the gate sees it, and drops it as well)."""
    kw = dict(nan_policy="rollback", nan_check_steps=2,
              rollback_snapshot_steps=2, max_rollbacks=2,
              rollback_lr_backoff=0.5, save_model_secs=0.0,
              max_checkpoints=10)
    jcfg = _cfg(JTrainConfig, JModelConfig, tmp_path / "jax",
                async_services=False, **kw)
    tcfg = _cfg(TrainConfig, ModelConfig, tmp_path / "port", **kw)
    j_chaos.set_plan(j_chaos.FaultPlan(nan_at_step=4))
    jstate = j_train(jcfg, synthetic_data=True, max_steps=4)
    chaos.set_plan(chaos.FaultPlan(nan_at_step=4))
    tstate = trainer.train(tcfg, synthetic_data=True, max_steps=4,
                           device="cpu")
    assert int(tstate["step"]) == int(jstate["step"]) == 4
    assert _rollback_rows(_events(tcfg)) == _rollback_rows(_events(jcfg))
    assert _rollback_rows(_events(tcfg))[0] == (4, 1.0)

    def steps_on_disk(d):
        return sorted(int(n) for n in os.listdir(d) if n.isdigit())
    assert steps_on_disk(tcfg.checkpoint_dir) == \
        steps_on_disk(jcfg.checkpoint_dir) == [1, 2, 3, 4]


def test_rollback_drops_the_saves_of_the_poisoned_window(tmp_path, capsys,
                                                        monkeypatch):
    """steps_per_call 2, the gate every 4 steps, a save every call: the
    NaN at step 4 (inside a call) restores the step-0 snapshot and drops
    the step-1 and step-2 checkpoints; a real divergence at step 8 spends
    the budget of one: the run raises RollbackExhausted from the gate's
    error and dumps its ring."""
    cfg = _cfg(TrainConfig, ModelConfig, tmp_path, steps_per_call=2,
               nan_policy="rollback", nan_check_steps=4,
               rollback_snapshot_steps=4, max_rollbacks=1,
               save_model_secs=0.0)
    chaos.set_plan(chaos.FaultPlan(nan_at_step=4))
    poisoned = []
    real_step = trainer.StepRunner.step

    def step(self, images, *a, start=None, **k):
        out = real_step(self, images, *a, start=start, **k)
        if start == 6:   # the replay's second window diverges for real
            poisoned.append(start)
            out = out.clone()
            out[-1, 0] = float("nan")
        return out
    monkeypatch.setattr(trainer.StepRunner, "step", step)
    with pytest.raises(rollback.RollbackExhausted) as e:
        trainer.train(cfg, synthetic_data=True, max_steps=10, device="cpu")
    out = capsys.readouterr().out
    assert "rolling back to last-good snapshot at step 0" in out
    assert "dropped checkpoint step(s) [2, 1]" in out
    assert isinstance(e.value.__cause__, FloatingPointError)
    assert e.value.__cause__.step == 8 and poisoned == [6]
    header, records = flight_recorder.read_dump(
        flight_recorder.recorder_path(cfg.checkpoint_dir))
    assert header["reason"] == "nan-abort"
    assert records[-1]["step"] == 8 and records[-1]["gate"] == "trip"
    assert records[-1]["counters"]["rollbacks"] == 1


def test_runner_restore_replays_the_step_from_the_snapshot():
    """The runner's restore copies the snapshot into the static state in
    place: the next call equals the eager step from the snapshot on the
    same inputs bit for bit, captures nothing, and the LR backoff's cells
    move the rates without a capture."""
    cfg = TrainConfig(model=ModelConfig(**MODEL), batch_size=4,
                      nan_policy="rollback", rollback_lr_backoff=0.5)
    fns = make_train_step(cfg)
    state = fns.init(seed=0, device="cpu")
    runner = StepRunner(fns, state, cfg, torch.device("cpu"))
    gen = torch.Generator().manual_seed(1)
    images = [torch.rand((4, 16, 16, 3), generator=gen) * 2 - 1
              for _ in range(3)]
    zs = [torch.rand((4, 100), generator=gen) * 2 - 1 for _ in range(3)]
    runner.step([images[0]], [zs[0]], start=0)      # the warm-up
    runner.step([images[1]], [zs[1]], start=1)
    manager = rollback.RollbackManager(every=2, max_rollbacks=2,
                                       lr_backoff=0.5, chief=False)
    manager.snapshot(2, runner.state)
    snap = [t.clone() for t in tree_leaves(runner.state)]
    runner.step([images[2]], [zs[2]], start=2)
    captures = runner.captures
    assert runner.ready(1, 3)
    assert runner.restore(manager, FloatingPointError("x")) == 2
    for i, t in enumerate(tree_leaves(runner.state)):
        assert torch.equal(t, snap[i])
    replay = runner.step([images[2]], [zs[2]], start=2).clone()
    manager.restore(FloatingPointError("y"), into=runner.state)
    _, m = fns.train_step(runner.state, images[2], zs[2])
    assert torch.equal(replay[0], torch.stack(
        [m[k] for k in ("d_loss", "d_loss_real", "d_loss_fake",
                        "g_loss")]))
    runner.set_lr_scale(0.25)
    assert fns.lr_backoff.cell("gen", torch.device("cpu")).item() == \
        torch.tensor(2e-4 * 0.25, dtype=torch.float32).item()
    runner.step([images[2]], [zs[2]], start=2)
    assert runner.captures == captures
    runner.close()


def test_rollback_armed_without_a_fault_writes_the_default_run(tmp_path):
    """Rollback armed (with the LR backoff's rate cells) and never
    tripped: the events and the final state are the default run's, bit
    for bit, but for the wall-clock fields."""
    kw = dict(nan_check_steps=1, sample_every_steps=3,
              activation_summary_steps=3)
    plain = _cfg(TrainConfig, ModelConfig, tmp_path / "a", **kw)
    armed = _cfg(TrainConfig, ModelConfig, tmp_path / "b",
                 nan_policy="rollback", rollback_snapshot_steps=2,
                 rollback_lr_backoff=0.5, **kw)
    s1 = trainer.train(plain, synthetic_data=True, max_steps=6,
                       device="cpu")
    s2 = trainer.train(armed, synthetic_data=True, max_steps=6,
                       device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(s1),
                                                 tree_leaves(s2)))
    assert _normalized(plain, tmp_path / "a") == \
        _normalized(armed, tmp_path / "b")


def test_async_and_inline_services_write_the_same_jsonl(tmp_path):
    """The same run with the services on their worker and inline: the
    same JSONL (grids, the loss probe, activations, scalars) but for the
    wall-clock fields, and the same grid PNGs."""
    kw = dict(nan_check_steps=1, sample_every_steps=2,
              activation_summary_steps=2, sample_grid=(2, 2),
              sample_size=4, steps_per_call=2)
    a = _cfg(TrainConfig, ModelConfig, tmp_path / "a", **kw)
    b = _cfg(TrainConfig, ModelConfig, tmp_path / "b",
             async_services=False, **kw)
    trainer.train(a, synthetic_data=True, max_steps=6, device="cpu")
    trainer.train(b, synthetic_data=True, max_steps=6, device="cpu")
    assert _normalized(a, tmp_path / "a") == _normalized(b, tmp_path / "b")
    kinds = {e["kind"] for e in _events(a)}
    assert {"scalars", "image", "activations"} <= kinds
    grids = sorted(os.listdir(a.sample_dir))
    assert grids == sorted(os.listdir(b.sample_dir)) and grids
    for g in grids:
        assert (tmp_path / "a" / "sm" / g).read_bytes() == \
            (tmp_path / "b" / "sm" / g).read_bytes()


def test_emitted_keys_are_in_the_inventory_with_the_jax_gates(tmp_path):
    """Every namespaced key a port run writes is in its EVENT_KEYS, and a
    key both inventories list has the same gate in both."""
    for key, gate in event_keys.EVENT_KEYS.items():
        if key in j_event_keys.EVENT_KEYS:
            assert j_event_keys.EVENT_KEYS[key] == gate, key
    cfg = _cfg(TrainConfig, ModelConfig, tmp_path, nan_check_steps=1,
               nan_policy="rollback", rollback_snapshot_steps=2,
               sample_every_steps=2, precision="f32", aot_warmup=True,
               sample_grid=(2, 2), sample_size=4)
    chaos.set_plan(chaos.FaultPlan(nan_at_step=3))
    trainer.train(cfg, synthetic_data=True, max_steps=4, device="cpu")
    keys = {k for e in _events(cfg) if e["kind"] == "scalars"
            for k in e["values"] if "/" in k}
    assert {"anomaly/rollbacks", "perf/precision/policy",
            "sample/d_loss"} <= keys
    assert any(k.startswith("perf/compile_ms/") for k in keys)
    missing = sorted(k for k in keys if not _covered(k))
    assert not missing, missing


def test_serve_worker_replica_kill(tmp_path):
    """The chaos plan's replica kill at the second dispatch: the first
    request is served, the second fails with the chaos error and the
    replica is poisoned."""
    from dcgan_tpu_torch import convert
    from dcgan_tpu_torch.models.dcgan import generator_init
    from dcgan_tpu_torch.serve.server import SamplerServer
    from dcgan_tpu_torch.serve.sources import WeightsSource

    mcfg = ModelConfig(output_size=8, gf_dim=4)
    p, s = generator_init(mcfg, device="cpu")
    path = convert.save_weights(str(tmp_path / "g.npz"), mcfg, p, s)
    chaos.set_plan(chaos.FaultPlan(fault_replica=0,
                                   replica_kill_at_dispatch=2))
    server = SamplerServer(WeightsSource(path, device="cpu"), max_batch=2,
                           max_wait_ms=1.0)
    server.start(timeout=60)
    try:
        assert server.submit(1).result(timeout=60).shape[0] == 1
        with pytest.raises(Exception, match="chaos: replica 0 killed"):
            server.submit(1).result(timeout=60)
    finally:
        with pytest.raises(Exception):
            server.stop(drain=False, timeout=30)


def test_port_drill_smoke_on_the_cpu():
    """tools/chaos_drill_torch.py --cpu --smoke: corrupt-record
    quarantine, the manifest write's retry and the services worker's
    crash, each through a real trainer subprocess."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("DCGAN_CHAOS", None)
    res = subprocess.run(
        [sys.executable, "tools/chaos_drill_torch.py", "--cpu", "--smoke"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    rows = [json.loads(line) for line in res.stdout.splitlines()
            if line.startswith("{")]
    assert res.returncode == 0, res.stdout + res.stderr[-2000:]
    assert [r["scenario"] for r in rows[:-1]] == \
        ["corrupt-record", "io-error-once", "services-crash"]
    assert all(r["ok"] for r in rows[:-1]) and rows[-1]["failed"] == 0
