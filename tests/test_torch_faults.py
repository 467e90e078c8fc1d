"""The port's fault-tolerance modules against the JAX package's, on the CPU:
the chaos plan (`testing/chaos.py`), the retry hook, the rollback
manager, the flight recorder, the host services and the watchdog. Same
calls on the same numpy-built inputs in both packages; every difference
allowed is named where it is allowed (the counters, the config fields and
the LR backoff: tests/test_torch_faults_config.py)."""

import dataclasses
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from dcgan_tpu.testing import chaos as j_chaos
from dcgan_tpu.train import flight_recorder as j_flight
from dcgan_tpu.train import rollback as j_rollback
from dcgan_tpu.train import services as j_services
from dcgan_tpu_torch.testing import chaos
from dcgan_tpu_torch.train import coordination, flight_recorder, rollback, \
    services, steps
from dcgan_tpu_torch.utils import metrics
from dcgan_tpu_torch.utils.retry import retry_io
from torch_jax_draws import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def no_plan():
    """Every test starts and ends with no plan armed in either package."""
    chaos.reset()
    j_chaos.reset()
    yield
    chaos.reset()
    j_chaos.reset()


# -- the chaos plan -----------------------------------------------------------

@pytest.mark.parametrize("raw,pid", [
    ('{"nan_at_step": 3}', "0"),
    ('{"io_error_once": "ckpt-manifest", "services_worker_crash": 2}', "0"),
    ('{"hang_at_step": 3, "hang_secs": 60}', "0"),
    ('{"fault_replica": 1, "replica_kill_at_dispatch": 2, '
     '"replica_slow_beat_at_dispatch": 4, "slow_beat_secs": 0.5}', "0"),
    ('{"0": {"nan_at_step": 2}, "1": {"sigterm_at_step": 4}}', "1"),
    ('{"1": {"nan_at_step": 2}}', "0")])
def test_chaos_plan_parses_equal_in_both_packages(raw, pid):
    env = {"DCGAN_CHAOS": raw, "MH_PID": pid}
    got, want = chaos.plan_from_env(env), j_chaos.plan_from_env(env)
    if want is None:
        assert got is None
        return
    fields = [f.name for f in dataclasses.fields(j_chaos.FaultPlan)]
    assert [f.name for f in dataclasses.fields(chaos.FaultPlan)] == fields
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_chaos_unknown_field_raises_in_both():
    env = {"DCGAN_CHAOS": '{"nan_at_stp": 3}'}
    with pytest.raises(ValueError, match="unknown DCGAN_CHAOS") as e:
        chaos.plan_from_env(env)
    with pytest.raises(ValueError, match="unknown DCGAN_CHAOS") as je:
        j_chaos.plan_from_env(env)
    assert str(e.value) == str(je.value)


def test_chaos_hooks_fire_once_as_in_jax():
    """The same calls on the same plan give the same answers in both
    packages: each armed fault fires exactly once."""
    def calls(mod):
        mod.set_plan(mod.FaultPlan(nan_at_step=3, services_worker_crash=2,
                                   fault_replica=1,
                                   replica_kill_at_dispatch=2,
                                   replica_slow_beat_at_dispatch=1,
                                   slow_beat_secs=0.25,
                                   io_error_once="services"))
        out = [mod.should_inject_nan(s) for s in (2, 3, 3, 4)]
        out += [mod.should_crash_worker(n) for n in (1, 2, 3)]
        out += [mod.should_kill_replica(r, n)
                for r, n in ((0, 2), (1, 1), (1, 2), (1, 3))]
        out += [mod.maybe_replica_slow_beat(1, n) for n in (1, 2)]
        for tag in ("ckpt-manifest", "services", "services"):
            try:
                mod.maybe_io_error(tag)
                out.append("ok")
            except OSError:
                out.append("err")
        mod.maybe_hang(3)   # unarmed: returns at once
        mod.reset()
        out.append(mod.should_inject_nan(3))  # no plan after reset
        return out

    assert calls(chaos) == calls(j_chaos)


def test_disk_helpers_write_the_same_bytes(tmp_path):
    from dcgan_tpu_torch.data.synthetic import write_image_tfrecords

    shard = write_image_tfrecords(str(tmp_path / "d"), num_examples=6,
                                  image_size=4, num_shards=1)[0]
    blob = open(shard, "rb").read()
    for name, mod in (("port", chaos), ("jax", j_chaos)):
        path = tmp_path / f"{name}.tfrecord"
        path.write_bytes(blob)
        off = mod.corrupt_tfrecord_payload(str(path), record_index=2)
        size = mod.truncate_file(str(path), drop_bytes=16)
        (tmp_path / f"{name}.out").write_text(f"{off} {size}")
    assert (tmp_path / "port.tfrecord").read_bytes() == \
        (tmp_path / "jax.tfrecord").read_bytes()
    assert (tmp_path / "port.out").read_text() == \
        (tmp_path / "jax.out").read_text()


def test_retry_io_consults_the_chaos_hook(capsys):
    chaos.set_plan(chaos.FaultPlan(io_error_once="ckpt-manifest"))
    calls = []
    assert retry_io(lambda: calls.append(1) or "done", tag="ckpt-manifest",
                    sleep=lambda s: None) == "done"
    assert calls == [1]   # the injected failure ran before fn
    assert "transient IO error at 'ckpt-manifest'" in capsys.readouterr().out
    with pytest.raises(OSError):
        chaos.set_plan(chaos.FaultPlan(io_error_once="x"))
        retry_io(lambda: None, tag="x", attempts=1)


# -- the rollback manager -----------------------------------------------------

def _tree(rng):
    return {"params": {"w": rng.standard_normal((3, 2)).astype(np.float32),
                       "b": rng.standard_normal(2).astype(np.float32)},
            "step": np.asarray(4, np.int32)}


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def test_rollback_manager_equals_jax():
    """Snapshot, restore, the budget, lr_scale and the on_restore order:
    the port's manager (device copies in place) and the JAX manager (host
    copies) give the same answers for the same calls, and a restore gives
    back the snapshot bit for bit although the live state moved on."""
    rng = np.random.default_rng(0)
    a, b = _tree(rng), _tree(rng)
    jm = j_rollback.RollbackManager(every=2, max_rollbacks=2,
                                    lr_backoff=0.5, chief=False)
    tm = rollback.RollbackManager(every=2, max_rollbacks=2, lr_backoff=0.5,
                                  chief=False)
    order = {"jax": [], "port": []}
    jm.on_restore = lambda: order["jax"].append("drain")
    tm.on_restore = lambda: order["port"].append("drain")
    err = FloatingPointError("non-finite training metrics at step 5")
    for m in (jm, tm):
        with pytest.raises(FloatingPointError) as e:
            m.restore(err)          # nothing armed: the gate's own error
        assert e.value is err
    assert [jm.due(s) for s in range(6)] == [tm.due(s) for s in range(6)]
    live = _torch_tree(a)
    jm.snapshot(4, a)
    tm.snapshot(4, live)
    assert jm.snapshot_step == tm.snapshot_step == 4
    with torch.no_grad():         # the live state diverges in place
        live["params"]["w"].fill_(float("nan"))
    jstate, jstep = jm.restore(err)
    tstate, tstep = tm.restore(err, into=live)
    assert tstate is live and jstep == tstep == 4
    for got, want in zip(steps.tree_leaves(_np(tstate)),
                         steps.tree_leaves(_np(jstate))):
        np.testing.assert_array_equal(got, want)
    assert order["port"] == order["jax"] == ["drain"]
    assert jm.lr_scale() == tm.lr_scale() == 0.5
    # a second snapshot and a second restore into fresh tensors
    jm.snapshot(6, b)
    tm.snapshot(6, _torch_tree(b))
    jstate, jstep = jm.restore(err)
    tstate, tstep = tm.restore(err)
    assert jstep == tstep == 6 and jm.rollbacks == tm.rollbacks == 2
    np.testing.assert_array_equal(tstate["params"]["b"].numpy(),
                                  jstate["params"]["b"])
    assert jm.lr_scale() == tm.lr_scale() == 0.25
    # past the budget: exhausted, from the gate's error, and no drain
    with pytest.raises(j_rollback.RollbackExhausted) as je:
        jm.restore(err)
    with pytest.raises(rollback.RollbackExhausted) as te:
        tm.restore(err)
    assert te.value.__cause__ is err and je.value.__cause__ is err
    assert str(te.value) == str(je.value)
    assert isinstance(te.value, FloatingPointError)
    assert order["port"] == order["jax"] == ["drain", "drain"]


def test_rollback_snapshot_reallocates_for_a_new_tree():
    """A progressive switch hands the manager another tree: the snapshot
    takes the new layout, and restores it."""
    m = rollback.RollbackManager(every=1, max_rollbacks=1, chief=False)
    m.snapshot(1, {"w": torch.ones(2)})
    m.snapshot(3, {"w": torch.full((4,), 2.0), "v": torch.zeros(1)})
    state, step = m.restore(FloatingPointError("x"))
    assert step == 3 and state["w"].tolist() == [2.0] * 4


# -- the flight recorder ------------------------------------------------------

def test_flight_recorder_dumps_equal_jax(tmp_path):
    """Equal records give equal dumps (header and records), but for the
    header's wall-clock `time`; the ring keeps the last `capacity`."""
    recs = [{"step": s, "time": 100.0 + s, "gate": "ok" if s % 2 else "",
             "step_ms": 1.5 * s, "host_ms": 0.25, "metrics": {
                 "d_loss": 1.0 / s}, "counters": metrics.CounterSnapshot(
                     rollbacks=s // 3).as_dict()} for s in range(1, 6)]
    paths = {}
    for name, mod in (("port", flight_recorder), ("jax", j_flight)):
        fr = mod.FlightRecorder(str(tmp_path / name / "fr.jsonl"),
                                capacity=3,
                                context=lambda: {"process": 0})
        for r in recs:
            fr.record(r)
        paths[name] = fr.dump("nan-abort", step=5,
                              extra={"error": "FloatingPointError()"})
        assert fr.dumps == 1 and len(fr) == 3
    th, tr = flight_recorder.read_dump(paths["port"])
    jh, jr = j_flight.read_dump(paths["jax"])
    th.pop("time")
    jh.pop("time")
    assert th == jh and tr == jr and [r["step"] for r in tr] == [3, 4, 5]
    assert os.path.basename(flight_recorder.recorder_path(str(tmp_path))) \
        == os.path.basename(j_flight.recorder_path(str(tmp_path)))


def test_flight_recorder_off_and_failing_dump(tmp_path):
    off = flight_recorder.FlightRecorder(str(tmp_path / "a.jsonl"),
                                         capacity=0)
    off.record({"step": 1})
    assert off.dump("exception") is None and not off.enabled
    blocker = tmp_path / "file"
    blocker.write_text("")
    bad = flight_recorder.FlightRecorder(str(blocker / "x.jsonl"),
                                         capacity=2)
    bad.record({"step": 1})
    assert bad.dump("exception") is None and bad.dumps == 0
    with pytest.raises(ValueError, match="not a flight-recorder dump"):
        (tmp_path / "b.jsonl").write_text('{"kind": "scalars"}\n')
        flight_recorder.read_dump(str(tmp_path / "b.jsonl"))


# -- host services ------------------------------------------------------------

def _drop_run(mod):
    """A blocked worker, max_queue 3, six droppable tasks and one that is
    not: what ran, in which order, and the counters."""
    gate = threading.Event()
    ran = []
    svc = mod.HostServices(max_queue=3)
    svc.submit(lambda: (gate.wait(5), ran.append("first")), tag="first")
    while svc.pending() != 1 or len(svc._queue):
        time.sleep(0.001)   # the worker holds the first task
    for i in range(6):
        svc.submit(lambda i=i: ran.append(i), tag=f"t{i}")
    svc.submit(lambda: ran.append("keep"), tag="keep", droppable=False)
    pending = svc.pending()
    gate.set()
    svc.close()
    return ran, svc.dropped, svc.completed, pending


def test_services_drop_oldest_equals_jax():
    assert _drop_run(services) == _drop_run(j_services)


def test_services_worker_failure_surfaces_on_the_caller():
    for svc in (services.HostServices(), services.InlineServices()):
        def boom():
            raise OSError("disk gone")
        if isinstance(svc, services.InlineServices):
            with pytest.raises(OSError):
                svc.submit(boom)
            continue
        chaos.set_plan(chaos.FaultPlan(services_worker_crash=2))
        svc.submit(lambda: None, tag="a")
        svc.submit(lambda: None, tag="b")
        with pytest.raises(services.ServiceError, match="'b'"):
            svc.drain(timeout=5)
        assert not svc.submit(lambda: None)   # stopped after a failure
        with pytest.raises(services.ServiceError):
            svc.close()


def test_stage_copies_before_the_buffer_moves_on():
    """The host copy is taken at `stage`: writing the tensor afterwards
    (the next replay over a static output) does not reach the task."""
    buf = {"x": torch.arange(4.0), "n": 3, "d": {"y": torch.ones(2)}}
    staged = services.stage(buf)
    buf["x"].fill_(-1.0)
    buf["d"]["y"].zero_()
    got = staged.get()
    assert got["x"].tolist() == [0.0, 1.0, 2.0, 3.0]
    assert got["d"]["y"].tolist() == [1.0, 1.0] and got["n"] == 3


# -- the watchdog -------------------------------------------------------------

def test_watchdog_on_trip_and_pre_dump_order():
    events = []
    wd = coordination.make_watchdog(
        0.2, poll_interval=0.02,
        pre_dump=lambda phase, step: events.append(("dump", phase, step)),
        on_trip=lambda phase, step: events.append(("trip", phase, step)))
    try:
        with wd.guard("step-dispatch", 7):
            deadline = time.monotonic() + 5
            while not events and time.monotonic() < deadline:
                time.sleep(0.02)
        assert events[:2] == [("dump", "step-dispatch", 7),
                              ("trip", "step-dispatch", 7)]
    finally:
        wd.close()
    null = coordination.make_watchdog(0.0)
    with null.guard("x", 1) as g:
        assert g is coordination.NULL_GUARD
    null.close()


def test_watchdog_nested_guard_restores_the_outer_arm():
    wd = coordination.make_watchdog(30.0, on_trip=lambda p, s: None)
    try:
        with wd.guard("rollback-restore", 4):
            outer = wd._deadline
            with wd.guard("pipeline-drain", 4):
                assert wd._phase == "pipeline-drain"
            assert (wd._phase, wd._step) == ("rollback-restore", 4)
            assert wd._deadline == outer
        assert wd._deadline is None
    finally:
        wd.close()
    assert coordination.WATCHDOG_EXIT_CODE == 43


def test_watchdog_trip_exits_43_with_stacks():
    code = ("import time\n"
            "from dcgan_tpu_torch.train.coordination import make_watchdog\n"
            "wd = make_watchdog(0.5)\n"
            "with wd.guard('step-dispatch', 3):\n"
            "    time.sleep(20)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 43, out.stderr
    assert "hung-collective watchdog" in out.stderr
    assert "phase 'step-dispatch' at step 3" in out.stderr
    assert "Thread 0x" in out.stderr   # faulthandler's stacks
