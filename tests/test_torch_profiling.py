"""The port's profiling primitives (dcgan_tpu_torch/utils/profiling.py)
against the JAX package's (dcgan_tpu/utils/profiling.py): StepTimer's
stats equal on seeded tick sequences, StartupProfile's keys and rules,
and TraceCapture's state machine step for step on the same sequences of
steps, touches and consume flags. The JAX class runs with
jax.profiler.start_trace and stop_trace replaced by no-ops; the port's
runs torch.profiler on the CPU."""

import glob
import os
import time

import numpy as np
import pytest
from torch_jax_draws import one_torch_thread  # noqa: F401

import jax

from dcgan_tpu.utils import profiling as jprof
from dcgan_tpu_torch.utils import profiling


# ---------------------------------------------------------------------------
# StepTimer
# ---------------------------------------------------------------------------

def _timer_pair(window, images):
    kw = {} if window is None else {"window": window}
    return (profiling.StepTimer(images_per_step=images, **kw),
            jprof.StepTimer(images_per_step=images, **kw))


@pytest.mark.parametrize("window,seed", [(None, 0), (1, 1), (3, 2), (7, 3),
                                         (50, 4), (4, 5)])
def test_step_timer_equals_jax(window, seed):
    """Seeded ticks (1-4 steps a call) and note_host amounts: the same
    summary, last_step_ms, last_host_ms and length at every tick."""
    rng = np.random.default_rng(seed)
    images = None if seed % 2 else int(rng.integers(1, 128))
    port, ref = _timer_pair(window, images)
    now = float(rng.uniform(0, 10))
    for _ in range(40):
        for _ in range(int(rng.integers(0, 3))):
            host = float(rng.exponential(0.002))
            port.note_host(host)
            ref.note_host(host)
        steps = int(rng.integers(1, 5))
        now += float(rng.exponential(0.05)) * steps
        port.tick(now, steps=steps)
        ref.tick(now, steps=steps)
        assert port.summary() == ref.summary()
        assert port.summary("x/") == ref.summary("x/")
        assert (port.last_step_ms, port.last_host_ms, len(port)) == \
            (ref.last_step_ms, ref.last_host_ms, len(ref))
    assert port.window == ref.window


def test_step_timer_window_bounds_and_empty():
    t = profiling.StepTimer(window=3)
    assert t.summary() == {} and t.last_step_ms is None
    for now in (0.0, 1.0, 1.1, 1.2, 1.3):
        t.tick(now)
    assert len(t) == 3
    assert t.summary()["perf/step_ms_max"] == pytest.approx(100.0)


# ---------------------------------------------------------------------------
# StartupProfile
# ---------------------------------------------------------------------------

def test_startup_profile_keys_equal_jax():
    port, ref = profiling.StartupProfile(), jprof.StartupProfile()
    for prof in (port, ref):
        for name in ("data", "init", "restore", "data", "warmup"):
            with prof.phase(name):
                pass
        assert not prof.done
    assert sorted(port.summary()) == sorted(ref.summary()) == [
        f"perf/startup/{p}_ms" for p in ("data", "init", "restore",
                                         "warmup")]
    port.first_step()
    ref.first_step()
    assert sorted(port.summary()) == sorted(ref.summary())
    assert "perf/startup/total_ms" in port.summary() and port.done


def test_startup_profile_first_call_wins_and_total_covers_phases():
    prof = profiling.StartupProfile()
    with prof.phase("init"):
        time.sleep(0.01)
    with prof.phase("restore"):
        time.sleep(0.005)
    with prof.phase("init"):          # a phase accumulates
        time.sleep(0.005)
    prof.first_step()
    first = prof.summary()["perf/startup/total_ms"]
    time.sleep(0.01)
    prof.first_step()                 # later stamps are steady state
    s = prof.summary()
    assert s["perf/startup/total_ms"] == first
    assert s["perf/startup/init_ms"] >= 15.0
    assert s["perf/startup/total_ms"] >= s["perf/startup/init_ms"] \
        + s["perf/startup/restore_ms"]


def test_startup_phase_records_a_failing_phase():
    prof = profiling.StartupProfile()
    with pytest.raises(OSError):
        with prof.phase("restore"):
            raise OSError("disk")
    assert "perf/startup/restore_ms" in prof.summary()
    assert "perf/startup/total_ms" not in prof.summary()


# ---------------------------------------------------------------------------
# TraceCapture's state machine, step for step against the JAX class
# ---------------------------------------------------------------------------

@pytest.fixture
def jax_profiler_noop(monkeypatch):
    monkeypatch.setattr(jax.profiler, "start_trace", lambda *a, **k: None)
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda *a, **k: None)


class _Touch:
    """Touch (create or bump the mtime of) both implementations' trigger
    files to the same, strictly increasing mtime."""

    def __init__(self):
        self.ns = time.time_ns()

    def __call__(self, *paths):
        self.ns += 10_000_000
        for p in paths:
            with open(p, "a"):
                pass
            os.utime(p, ns=(self.ns, self.ns))


def _drive(tmp_path, kw, plan, steps, k=1, logdir=True, trigger=True):
    """Run both classes over `plan` ({step: [actions]}: "touch",
    "close") for calls of k steps from 0 to `steps`; the trace of
    (step, active, captures, trigger exists) after each start and stop,
    and the on_capture calls, for each. The port's window of N steps
    follows a warm-up call of k steps from the same boundary: the JAX
    class is given N + k."""
    touch = _Touch()
    runs = {}
    n = kw.get("num_steps", 5)
    for name, cls, extra in (("port", profiling.TraceCapture, 0),
                             ("jax", jprof.TraceCapture, k)):
        root = tmp_path / name
        root.mkdir()
        trig = str(root / "trigger") if trigger else ""
        runs[name] = {"tc": cls(str(root / "trace") if logdir else "",
                                trigger_path=trig, on_capture=None,
                                **dict(kw, num_steps=n + extra)),
                      "trig": trig, "calls": [], "log": []}
        runs[name]["tc"].on_capture = runs[name]["calls"].append
    for step in range(0, steps, k):
        for action in plan.get(step, ()):
            if action == "touch":
                touch(*[r["trig"] for r in runs.values()])
            elif action == "close":
                for r in runs.values():
                    r["tc"].close()
        for r in runs.values():
            tc = r["tc"]
            tc.maybe_start(step)
            r["log"].append((step, "start", tc.active, tc.captures,
                             bool(r["trig"]) and os.path.exists(r["trig"])))
            tc.maybe_stop(step + k)
            r["log"].append((step + k, "stop", tc.active, tc.captures,
                             bool(r["trig"]) and os.path.exists(r["trig"])))
    for r in runs.values():
        r["tc"].close()
    return runs


CASES = {
    # no logdir: inert, a stop never raises
    "disabled": (dict(start_step=0, num_steps=5), {}, 6, 1, False, False),
    # the scheduled window: opened at 2 (the warm-up call), recorded
    # [3, 5)
    "scheduled": (dict(start_step=2, num_steps=2), {}, 5, 1, True, False),
    # close stops an open window
    "close": (dict(start_step=0, num_steps=100), {3: ["close"]}, 5, 1,
              True, False),
    # a touch at 2 opens a window (recorded [3, 5)) and is consumed; a
    # second touch at 8 records [9, 11)
    "trigger": (dict(num_steps=2, schedule=False), {2: ["touch"],
                                                    8: ["touch"]}, 12, 1,
                True, True),
    # schedule=False never arms the scheduled window
    "trigger_only": (dict(start_step=0, num_steps=5, schedule=False), {},
                     8, 1, True, True),
    # a trigger without a logdir is inert and never consumed
    "trigger_no_logdir": (dict(), {0: ["touch"]}, 4, 1, False, True),
    # consume=False: captured by mtime, never deleted; the same mtime is
    # served once, a fresh touch re-arms
    "nonconsuming": (dict(num_steps=1, schedule=False, consume=False),
                     {0: ["touch"], 3: ["touch"]}, 6, 1, True, True),
    # a touch inside the scheduled window waits for its end; a touch
    # inside a triggered window is absorbed by the removal at its end
    "scheduled_then_trigger": (dict(start_step=1, num_steps=3),
                               {2: ["touch"], 6: ["touch"], 7: ["touch"]},
                               14, 1, True, True),
    # calls of 4 steps: the window closes at the first boundary past it
    "k4": (dict(start_step=3, num_steps=5), {12: ["touch"]}, 32, 4, True,
           True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_trace_capture_state_machine_equals_jax(tmp_path, jax_profiler_noop,
                                                case):
    kw, plan, steps, k, logdir, trigger = CASES[case]
    runs = _drive(tmp_path, kw, plan, steps, k, logdir, trigger)
    assert runs["port"]["log"] == runs["jax"]["log"]
    assert runs["port"]["calls"] == runs["jax"]["calls"]
    assert runs["port"]["tc"].captures == runs["jax"]["tc"].captures
    if case == "trigger":
        assert runs["port"]["calls"] == [5, 11]
    if case == "scheduled":
        assert runs["port"]["calls"] == [5]


def test_trace_capture_records_after_its_warmup_call(tmp_path):
    """A window's first call is dropped from its trace, the num_steps
    after it are written as `<host>.<n>.pt.trace.json.gz` with their
    record_function ranges; last_stop_ms is set."""
    import socket

    import torch

    from dcgan_tpu_torch.utils import trace

    tc = profiling.TraceCapture(str(tmp_path / "tr"), start_step=0,
                                num_steps=2)
    tc.maybe_start(0)
    assert tc.active and not tc.recording
    with torch.profiler.record_function("warm_up_call"):
        torch.ones(4).sum()
    tc.maybe_stop(1, sync=torch.ones(1))
    assert tc.recording and tc.captures == 0
    for step in (1, 2):
        tc.maybe_start(step)
        with torch.profiler.record_function("train_step"):
            torch.ones(4).sum()
        tc.maybe_stop(step + 1, sync=torch.ones(1))
    assert not tc.active and tc.captures == 1
    files = glob.glob(str(tmp_path / "tr" / "*.pt.trace.json.gz"))
    assert len(files) == 1
    assert os.path.basename(files[0]).startswith(socket.gethostname() + ".")
    assert tc.last_stop_ms is not None and tc.last_stop_ms > 0
    rows = {r["program"]: r["n"] for r in trace.summarize(files[0])[0]}
    assert rows == {"train_step": 2}


def test_trace_capture_close_during_warmup_writes_a_trace(tmp_path):
    tc = profiling.TraceCapture(str(tmp_path / "tr"), start_step=0,
                                num_steps=3)
    tc.maybe_start(0)
    tc.close()
    assert not tc.active and tc.captures == 0
    assert len(glob.glob(str(tmp_path / "tr" / "*.pt.trace.json.gz"))) == 1
