"""Chaos drill of the PyTorch port: the one-process fault scenarios of
`tools/chaos_drill.py`, each against the port's trainer or server.

Each scenario arms one deterministic fault (dcgan_tpu_torch/testing/
chaos.py, handed to each subprocess as the `DCGAN_CHAOS` environment
variable, or applied to the bytes on disk between launches), runs
`dcgan_tpu_torch.train` or `python -m dcgan_tpu_torch.serve` in a
subprocess, and checks the recovery contract of the JAX drill: the run
completes with the right final step and recovery counters, or it fails
loudly with the right error; it never trains on garbage and never hangs.

    scenario              fault                          recovery checked
    --------------------  -----------------------------  --------------------
    nan-rollback          NaN into the gate at step 3    rollback to the step-2
                                                         snapshot, run
                                                         completes, anomaly/
                                                         rollbacks written
    corrupt-record        a payload byte flipped in      record quarantined,
                          each shard (within budget)     data/corrupt_records
                                                         counted, completes
    corrupt-budget        the same, budget 1             fails naming the
                                                         budget
    truncate-checkpoint   newest checkpoint truncated    falls back to the
                          between two runs               step before, marks
                                                         it .corrupt, resumes
    io-error-once         one OSError in the manifest    retried, completes
                          write
    services-crash        the services worker dies       ServiceError on the
                                                         dispatch thread
    flight-recorder       NaN under the abort policy     dump written, its
                                                         last record the
                                                         failing step
    watchdog-dump         a hang inside the guarded      exit 43, stacks and
                          dispatch window                a dump naming the
                                                         phase
    pipeline-rollback     NaN under --pipeline_gd        rollback drains the
                                                         fake stack, replay
                                                         bit for bit
    progressive-switch    NaN right after a phase        restores the post-
                          switch                         switch snapshot;
                                                         replay and the
                                                         pre-switch losses
                                                         bit for bit
    trace-trigger         the --profile_trigger file     a 2-step window,
                          touched before the run         the file consumed,
                                                         a `trace digest`
                                                         line and a
                                                         perf/device/* row
                                                         with compute_ms > 0
    serve-drain           SIGTERM mid-load to the        every submitted
                          server                         request completes,
                                                         clean exit 0
    fleet-replica-kill    replica 1 of 3 killed          0 failed requests,
                          mid-trace, then a new step     survivors promoted,
                          lands on disk                  0 captures

The JAX drill's `zero-rollback` and `elastic-*` (multi-GPU),
`thread-checks` (the analyzer) and its multi-process matrix have no
counterpart here.

    python tools/chaos_drill_torch.py                 # full matrix, on the card
    python tools/chaos_drill_torch.py --cpu --smoke   # corrupt-record,
                                                      # io-error-once,
                                                      # services-crash
    python tools/chaos_drill_torch.py --only nan-rollback watchdog-dump

Runs on the card (CUDA) unless --cpu is given. Prints one JSON row per
scenario and a summary row, and exits nonzero if a contract fails. The
model is tiny (16 px, gf/df 8, batch 8): the drill checks recovery paths,
not speed.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SMOKE_SCENARIOS = ("corrupt-record", "io-error-once", "services-crash")

#: set by main(): the device every subprocess trains or serves on
DEVICE = "cuda"

_TRAIN_SCRIPT = """
import json, sys
import torch
torch.set_num_threads(2)
from dcgan_tpu_torch.config import ModelConfig, TrainConfig
from dcgan_tpu_torch.train.steps import tree_leaves
from dcgan_tpu_torch.train.trainer import train
extra = json.loads(sys.argv[1])
model = dict(output_size=16, gf_dim=8, df_dim=8, compute_dtype="float32")
model.update(extra.pop("model", {}))
base = dict(batch_size=8, tensorboard=False, sample_every_steps=0,
            save_summaries_secs=0.0, log_every_steps=1)
base.update(extra)   # the scenario's settings win
cfg = TrainConfig(model=ModelConfig(**model), **base)
state = train(cfg, synthetic_data=sys.argv[2] == "1",
              max_steps=int(sys.argv[3]), device=sys.argv[4])
total = sum(float(leaf.detach().double().abs().sum())
            for leaf in tree_leaves(state["params"]))
print("STATE_SUM=%.9e" % total, flush=True)
print("TRAIN_DONE step=%d" % int(state["step"]), flush=True)
"""


class Failure(AssertionError):
    pass


def _check(cond, why):
    if not cond:
        raise Failure(why)


def _env(chaos: dict = None) -> dict:
    env = dict(os.environ)
    env.pop("DCGAN_CHAOS", None)
    env["PYTHONPATH"] = REPO
    if chaos:
        env["DCGAN_CHAOS"] = json.dumps(chaos)
    return env


def _run_train(extra: dict, *, max_steps: int, synthetic: bool = True,
               chaos: dict = None, timeout: int = 600):
    """One trainer subprocess; (rc, stdout + stderr)."""
    res = subprocess.run(
        [sys.executable, "-c", _TRAIN_SCRIPT, json.dumps(extra),
         "1" if synthetic else "0", str(max_steps), DEVICE],
        cwd=REPO, env=_env(chaos), capture_output=True, text=True,
        timeout=timeout)
    return res.returncode, res.stdout + res.stderr


def _state_sum(out: str) -> str:
    return next(line for line in out.splitlines()
                if line.startswith("STATE_SUM="))


def _events(ckpt_dir: str):
    path = os.path.join(ckpt_dir, "events.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f]


def _scalar_values(events, key):
    return [e["values"][key] for e in events
            if e["kind"] == "scalars" and key in e["values"]]


def _loss_rows(events) -> dict:
    """{step: (d_loss, g_loss)} of the scalar rows (the last row of a step
    wins)."""
    return {e["step"]: (e["values"]["d_loss"], e["values"]["g_loss"])
            for e in events if e["kind"] == "scalars"
            and "d_loss" in e["values"]}


def _dirs(root: str, tag: str = "") -> dict:
    return dict(checkpoint_dir=os.path.join(root, f"ck{tag}"),
                sample_dir=os.path.join(root, f"sm{tag}"))


# -- scenarios ---------------------------------------------------------------

def scenario_nan_rollback(root: str) -> dict:
    """NaN at step 3 -> rollback to the step-2 snapshot; the run completes
    and anomaly/rollbacks is in the event stream."""
    d = _dirs(root)
    rc, out = _run_train(
        dict(d, nan_policy="rollback", nan_check_steps=1,
             rollback_snapshot_steps=2, max_rollbacks=2,
             rollback_lr_backoff=0.5, save_model_secs=1e9),
        max_steps=6, chaos={"nan_at_step": 3})
    _check(rc == 0, f"trainer failed (rc={rc}): {out[-800:]}")
    _check("rolling back to last-good snapshot at step 2" in out,
           f"no rollback message in output: {out[-800:]}")
    _check("TRAIN_DONE step=6" in out, f"run did not complete: {out[-400:]}")
    rollbacks = _scalar_values(_events(d["checkpoint_dir"]),
                               "anomaly/rollbacks")
    _check(rollbacks and max(rollbacks) >= 1,
           f"anomaly/rollbacks missing from events (got {rollbacks})")
    return {"rollbacks": max(rollbacks), "final_step": 6}


def _make_corrupt_shards(root: str) -> str:
    from dcgan_tpu_torch.data.synthetic import write_image_tfrecords
    from dcgan_tpu_torch.testing.chaos import corrupt_tfrecord_payload

    data_dir = os.path.join(root, "data")
    paths = write_image_tfrecords(data_dir, num_examples=64, image_size=16,
                                  num_shards=2)
    for p in paths:   # one bad record per shard
        corrupt_tfrecord_payload(p, record_index=2)
    return data_dir


def scenario_corrupt_record(root: str) -> dict:
    """Flipped payload bytes within budget -> the records are skipped and
    counted, the run completes."""
    data_dir = _make_corrupt_shards(root)
    d = _dirs(root)
    rc, out = _run_train(
        dict(d, data_dir=data_dir, max_corrupt_records=1000,
             shuffle_buffer=16, num_loader_threads=2, save_model_secs=1e9),
        max_steps=6, synthetic=False)
    _check(rc == 0, f"trainer failed (rc={rc}): {out[-800:]}")
    _check("quarantined corrupt record" in out,
           f"no quarantine log line: {out[-800:]}")
    _check("TRAIN_DONE step=6" in out, f"run did not complete: {out[-400:]}")
    counts = _scalar_values(_events(d["checkpoint_dir"]),
                            "data/corrupt_records")
    _check(counts and max(counts) >= 1,
           f"data/corrupt_records missing from events (got {counts})")
    return {"corrupt_records": int(max(counts)), "final_step": 6}


def scenario_corrupt_budget(root: str) -> dict:
    """The same corruption with budget 1 and more bad records on disk ->
    the run fails, naming the budget."""
    data_dir = _make_corrupt_shards(root)
    rc, out = _run_train(
        dict(_dirs(root), data_dir=data_dir, max_corrupt_records=1,
             shuffle_buffer=16, num_loader_threads=2, save_model_secs=1e9),
        max_steps=200, synthetic=False)
    _check(rc != 0, "budget-exhausted run unexpectedly succeeded")
    _check("budget" in out, f"failure does not name the budget: {out[-800:]}")
    return {"failed_as_required": True}


def scenario_truncate_checkpoint(root: str) -> dict:
    """The newest checkpoint truncated between runs -> the integrity check
    falls back to the step before, marks the step .corrupt, and the
    resume completes."""
    from dcgan_tpu_torch.testing.chaos import truncate_file

    common = dict(_dirs(root), save_model_secs=0.0)  # a save every step
    ck = common["checkpoint_dir"]
    rc, out = _run_train(common, max_steps=4)
    _check(rc == 0, f"phase-A trainer failed (rc={rc}): {out[-800:]}")
    _check(os.path.isdir(os.path.join(ck, "4")), "no step-4 checkpoint")
    _check(os.path.exists(os.path.join(ck, "integrity", "4.json")),
           "no integrity manifest for step 4")
    files = [p for p in glob.glob(os.path.join(ck, "4", "**"),
                                  recursive=True) if os.path.isfile(p)]
    victim = max(files, key=os.path.getsize)
    truncate_file(victim, drop_bytes=max(64, os.path.getsize(victim) // 2))
    rc, out = _run_train(common, max_steps=6)
    _check(rc == 0, f"phase-B trainer failed (rc={rc}): {out[-800:]}")
    _check("failed integrity check" in out,
           f"no integrity-failure message: {out[-800:]}")
    _check(os.path.isdir(os.path.join(ck, "4.corrupt")),
           "truncated step was not marked .corrupt")
    _check("restored checkpoint at step 3" in out,
           f"did not fall back to step 3: {out[-800:]}")
    _check("TRAIN_DONE step=6" in out,
           f"resume did not complete: {out[-400:]}")
    return {"fell_back_to": 3, "final_step": 6}


def scenario_io_error_once(root: str) -> dict:
    """One transient OSError in the checkpoint-manifest write -> retried
    with backoff, the run completes, manifests intact."""
    d = _dirs(root)
    rc, out = _run_train(dict(d, save_model_secs=0.0), max_steps=3,
                         chaos={"io_error_once": "ckpt-manifest"})
    _check(rc == 0, f"trainer failed (rc={rc}): {out[-800:]}")
    _check("transient IO error at 'ckpt-manifest'" in out
           and "retrying" in out, f"no retry log line: {out[-800:]}")
    _check("TRAIN_DONE step=3" in out, f"run did not complete: {out[-400:]}")
    _check(glob.glob(os.path.join(d["checkpoint_dir"], "integrity",
                                  "*.json")),
           "no integrity manifests written")
    return {"retried": True, "final_step": 3}


def scenario_services_crash(root: str) -> dict:
    """The services worker dies -> ServiceError on the dispatch thread and
    the run aborts."""
    rc, out = _run_train(dict(_dirs(root), save_model_secs=1e9),
                         max_steps=50, chaos={"services_worker_crash": 1})
    _check(rc != 0, "run with a dead services worker unexpectedly succeeded")
    _check("ServiceError" in out and "background host service" in out,
           f"worker crash did not surface as ServiceError: {out[-800:]}")
    _check("TRAIN_DONE" not in out, "run claimed completion after crash")
    return {"failed_as_required": True}


def scenario_flight_recorder(root: str) -> dict:
    """NaN under the abort policy -> the run dies and leaves a dump whose
    last record is the failing step with a tripped gate."""
    from dcgan_tpu_torch.train.flight_recorder import read_dump

    d = _dirs(root)
    rc, out = _run_train(dict(d, nan_check_steps=1, save_model_secs=1e9),
                         max_steps=6, chaos={"nan_at_step": 3})
    _check(rc != 0, "NaN-abort run unexpectedly succeeded")
    _check("non-finite training metrics at step 3" in out,
           f"no NaN abort message: {out[-800:]}")
    path = os.path.join(d["checkpoint_dir"], "flight_recorder.jsonl")
    _check(os.path.exists(path), "no flight-recorder dump after NaN abort")
    header, records = read_dump(path)
    _check(header["reason"] == "nan-abort" and header["step"] == 3,
           f"dump header misattributes the abort: {header}")
    _check(records and records[-1]["step"] == 3
           and records[-1]["gate"] == "trip",
           f"last record is not the tripped step: {records[-1:]}")
    _check(all("counters" in r for r in records),
           "records missing the counter-registry snapshot")
    return {"reason": header["reason"], "dump_records": len(records),
            "failing_step": records[-1]["step"]}


def scenario_watchdog_dump(root: str) -> dict:
    """A hang inside the guarded dispatch window -> the stacks, exit 43,
    and a dump naming the phase and the step."""
    from dcgan_tpu_torch.train.flight_recorder import read_dump

    d = _dirs(root)
    rc, out = _run_train(
        dict(d, collective_timeout_secs=3.0, save_model_secs=1e9),
        max_steps=20, chaos={"hang_at_step": 3, "hang_secs": 60},
        timeout=180)
    _check(rc == 43, f"hung run did not exit 43 (rc={rc}): {out[-800:]}")
    _check("hung-collective watchdog" in out and "Thread 0x" in out,
           f"no watchdog diagnostic with stacks: {out[-800:]}")
    _check("TRAIN_DONE" not in out, "hung run claimed completion")
    path = os.path.join(d["checkpoint_dir"], "flight_recorder.jsonl")
    _check(os.path.exists(path), "no flight-recorder dump on watchdog trip")
    header, records = read_dump(path)
    _check(header["reason"] == "watchdog"
           and header.get("phase") == "step-dispatch"
           and header["step"] == 3,
           f"dump header misattributes the trip: {header}")
    _check(records and records[-1]["step"] >= 1,
           f"ring empty at trip: {records[-1:]}")
    return {"rc": rc, "phase": header["phase"],
            "dump_records": len(records)}


def scenario_trace_trigger(root: str) -> dict:
    """A touched --profile_trigger file -> the next boundary opens an
    N-step torch.profiler window, the services worker digests the trace
    in-process, and perf/device/* attribution lands in the event stream;
    the trigger file is consumed as the ack."""
    trig = os.path.join(root, "trigger")
    open(trig, "w").close()   # touched before the run: the first boundary
    ck = os.path.join(root, "ck")
    rc, out = _run_train(
        dict(checkpoint_dir=ck, sample_dir=os.path.join(root, "sm"),
             profile_trigger=trig, profile_num_steps=2, save_model_secs=1e9),
        max_steps=6)
    _check(rc == 0, f"trainer failed (rc={rc}): {out[-800:]}")
    _check("TRAIN_DONE step=6" in out, f"run did not complete: {out[-400:]}")
    _check(not os.path.exists(trig), "trigger file was not consumed")
    _check("trace digest" in out, f"no digest log line: {out[-800:]}")
    keys = ("perf/device/compute_ms", "perf/device/collective_ms",
            "perf/device/idle_gap_ms", "perf/device/step_ms")
    rows = [e["values"] for e in _events(ck) if e["kind"] == "scalars"
            and "perf/device/compute_ms" in e["values"]]
    _check(rows, "no perf/device/* events after the trigger capture")
    missing = [k for k in keys if k not in rows[-1]]
    _check(not missing, f"digest row missing {missing}")
    _check(rows[-1]["perf/device/compute_ms"] > 0,
           f"empty device attribution: {rows[-1]}")
    track = "gpu" if DEVICE == "cuda" else "cpu"
    _check(f"{track} track" in out,
           f"the digest did not read the {track} track: {out[-800:]}")
    return {"device_compute_ms": round(rows[-1][keys[0]], 3),
            "device_idle_gap_ms": round(rows[-1][keys[2]], 3),
            "track": track}


def scenario_pipeline_rollback(root: str) -> dict:
    """NaN at step 3 under --pipeline_gd -> the rollback drains the
    in-flight fake stack, refills from the restored G, and completes; a
    second identical run gives the same final parameters to the printed
    digit."""
    knobs = dict(pipeline_gd=True, nan_policy="rollback", nan_check_steps=1,
                 rollback_snapshot_steps=2, max_rollbacks=2,
                 save_model_secs=1e9)

    def one(tag):
        d = _dirs(root, f"-{tag}")
        rc, out = _run_train(dict(d, **knobs), max_steps=6,
                             chaos={"nan_at_step": 3})
        _check(rc == 0, f"{tag}: trainer failed (rc={rc}): {out[-800:]}")
        _check("rolling back to last-good snapshot at step 2" in out,
               f"{tag}: no rollback message: {out[-800:]}")
        _check("rollback drained the in-flight pipelined fake stack" in out,
               f"{tag}: rollback did not drain the fake buffer: "
               f"{out[-800:]}")
        _check("TRAIN_DONE step=6" in out,
               f"{tag}: run did not complete: {out[-400:]}")
        rollbacks = _scalar_values(_events(d["checkpoint_dir"]),
                                   "anomaly/rollbacks")
        _check(rollbacks and max(rollbacks) >= 1,
               f"{tag}: anomaly/rollbacks missing (got {rollbacks})")
        return _state_sum(out), max(rollbacks)

    sum_a, rollbacks = one("a")
    sum_b, _ = one("b")
    _check(sum_a == sum_b,
           f"pipelined rollback replay diverged: {sum_a} != {sum_b}")
    return {"rollbacks": rollbacks, "final_step": 6,
            "replay_bit_exact": True}


def scenario_progressive_switch(root: str) -> dict:
    """NaN at the step after a phase switch -> the rollback restores the
    post-switch snapshot (the new phase's tree) and completes; the faulted
    run replays bit for bit, and the pre-switch losses equal an unfaulted
    control's."""
    knobs = dict(model=dict(output_size=32), progressive="16:3,32:*",
                 nan_policy="rollback", nan_check_steps=1,
                 rollback_snapshot_steps=100, max_rollbacks=2,
                 save_model_secs=1e9)
    switch_step = 3

    def one(tag, plan):
        d = _dirs(root, f"-{tag}")
        rc, out = _run_train(dict(d, **knobs), max_steps=6, chaos=plan)
        _check(rc == 0, f"{tag}: trainer failed (rc={rc}): {out[-800:]}")
        _check(f"progressive phase 1 at step {switch_step}: r16 -> r32"
               in out, f"{tag}: no phase-switch line: {out[-800:]}")
        _check("TRAIN_DONE step=6" in out,
               f"{tag}: run did not complete: {out[-400:]}")
        return _state_sum(out), _loss_rows(_events(d["checkpoint_dir"])), \
            out, d["checkpoint_dir"]

    sum_a, loss_a, out_a, ck_a = one("a", {"nan_at_step": switch_step + 1})
    _check(f"rolling back to last-good snapshot at step {switch_step}"
           in out_a, f"rollback did not restore the post-switch snapshot: "
           f"{out_a[-800:]}")
    rollbacks = _scalar_values(_events(ck_a), "anomaly/rollbacks")
    _check(rollbacks and max(rollbacks) >= 1,
           f"anomaly/rollbacks missing (got {rollbacks})")
    sum_b, _, _, _ = one("b", {"nan_at_step": switch_step + 1})
    _check(sum_a == sum_b,
           f"faulted progressive replay diverged: {sum_a} != {sum_b}")
    sum_c, loss_c, _, _ = one("control", None)
    for s in range(1, switch_step + 1):
        _check(loss_a.get(s) == loss_c.get(s),
               f"pre-switch phase losses diverged at step {s}: "
               f"{loss_a.get(s)} != {loss_c.get(s)}")
    _check(sum_a != sum_c, "faulted and control runs ended equal although "
                           "the replayed window was re-keyed")
    return {"rollbacks": max(rollbacks), "final_step": 6,
            "replay_bit_exact": True, "preswitch_losses_bit_exact": True}


class _Server:
    """`python -m dcgan_tpu_torch.serve` in a subprocess, its output
    collected by a reader thread."""

    def __init__(self, args, chaos: dict = None):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "dcgan_tpu_torch.serve", *args,
             "--device", DEVICE], cwd=REPO, env=_env(chaos),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.lines = []
        self.reader = threading.Thread(
            target=lambda: [self.lines.append(ln)
                            for ln in self.proc.stdout], daemon=True)
        self.reader.start()

    def out(self) -> str:
        return "".join(self.lines)

    def wait_for(self, token: str, secs: float) -> None:
        deadline = time.monotonic() + secs
        while time.monotonic() < deadline \
                and not any(token in ln for ln in self.lines):
            if self.proc.poll() is not None:
                break
            time.sleep(0.2)
        _check(any(token in ln for ln in self.lines),
               f"never saw {token!r}: {self.out()[-1200:]}")

    def stop(self, timeout: float) -> int:
        try:
            self.proc.send_signal(signal.SIGTERM)
            return self.proc.wait(timeout=timeout)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
            self.reader.join(timeout=10)


def _report(path: str) -> dict:
    _check(os.path.exists(path), "no report row written after the drain")
    with open(path) as f:
        return json.load(f)


def scenario_serve_drain(root: str) -> dict:
    """SIGTERM mid-load to the server -> intake stops, every submitted
    request completes, the report lands, exit 0."""
    d = _dirs(root)
    rc, out = _run_train(dict(d, save_model_secs=1e9), max_steps=1)
    _check(rc == 0, f"checkpoint trainer failed (rc={rc}): {out[-800:]}")
    report = os.path.join(root, "serve-report.json")
    srv = _Server(["--checkpoint_dir", d["checkpoint_dir"], "--max_batch",
                   "8", "--max_wait_ms", "20", "--demo_requests", "2000",
                   "--demo_rps", "25", "--report", report])
    try:
        srv.wait_for("warm: serving", 240)
        time.sleep(1.5)           # some of the load lands first
    finally:
        rc = srv.stop(timeout=120)
    out = srv.out()
    _check(rc == 0, f"serve exited rc={rc} after SIGTERM: {out[-800:]}")
    _check("received signal 15" in out,
           f"no signal acknowledgement: {out[-800:]}")
    _check("drain:" in out and "clean exit" in out,
           f"no drain summary line: {out[-800:]}")
    row = _report(report)
    _check(row["interrupted"] is True, f"report not marked interrupted: "
           f"{row}")
    _check(0 < row["submitted"] < 2000,
           f"signal did not land mid-load (submitted={row['submitted']})")
    _check(row["completed"] == row["submitted"],
           f"in-flight requests lost: submitted {row['submitted']}, "
           f"completed {row['completed']}")
    _check(row["serve/dropped"] == 0,
           f"drain dropped requests: {row['serve/dropped']}")
    return {"submitted": row["submitted"], "completed": row["completed"],
            "unsubmitted": row["unsubmitted"], "clean_exit": True}


def _inject_step(donor_dir: str, serve_dir: str, step: int) -> None:
    """Deliver `step` into `serve_dir` as a trainer would: the integrity
    manifest first, then the step directory copied under a temporary name
    and renamed in, so the promotion watcher never sees half a step."""
    import shutil

    integ = os.path.join(donor_dir, "integrity")
    if os.path.isdir(integ):
        dst = os.path.join(serve_dir, "integrity")
        os.makedirs(dst, exist_ok=True)
        for name in os.listdir(integ):
            if name.startswith(f"{step}."):
                shutil.copy2(os.path.join(integ, name),
                             os.path.join(dst, name))
    tmp = os.path.join(serve_dir, f"tmp.promote.{step}")
    shutil.copytree(os.path.join(donor_dir, str(step)), tmp)
    os.rename(tmp, os.path.join(serve_dir, str(step)))


def scenario_fleet_replica_kill(root: str) -> dict:
    """Three replicas behind the failover router: replica 1 is killed at
    its second dispatch, then a new checkpoint step lands and the watcher
    promotes the survivors. No client request fails, the dead replica is
    drained from rotation, and the promotion captures nothing."""
    import shutil

    d = _dirs(root)
    ck = d["checkpoint_dir"]
    rc, out = _run_train(dict(d, save_model_secs=1e9), max_steps=1)
    _check(rc == 0, f"checkpoint trainer failed (rc={rc}): {out[-800:]}")
    donor = os.path.join(root, "donor")
    shutil.copytree(ck, donor)
    rc, out = _run_train(dict(d, checkpoint_dir=donor, save_model_secs=1e9),
                         max_steps=2)
    _check(rc == 0, f"donor trainer failed (rc={rc}): {out[-800:]}")
    _check(os.path.isdir(os.path.join(donor, "2")),
           "donor run left no step-2 checkpoint")
    report = os.path.join(root, "serve-report.json")
    srv = _Server(["--checkpoint_dir", ck, "--fleet", "3",
                   "--watch_promotions", "--watch_interval_secs", "0.25",
                   "--max_batch", "8", "--max_wait_ms", "20",
                   "--demo_requests", "2000", "--demo_rps", "25",
                   "--report", report],
                  chaos={"fault_replica": 1, "replica_kill_at_dispatch": 2})
    try:
        srv.wait_for("warm: serving", 300)
        srv.wait_for("replica 1 UNHEALTHY", 60)
        _inject_step(donor, ck, 2)
        srv.wait_for("serve fleet: promoted", 120)
        time.sleep(1.0)   # some load on the new weights
    finally:
        rc = srv.stop(timeout=240)
    out = srv.out()
    _check(rc == 0, f"serve exited rc={rc} after SIGTERM: {out[-1200:]}")
    row = _report(report)
    _check(row["interrupted"] is True,
           f"report not marked interrupted: {row}")
    _check(0 < row["submitted"] < 2000,
           f"signal did not land mid-load (submitted={row['submitted']})")
    _check(row["failed"] == 0,
           f"{row['failed']} client request(s) failed: the kill leaked "
           f"past the failover router")
    _check(row["completed"] == row["submitted"],
           f"in-flight requests lost: submitted {row['submitted']}, "
           f"completed {row['completed']}")
    _check(row["serve/dropped"] == 0,
           f"fleet dropped requests: {row['serve/dropped']}")
    fl = row["fleet"]
    _check(fl["replicas"] == 3, f"wrong fleet size in report: {fl}")
    unhealthy = {i for i, _ in fl["unhealthy"]}
    _check(1 in unhealthy, f"killed replica missing from unhealthy "
                           f"events: {fl['unhealthy']}")
    _check(all(i == 1 for i, _ in fl["stop_errors"]),
           f"a survivor failed to stop cleanly: {fl['stop_errors']}")
    _check(any("chaos: replica 1 killed" in err
               for _, err in fl["stop_errors"]),
           f"chaos kill never fired (stop_errors={fl['stop_errors']})")
    _check(fl["promotions"], "watcher never promoted the injected step")
    last = fl["promotions"][-1]
    _check({r.get("replica") for r in last} == {0, 2},
           f"promotion did not target exactly the survivors: {last}")
    _check(all("error" not in r and r["step"] == 2 for r in last),
           f"a survivor's promotion failed or got the wrong step: {last}")
    _check(all(r.get("compile_requests_delta") == 0 for r in last),
           f"promotion captured something: {last}")
    return {"submitted": row["submitted"], "completed": row["completed"],
            "failed": 0, "unhealthy": sorted(unhealthy),
            "failovers": fl["failovers"],
            "promoted_replicas": sorted(r["replica"] for r in last),
            "promoted_step": 2, "compile_requests_delta": 0}


SCENARIOS = {
    "nan-rollback": scenario_nan_rollback,
    "corrupt-record": scenario_corrupt_record,
    "corrupt-budget": scenario_corrupt_budget,
    "truncate-checkpoint": scenario_truncate_checkpoint,
    "io-error-once": scenario_io_error_once,
    "services-crash": scenario_services_crash,
    "flight-recorder": scenario_flight_recorder,
    "watchdog-dump": scenario_watchdog_dump,
    "pipeline-rollback": scenario_pipeline_rollback,
    "progressive-switch": scenario_progressive_switch,
    "trace-trigger": scenario_trace_trigger,
    "serve-drain": scenario_serve_drain,
    "fleet-replica-kill": scenario_fleet_replica_kill,
}


def main(argv=None) -> int:
    global DEVICE
    p = argparse.ArgumentParser(
        prog="chaos_drill_torch",
        description="fault-injection scenarios of the PyTorch port's "
                    "trainer and server (on the card unless --cpu)")
    p.add_argument("--smoke", action="store_true",
                   help=f"the cheap subset: {', '.join(SMOKE_SCENARIOS)}")
    p.add_argument("--only", nargs="+", choices=sorted(SCENARIOS),
                   default=None, help="run just these scenarios")
    p.add_argument("--cpu", action="store_true",
                   help="train and serve on the CPU (the port's entry "
                        "points run on the card otherwise)")
    args = p.parse_args(argv)
    DEVICE = "cpu" if args.cpu else "cuda"
    names = args.only or (SMOKE_SCENARIOS if args.smoke
                          else sorted(SCENARIOS))
    failures = 0
    for name in names:
        with tempfile.TemporaryDirectory(prefix=f"chaos_{name}_") as root:
            row = {"scenario": name}
            t0 = time.perf_counter()
            try:
                row.update(SCENARIOS[name](root))
                row["ok"] = True
            except (Failure, subprocess.TimeoutExpired) as e:
                row.update(ok=False, error=str(e))
                failures += 1
            row["seconds"] = round(time.perf_counter() - t0, 3)
            print(json.dumps(row), flush=True)
    print(json.dumps({"label": "chaos-drill-torch", "device": DEVICE,
                      "scenarios": len(names), "failed": failures}),
          flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
