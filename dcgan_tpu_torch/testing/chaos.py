"""Deterministic fault injection (a copy of `dcgan_tpu/testing/chaos.py`,
so that one `DCGAN_CHAOS` plan arms either package).

A `FaultPlan` names exactly which fault fires and when, with no
randomness, so every chaos scenario is a reproducible test. Plans are
selected explicitly: by `set_plan` (tests) or through the `DCGAN_CHAOS`
environment variable (JSON, read once per process; the contract
tools/chaos_drill_torch.py uses to arm one fault per subprocess). With no
plan armed every hook below is a None-check.

Injection points in the port:

- `should_inject_nan(step)`  the trainer's NaN gate: its view of the step's
  metrics is poisoned once at `nan_at_step` (the rollback drill);
- `maybe_io_error(tag)`      inside utils/retry.retry_io's attempts: one
  OSError when `io_error_once` equals the site's tag ("ckpt-manifest",
  "services");
- `should_crash_worker(n)`   train/services.py's worker: raises before its
  `services_worker_crash`-th task (1-based);
- `maybe_self_signal(step)`  the trainer's call boundary: SIGTERM to this
  process once at `sigterm_at_step`;
- `maybe_hang(step)`         inside the trainer's watchdog-guarded dispatch
  window: sleeps `hang_secs` once at `hang_at_step`;
- `should_kill_replica(r, n)` / `maybe_replica_hang(r, n)` /
  `maybe_replica_slow_beat(r, n)`  serve/worker.py's per-dispatch hooks:
  crash, wedge or mute the heartbeat of one replica of a ServeFleet at its
  n-th dispatch.

The plan's live-elasticity fields (`preempt_notice_at_step`,
`grow_notice_at_step`) parse as in the JAX package; the port has no
live-elasticity plane yet to consult them.

A JSON object whose keys are all digit strings is a per-process map
`{"<pid>": {fields...}}` selected by the `MH_PID` environment variable
(absent means "0"); a process without an entry gets no plan.

Disk faults (`corrupt_record`, `truncate_checkpoint`) are properties of the
bytes on disk: the plan carries them for the drill's bookkeeping, and the
drill applies them with the helpers at the end of this module.

One-shot semantics: each armed fault fires exactly once per process, so a
step-keyed NaN that the rollback replays does not fire again.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Optional, Set

ENV_VAR = "DCGAN_CHAOS"


@dataclasses.dataclass
class FaultPlan:
    """One deterministic fault schedule. Zero/empty fields are unarmed."""

    nan_at_step: int = 0           # >0: poison the NaN gate's metrics once
    corrupt_record: int = 0        # drill bookkeeping: which record index the
                                   # drill corrupts on disk (helpers below)
    truncate_checkpoint: int = 0   # drill bookkeeping: which checkpoint step
                                   # the drill truncates on disk
    io_error_once: str = ""        # site tag whose next retry_io attempt
                                   # raises one OSError
    services_worker_crash: int = 0  # >0: services worker raises before its
                                    # n-th task (1-based)
    sigterm_at_step: int = 0       # >0: deliver SIGTERM to this process at
                                   # that trainer step boundary (once)
    hang_at_step: int = 0          # >0: sleep hang_secs at that step
                                   # boundary (once) — a peer that never
                                   # joins the next collective
    hang_secs: float = 3600.0      # how long hang_at_step sleeps (far past
                                   # any sane collective_timeout_secs)
    preempt_notice_at_step: int = 0  # >0: raise a preemption notice (live
                                     # mesh SHRINK) at that step boundary
                                     # (once)
    grow_notice_at_step: int = 0     # >0: raise a capacity-restored notice
                                     # (live mesh GROW-back) at that step
                                     # boundary (once)
    # serving-fleet faults: target ONE replica of an
    # in-process ServeFleet. `fault_replica` names the replica index the
    # replica_* fields apply to (arming comes from the *_at_dispatch
    # fields being >0, so replica 0 is targetable); dispatch indices are
    # 1-based counts of that replica's device dispatches.
    fault_replica: int = 0           # replica index the replica_* faults
                                     # target
    replica_kill_at_dispatch: int = 0   # >0: the replica's worker raises
                                        # before its n-th dispatch — a
                                        # replica crash mid-trace
    replica_hang_at_dispatch: int = 0   # >0: the replica's worker sleeps
                                        # hang_secs before its n-th
                                        # dispatch — a wedged device that
                                        # stops heartbeating
    replica_slow_beat_at_dispatch: int = 0  # >0: suppress the replica's
                                            # heartbeat for slow_beat_secs
                                            # starting at its n-th
                                            # dispatch — still serving,
                                            # but looks dead to the
                                            # router's health monitor
    slow_beat_secs: float = 2.0      # how long replica_slow_beat mutes
                                     # the heartbeat
    _fired: Set[str] = dataclasses.field(default_factory=set)

    def fire_once(self, name: str) -> bool:
        """True exactly once per armed fault name."""
        if name in self._fired:
            return False
        self._fired.add(name)
        return True


_plan: Optional[FaultPlan] = None
_plan_loaded = False


def plan_from_env(env=None) -> Optional[FaultPlan]:
    """Parse DCGAN_CHAOS, or None.

    Flat JSON object of FaultPlan fields = one plan for this process.
    All-digit keys = per-process map selected by MH_PID (no entry for this
    process = no plan armed here).
    """
    environ = env if env is not None else os.environ
    raw = environ.get(ENV_VAR, "")
    if not raw:
        return None
    d = json.loads(raw)
    if d and all(isinstance(k, str) and k.isdigit() for k in d):
        pid = environ.get("MH_PID", "0")
        d = d.get(pid)
        if d is None:
            return None
        if not isinstance(d, dict):
            raise ValueError(
                f"per-process {ENV_VAR} entry for pid {pid} must be an "
                f"object of FaultPlan fields, got {d!r}")
    fields = {f.name for f in dataclasses.fields(FaultPlan)
              if not f.name.startswith("_")}
    unknown = sorted(set(d) - fields)
    if unknown:
        raise ValueError(f"unknown {ENV_VAR} fault(s) {unknown}; "
                         f"known: {sorted(fields)}")
    return FaultPlan(**d)


def active_plan() -> Optional[FaultPlan]:
    """The process's armed plan: set_plan() wins, else DCGAN_CHAOS (parsed
    once), else None."""
    global _plan, _plan_loaded
    if not _plan_loaded:
        _plan = plan_from_env()
        _plan_loaded = True
    return _plan


def set_plan(plan: Optional[FaultPlan]) -> None:
    """Arm (or with None, disarm) a plan programmatically — tests."""
    global _plan, _plan_loaded
    _plan = plan
    _plan_loaded = True


def reset() -> None:
    """Forget any armed plan AND the env cache (next access re-reads env)."""
    global _plan, _plan_loaded
    _plan = None
    _plan_loaded = False


# -- hooks (called from production code; all no-ops without a plan) ----------

def should_inject_nan(step: int) -> bool:
    plan = active_plan()
    return bool(plan and plan.nan_at_step
                and step == plan.nan_at_step
                and plan.fire_once("nan_at_step"))


def maybe_io_error(tag: str) -> None:
    plan = active_plan()
    if plan and plan.io_error_once and plan.io_error_once == tag \
            and plan.fire_once("io_error_once"):
        raise OSError(f"chaos: injected transient IO error at {tag!r}")


def should_crash_worker(task_index: int) -> bool:
    """`task_index` is 1-based: the n-th task the worker picks up."""
    plan = active_plan()
    return bool(plan and plan.services_worker_crash
                and task_index >= plan.services_worker_crash
                and plan.fire_once("services_worker_crash"))


def maybe_self_signal(step: int) -> None:
    """Deliver SIGTERM to this process once at `sigterm_at_step` — the
    deterministic stand-in for a preemption notice landing on one host."""
    import signal

    plan = active_plan()
    if plan and plan.sigterm_at_step and step == plan.sigterm_at_step \
            and plan.fire_once("sigterm_at_step"):
        os.kill(os.getpid(), signal.SIGTERM)


def maybe_hang(step: int) -> None:
    """Sleep `hang_secs` once at `hang_at_step`: this process goes silent
    inside the trainer's watchdog-guarded section while its peers block in
    a real collective it never joins."""
    import time

    plan = active_plan()
    if plan and plan.hang_at_step and step == plan.hang_at_step \
            and plan.fire_once("hang_at_step"):
        print(f"[dcgan_tpu_torch] chaos: hanging process for {plan.hang_secs:.0f}s "
              f"at step {step}", flush=True)
        time.sleep(plan.hang_secs)


def _replica_armed(plan: Optional[FaultPlan], replica: int,
                   field: str, dispatch_index: int) -> bool:
    """Shared predicate for the fleet hooks: the plan targets `replica`
    and the named *_at_dispatch field matches this 1-based dispatch."""
    if not plan or plan.fault_replica != replica:
        return False
    at = getattr(plan, field)
    return bool(at and dispatch_index >= at and plan.fire_once(field))


def should_kill_replica(replica: int, dispatch_index: int) -> bool:
    """True once when replica `replica` reaches its
    `replica_kill_at_dispatch`-th dispatch (1-based) — the worker raises
    and the replica poisons, exactly like a device crash mid-trace."""
    return _replica_armed(active_plan(), replica,
                          "replica_kill_at_dispatch", dispatch_index)


def maybe_replica_hang(replica: int, dispatch_index: int) -> None:
    """Sleep `hang_secs` once at replica `replica`'s
    `replica_hang_at_dispatch`-th dispatch: the worker wedges on its own
    dispatch thread, heartbeats stop, and the router's health monitor
    must drain the replica and failover its queue."""
    import time

    plan = active_plan()
    if _replica_armed(plan, replica, "replica_hang_at_dispatch",
                      dispatch_index):
        print(f"[dcgan_tpu_torch] chaos: hanging replica {replica} for "
              f"{plan.hang_secs:.0f}s at dispatch {dispatch_index}",
              flush=True)
        time.sleep(plan.hang_secs)


def maybe_replica_slow_beat(replica: int, dispatch_index: int) -> float:
    """Seconds to suppress replica `replica`'s heartbeat, or 0.0. Fires
    once at `replica_slow_beat_at_dispatch`: the replica keeps serving
    but looks dead to the router until `slow_beat_secs` elapse — the
    false-positive/re-admission path of the health monitor."""
    plan = active_plan()
    if _replica_armed(plan, replica, "replica_slow_beat_at_dispatch",
                      dispatch_index):
        return float(plan.slow_beat_secs)
    return 0.0


# -- disk-fault helpers (drill/tests only; never called by production) -------

def corrupt_tfrecord_payload(path: str, record_index: int = 0) -> int:
    """Flip one byte inside record `record_index`'s payload, leaving its CRC
    untouched — a CRC-verifying reader sees a data-CRC mismatch at exactly
    that record. Returns the file offset of the corrupted record."""
    with open(path, "r+b") as f:
        idx = 0
        while True:
            offset = f.tell()
            header = f.read(12)
            if len(header) < 12:
                raise ValueError(f"{path} has only {idx} record(s); cannot "
                                 f"corrupt record {record_index}")
            (length,) = struct.unpack("<Q", header[:8])
            if idx == record_index:
                f.seek(offset + 12)   # first payload byte
                b = f.read(1)
                f.seek(offset + 12)
                f.write(bytes([b[0] ^ 0xFF]))
                return offset
            f.seek(offset + 12 + length + 4)
            idx += 1


def truncate_file(path: str, drop_bytes: int = 64) -> int:
    """Chop `drop_bytes` off the end of `path` (at least one byte remains).
    Returns the new size."""
    size = os.path.getsize(path)
    new_size = max(1, size - drop_bytes)
    with open(path, "r+b") as f:
        f.truncate(new_size)
    return new_size
