"""The port's inventory of the namespaced JSONL event keys it can emit (the
counterpart of `dcgan_tpu/train/event_keys.py`), each mapped to the knob
that gates it.

"always" means the key may appear in a run with default flags; every other
key stays out of the event stream until its knob (or its event) is on, so
a run that arms a feature without using it (rollback armed, no NaN) writes
the stream a default run writes. A key the JAX inventory also lists has
the same gate there (tests/test_torch_faults_keys.py holds both).

Un-namespaced scalars (d_loss, g_loss, gp, r1, ...) are the step's metric
dict and are outside this inventory. Import-light: no torch.
"""

from __future__ import annotations

from typing import Dict

EVENT_KEYS: Dict[str, str] = {
    # -- StepTimer window stats (utils/profiling.py) ---------------------
    "perf/step_ms_mean": "always",
    "perf/step_ms_p50": "always",
    "perf/step_ms_p90": "always",
    "perf/step_ms_max": "always",
    "perf/steps_per_sec": "always",
    "perf/images_per_sec": "always",
    "perf/host_ms_mean": "always",
    "perf/dispatch_occupancy": "always",

    # -- startup breakdown (StartupProfile) and the restore's verify
    #    stats: one row at the first step. The port has no compile cache,
    #    so the JAX gate "compile_cache_dir|aot_warmup" reads aot_warmup
    "perf/startup/*": "compile_cache_dir|aot_warmup",
    "perf/restore/verify_files": "compile_cache_dir|aot_warmup",
    "perf/restore/verify_bytes": "compile_cache_dir|aot_warmup",
    "perf/restore/verify_cached_bytes": "compile_cache_dir|aot_warmup",
    "perf/restore/verify_ms": "compile_cache_dir|aot_warmup",

    # -- capture times of --aot_warmup's rows -----------------------------
    "perf/compile_ms/*": "aot_warmup",

    # -- the trace digest of each closed capture window (utils/trace.py) --
    "perf/device/compute_ms": "profile_dir|profile_trigger",
    "perf/device/collective_ms": "profile_dir|profile_trigger",
    "perf/device/idle_gap_ms": "profile_dir|profile_trigger",
    "perf/device/span_ms": "profile_dir|profile_trigger",
    "perf/device/step_ms": "profile_dir|profile_trigger",
    "perf/device/overlap_frac": "profile_dir|profile_trigger",

    # -- recovery counters (absent until nonzero) --------------------------
    "anomaly/rollbacks": "nan_policy=rollback",
    "data/corrupt_records": "nonzero quarantine count",

    # -- progressive schedule ---------------------------------------------
    "progressive/phase": "progressive schedule",
    "progressive/resolution": "progressive schedule",
    "progressive/alpha": "progressive schedule (fade window)",
    "progressive/switch_ms": "progressive schedule",

    # -- reduced-precision policy: one row at the first log ---------------
    "perf/precision/policy": "precision",
    "perf/precision/master_f32_leaves": "precision",

    # -- probes -----------------------------------------------------------
    "sample/*": "sample_every_steps",
    "eval/fid": "fid_every_steps",
    "eval/kid": "fid_every_steps",

    # -- serving plane: only in `python -m dcgan_tpu_torch.serve`'s own
    #    report and events, never in the trainer's JSONL ------------------
    "serve/requests": "serve entrypoint",
    "serve/completed": "serve entrypoint",
    "serve/dropped": "serve entrypoint",
    "serve/batches": "serve entrypoint",
    "serve/images": "serve entrypoint",
    "serve/queue_depth_max": "serve entrypoint",
    "serve/pad_frac": "serve entrypoint",
    "serve/samples_per_sec": "serve entrypoint",
    "serve/p50_ms": "serve entrypoint",
    "serve/p99_ms": "serve entrypoint",
    "serve/mean_ms": "serve entrypoint",
    "serve/restore_ms": "serve entrypoint",
    "serve/warmup_ms": "serve entrypoint",
    "serve/cold_start_ms": "serve entrypoint",
    "serve/compile_ms/*": "serve entrypoint",
    "serve/recompiles_after_warmup": "serve entrypoint (compile cache on)",
    "serve/dropped_overload": "serve entrypoint",
    "serve/dropped_failover": "serve entrypoint (--fleet)",
    "serve/fleet_replicas": "serve entrypoint (--fleet)",
    "serve/fleet_unhealthy": "serve entrypoint (--fleet)",
    "serve/fleet_failovers": "serve entrypoint (--fleet)",
    "serve/promotions": "serve entrypoint (weight promotion)",
    "serve/promote_swap_ms": "serve entrypoint (weight promotion)",
}

