"""Kineto trace parsing: device-track selection, per-program rows and the
step-time digest (the counterpart of `dcgan_tpu/utils/trace.py`, over the
Chrome traces torch.profiler writes).

The trainer digests each closed capture in-process (on the services
worker) into `perf/device/*`; `tools/trace_summary_torch.py` prints the
same rows offline, so the two cannot disagree about a trace.

Track selection:

- "gpu": the pids of the card's kernel, memcpy and memset spans. `ops`
  are those spans. `programs` are the `gpu_user_annotation` spans on the
  same pids: Kineto derives them from the `record_function` ranges the
  captured programs run under (graphs.py), from the first to the last
  device op launched inside the range, one span per stream; the pieces
  of one range (the same name and "External id") are joined into one
  program execution. The profiler's own `ProfilerStep#<n>` ranges are not
  programs.
- "cpu": a capture with no device ops (a CPU run): the `user_annotation`
  spans, the `record_function` ranges on the host, are both programs and
  ops.
- "none": neither; callers decide (the CLI tool exits nonzero with a
  usage hint).

What Kineto writes (torch 2.11 + CUDA 12.8 on an NVIDIA H100, read from
the trainer's captures): the card's work under pid = the device index
(0), its metadata `process_name` "python3" (the process's own name),
`process_labels` "GPU 0", and one `thread_name` "stream <id> " per stream
(tid = the stream id); the categories "kernel", "gpu_memcpy",
"gpu_memset" and "gpu_user_annotation" (args {"External id": n}, one
span per program execution on the stream it ran on). The host's events
sit under the OS pid: "cpu_op", "user_annotation", "cuda_runtime",
"overhead" and one whole-window "Trace" span. Kineto writes metadata for
pids 0-7 whether or not a device ran anything, so the selection keys on
the ops' categories, not on the track names. A CPU capture has only the
host's categories.

`compute_ms` is the union of the OP spans, not of the program spans, on
the GPU track. A program's annotation covers the gaps between its
kernels (the launches inside a graph replay), and those gaps show in
`idle_gap_ms`; on a TPU track the program spans are the busy time. This
is the one place where the port reads "busy" differently from the JAX
package.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
from typing import Any, Dict, List, Tuple

# substrings marking a device-side collective in program/op names: the
# JAX package's markers, and NCCL's kernels
_COLLECTIVE_MARKERS = ("all-reduce", "all-gather", "reduce-scatter",
                      "all-to-all", "collective-permute", "collective",
                      "allreduce", "allgather", "ragged-all-to-all", "nccl")

# Kineto's categories of the card's op spans, of the device-side
# record_function ranges and of the host-side ones
_DEVICE_OP_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_GPU_PROGRAM_CAT = "gpu_user_annotation"
_CPU_PROGRAM_CAT = "user_annotation"
_PROFILER_STEP = "ProfilerStep#"


def find_trace(path: str, host: str = "") -> str:
    """Accept a trace file or a --profile_dir root (finds the newest).

    With `host`, hits whose filename belongs to that host win (the trace
    handler names each file `<hostname>.<n>.pt.trace.json.gz`), so on a
    shared filesystem a peer's newer timeline is not taken; falls back to
    the newest hit when no filename matches."""
    if os.path.isfile(path):
        return path
    hits = sorted(glob.glob(os.path.join(
        path, "**", "*.trace.json.gz"), recursive=True))
    if not hits:
        raise FileNotFoundError(f"no *.trace.json.gz under {path}")
    if host:
        mine = [h for h in hits
                if os.path.basename(h).startswith(host + ".")]
        if mine:
            return mine[-1]
    return hits[-1]


def load_events(trace_path: str) -> List[dict]:
    """The raw traceEvents list of one capture (gz or plain json)."""
    opener = gzip.open if trace_path.endswith(".gz") else open
    with opener(trace_path) as f:
        data = json.load(f)
    return data.get("traceEvents", [])


def _cat(e: dict) -> str:
    return str(e.get("cat", "")).lower()


def _join_pieces(spans: List[dict]) -> List[dict]:
    """One span per range execution: the per-stream pieces of a device
    annotation that share a name and an "External id" joined (first
    start to last end); a span without the id stays as it is."""
    out: List[dict] = []
    pieces: Dict[Tuple[str, Any], dict] = {}
    for e in spans:
        ext = e.get("args", {}).get("External id")
        if ext is None:
            out.append(e)
            continue
        key = (e["name"], ext)
        got = pieces.get(key)
        if got is None:
            pieces[key] = dict(e)
            continue
        lo = min(got["ts"], e["ts"])
        hi = max(got["ts"] + got["dur"], e["ts"] + e["dur"])
        got["ts"], got["dur"] = lo, hi - lo
    return sorted(out + list(pieces.values()), key=lambda e: e["ts"])


def select_device_tracks(events: List[dict]
                         ) -> Tuple[List[dict], List[dict], str]:
    """(program events, op events, source) of the device timeline.

    `programs` carries the per-program execution spans (the rows and the
    step time); `ops` the device's own work (busy time, idle gaps and
    collective attribution). Source is "gpu", "cpu" (programs == ops) or
    "none"."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    ops = [e for e in xs if _cat(e) in _DEVICE_OP_CATS]
    if ops:
        pids = {e["pid"] for e in ops}
        programs = _join_pieces(
            [e for e in xs if _cat(e) == _GPU_PROGRAM_CAT
             and e["pid"] in pids
             and not str(e["name"]).startswith(_PROFILER_STEP)])
        return programs or ops, ops, "gpu"
    annotations = [e for e in xs if _cat(e) == _CPU_PROGRAM_CAT
                   and not str(e["name"]).startswith(_PROFILER_STEP)]
    if annotations:
        return annotations, annotations, "cpu"
    return [], [], "none"


def program_rows(device_events: List[dict]) -> List[dict]:
    """Per-program execution stats, sorted by total time descending —
    the rows tools/trace_summary_torch.py prints."""
    rows: Dict[str, List[float]] = {}
    for e in device_events:
        rows.setdefault(e["name"], []).append(e["dur"] / 1e3)  # us -> ms
    out = []
    for name, durs in sorted(rows.items(), key=lambda kv: -sum(kv[1])):
        ds = sorted(durs)
        out.append({
            "program": name[:80], "n": len(ds),
            "total_ms": round(sum(ds), 3),
            "ms_min": round(ds[0], 4), "ms_max": round(ds[-1], 4),
            "ms_median": round(ds[len(ds) // 2], 4),
        })
    return out


def summarize(trace_path: str) -> Tuple[List[dict], str]:
    """(per-program rows, track source) for one capture."""
    programs, _, source = select_device_tracks(load_events(trace_path))
    return program_rows(programs), source


def _merge_intervals(spans: List[Tuple[float, float]]
                     ) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for lo, hi in sorted(spans):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return [(lo, hi) for lo, hi in merged]


def is_collective(name: str) -> bool:
    low = name.lower()
    return any(m in low for m in _COLLECTIVE_MARKERS)


def _intersect_total(a: List[Tuple[float, float]],
                     b: List[Tuple[float, float]]) -> float:
    """Total length of the intersection of two MERGED interval lists
    (both sorted, non-overlapping — `_merge_intervals` output)."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def devstep_ms(path: str, per_exec: int = 1):
    """The device's own per-step ms from a capture (file or profile dir):
    the busiest program's median execution divided by `per_exec` (the
    steps each execution covers: a call of K captured steps). None when
    the capture has no usable device events."""
    d = digest(find_trace(path))
    if d["source"] == "none" or d["program_ms_median"] <= 0:
        return None
    return d["program_ms_median"] / max(1, per_exec)


def stage_step_ms(d: dict,
                  stages: Tuple[str, ...] = ("d_update", "g_update")
                  ) -> float:
    """Per-step device ms when the step was dispatched as stage programs
    (--pipeline_gd): the sum of the named stages' median executions. 0.0
    when the capture's programs do not name the stages; callers keep
    their busiest-program estimate."""
    return sum(r["ms_median"] for r in d.get("rows", [])
               if any(s in r["program"] for s in stages))


def _spans(events: List[dict]) -> List[Tuple[float, float]]:
    return [(e["ts"], e["ts"] + e["dur"]) for e in events]


def digest(trace_path: str) -> dict:
    """Step-time attribution over one capture's device timeline.

    Returns (all ms):
      - source:        which track selection applied (see module doc)
      - compute_ms:    union of the op spans (overlapping spans merged,
                       so concurrent streams are not double counted)
      - collective_ms: union of the collective-named op spans
      - idle_gap_ms:   span minus compute: the time the device sat idle
                       between and inside the programs
      - span_ms:       first event start -> last event end (programs and
                       ops)
      - program / program_n / program_ms_median: the busiest program (the
        train step's row; callers divide its median by the steps of a
        call for the per-step device time)
      - overlap_frac:  the share of collective time that ran concurrently
                       with non-collective ops (0.0 without collectives)
      - rows:          the full per-program table
    """
    programs, ops, source = select_device_tracks(load_events(trace_path))
    if not programs:
        return {"source": "none", "compute_ms": 0.0, "collective_ms": 0.0,
                "idle_gap_ms": 0.0, "span_ms": 0.0, "program": "",
                "program_n": 0, "program_ms_median": 0.0,
                "overlap_frac": 0.0, "rows": []}
    busy = _merge_intervals(_spans(ops))
    busy_us = sum(hi - lo for lo, hi in busy)
    whole = _merge_intervals(_spans(programs) + _spans(ops))
    span_us = whole[-1][1] - whole[0][0]
    coll_merged = _merge_intervals(
        _spans([e for e in ops if is_collective(e["name"])]))
    coll_us = sum(hi - lo for lo, hi in coll_merged)
    nonc_merged = _merge_intervals(
        _spans([e for e in ops if not is_collective(e["name"])]))
    overlap_us = _intersect_total(coll_merged, nonc_merged)
    rows = program_rows(programs)
    top = rows[0]
    return {
        "source": source,
        "compute_ms": round(busy_us / 1e3, 4),
        "collective_ms": round(coll_us / 1e3, 4),
        "idle_gap_ms": round(max(0.0, span_us - busy_us) / 1e3, 4),
        "span_ms": round(span_us / 1e3, 4),
        "program": top["program"],
        "program_n": top["n"],
        "program_ms_median": top["ms_median"],
        "overlap_frac": round(overlap_us / coll_us, 4) if coll_us else 0.0,
        "rows": rows,
    }
