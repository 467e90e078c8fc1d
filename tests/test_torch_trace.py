"""The port's Kineto trace parser (dcgan_tpu_torch/utils/trace.py): its
pure helpers equal to the JAX package's (dcgan_tpu/utils/trace.py) on
seeded inputs, its digest on hand-built Kineto-shaped traces (kernels,
device annotations, a gap inside a program, concurrent streams, a
collective under compute) and on a real CPU capture, and
tools/trace_summary_torch.py."""

import gzip
import importlib.util
import json
import os
import pathlib

import numpy as np
import pytest
import torch
from torch_jax_draws import one_torch_thread  # noqa: F401

from dcgan_tpu.utils import trace as jtrace
from dcgan_tpu_torch.utils import trace

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _spans(rng, n):
    lo = rng.uniform(0, 1000, n)
    return [(float(a), float(a + d)) for a, d in
            zip(lo, rng.exponential(40, n))]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_intervals_equals_jax(seed):
    rng = np.random.default_rng(seed)
    spans = _spans(rng, int(rng.integers(1, 80)))
    assert trace._merge_intervals(spans) == jtrace._merge_intervals(spans)
    assert trace._merge_intervals([]) == jtrace._merge_intervals([]) == []


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_intersect_total_equals_jax(seed):
    rng = np.random.default_rng(100 + seed)
    a = trace._merge_intervals(_spans(rng, int(rng.integers(1, 50))))
    b = trace._merge_intervals(_spans(rng, int(rng.integers(1, 50))))
    assert trace._intersect_total(a, b) == jtrace._intersect_total(a, b)
    assert trace._intersect_total(a, a) == pytest.approx(
        sum(hi - lo for lo, hi in a))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_program_rows_equal_jax(seed):
    rng = np.random.default_rng(200 + seed)
    names = ["train_step", "multi_step@k4", "sampler", "d_update",
             "x" * 100]
    events = [{"name": names[int(rng.integers(0, len(names)))],
               "dur": float(rng.exponential(5000))}
              for _ in range(int(rng.integers(1, 60)))]
    assert trace.program_rows(events) == jtrace.program_rows(events)
    d = {"rows": trace.program_rows(events)}
    assert trace.stage_step_ms(d) == jtrace.stage_step_ms(d)


@pytest.mark.parametrize("seed", [0, 1])
def test_find_trace_equals_jax(tmp_path, seed):
    """Files of several hosts in nested dirs: the newest, and the newest
    of a host, as the JAX package picks them; a file path is itself."""
    rng = np.random.default_rng(300 + seed)
    for i in range(int(rng.integers(2, 9))):
        host = ["alpha", "beta", "alpha.b"][int(rng.integers(0, 3))]
        sub = tmp_path / f"s{int(rng.integers(0, 3))}"
        sub.mkdir(exist_ok=True)
        n = int(rng.integers(10 ** 17, 10 ** 18))
        (sub / f"{host}.{n}.pt.trace.json.gz").write_bytes(b"")
    (tmp_path / "notes.json").write_text("{}")
    for host in ("", "alpha", "beta", "gamma"):
        assert trace.find_trace(str(tmp_path), host=host) == \
            jtrace.find_trace(str(tmp_path), host=host)
    one = trace.find_trace(str(tmp_path))
    assert trace.find_trace(one) == one
    with pytest.raises(FileNotFoundError):
        trace.find_trace(str(tmp_path / "s9"))


def test_is_collective_equals_jax_and_takes_nccl():
    names = ["all-reduce.13", "ALL-GATHER-start", "reduce-scatter.2",
             "collective-permute-done.1", "fusion.4", "jit_train_step(123)",
             "all-to-all.3", "ragged-all-to-all", "allgather", "train_step",
             "void moments_cluster_kernel<64>(float const*)"]
    for name in names:
        assert trace.is_collective(name) == jtrace.is_collective(name), name
    for name in ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*)",
                 "ncclKernel_Broadcast_RING_LL", "NCCL send"):
        assert trace.is_collective(name)
    assert not jtrace.is_collective("ncclKernel_Broadcast_RING_LL")


# ---------------------------------------------------------------------------
# the digest on hand-built Kineto traces
# ---------------------------------------------------------------------------

HOST = 4242


def _meta():
    out = [{"ph": "M", "name": "process_name", "pid": HOST, "tid": 0,
            "args": {"name": "python3"}},
           {"ph": "M", "name": "process_labels", "pid": HOST, "tid": 0,
            "args": {"labels": "CPU"}}]
    for pid in range(8):   # Kineto names every GPU pid, used or not
        out += [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                 "args": {"name": "python3"}},
                {"ph": "M", "name": "process_labels", "pid": pid, "tid": 0,
                 "args": {"labels": f"GPU {pid}"}}]
    for tid in (7, 8, 9):
        out.append({"ph": "M", "name": "thread_name", "pid": 0, "tid": tid,
                    "args": {"name": f"stream {tid} "}})
    return out


def _x(cat, name, ts, dur, pid=0, tid=7, **args):
    e = {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
         "ts": float(ts), "dur": float(dur)}
    if args:
        e["args"] = {k.replace("_", " "): v for k, v in args.items()}
    return e


def _host(ts, dur, name="train_step"):
    """The host side of a range: its user annotation, a runtime call."""
    return [_x("user_annotation", name, ts - 50, dur, pid=HOST, tid=HOST),
            _x("cuda_runtime", "cudaGraphLaunch", ts - 40, 10, pid=HOST,
               tid=HOST)]


def _write(path, events):
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    return str(path)


def test_digest_reads_ops_as_busy_and_programs_as_steps(tmp_path):
    """Two train_step replays, the first with a 100 us gap between its
    kernels: compute is the kernels' union (1.9 ms), the gap and the
    500 us between the replays are idle, a program spans its first to
    its last kernel; host events and the profiler's own ranges are not
    read."""
    ev = _meta() + _host(0, 1000) + _host(1500, 1000) + [
        _x("gpu_user_annotation", "train_step", 0, 1000, External_id=11),
        _x("gpu_user_annotation", "train_step", 1500, 1000, External_id=19),
        _x("gpu_user_annotation", "ProfilerStep#3", 0, 2500,
           External_id=2),
        _x("kernel", "void gbm_wgmma_kernel<64>()", 0, 250),
        _x("gpu_memset", "Memset (Device)", 250, 50),
        _x("kernel", "void ssa_fwd_vec_kernel()", 400, 600),
        _x("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 1500, 1000),
        _x("Trace", "PyTorch Profiler (0)", -100, 3000, pid=HOST,
           tid=HOST)]
    d = trace.digest(_write(tmp_path / "t.pt.trace.json.gz", ev))
    assert d["source"] == "gpu"
    assert d["compute_ms"] == pytest.approx(1.9)
    assert d["span_ms"] == pytest.approx(2.5)
    assert d["idle_gap_ms"] == pytest.approx(0.6)
    assert (d["program"], d["program_n"], d["program_ms_median"]) == \
        ("train_step", 2, 1.0)
    assert [r["program"] for r in d["rows"]] == ["train_step"]
    assert d["collective_ms"] == 0.0 and d["overlap_frac"] == 0.0


def test_digest_joins_a_program_across_streams(tmp_path):
    """Kernels on two streams overlap: busy is their union, not their
    sum; the two per-stream pieces of one range execution (same name and
    External id) are one program execution."""
    ev = _meta() + [
        _x("gpu_user_annotation", "d_update", 0, 1000, tid=7,
           External_id=5),
        _x("gpu_user_annotation", "d_update", 500, 1000, tid=8,
           External_id=5),
        _x("gpu_user_annotation", "g_update", 2000, 400, tid=7,
           External_id=6),
        _x("kernel", "k1", 0, 1000, tid=7),
        _x("kernel", "k2", 500, 1000, tid=8),
        _x("kernel", "k3", 2000, 400, tid=7)]
    path = _write(tmp_path / "t.json.gz", ev)
    d = trace.digest(path)
    assert d["compute_ms"] == pytest.approx(1.9)
    assert d["span_ms"] == pytest.approx(2.4)
    assert d["idle_gap_ms"] == pytest.approx(0.5)
    rows = {r["program"]: (r["n"], r["ms_median"]) for r in d["rows"]}
    assert rows == {"d_update": (1, 1.5), "g_update": (1, 0.4)}
    # the pipelined step: the stages' medians summed
    assert trace.stage_step_ms(d) == pytest.approx(1.9)
    assert trace.devstep_ms(path) == pytest.approx(1.5)
    assert trace.devstep_ms(path, per_exec=3) == pytest.approx(0.5)


def test_digest_collective_overlapping_compute(tmp_path):
    """An NCCL kernel on its own stream half under a compute kernel:
    collective_ms its span, overlap_frac the share under compute."""
    ev = _meta() + [
        _x("gpu_user_annotation", "train_step", 0, 800, External_id=1),
        _x("kernel", "void gemm_kernel()", 0, 500, tid=7),
        _x("kernel", "ncclDevKernel_AllReduce_Sum_f32_RING_LL()", 200, 600,
           tid=9)]
    d = trace.digest(_write(tmp_path / "t.json.gz", ev))
    assert d["compute_ms"] == pytest.approx(0.8)
    assert d["collective_ms"] == pytest.approx(0.6)
    assert d["overlap_frac"] == pytest.approx(0.5)
    assert d["idle_gap_ms"] == 0.0


def test_select_tracks_without_annotations_and_empty(tmp_path):
    """Device ops without annotations: the ops are the programs; a trace
    of metadata only (or of host ops only) is "none"."""
    ev = _meta() + [_x("kernel", "k", 0, 10), _x("kernel", "k", 20, 10)]
    programs, ops, source = trace.select_device_tracks(ev)
    assert source == "gpu" and programs == ops and len(ops) == 2
    host_only = _meta() + [_x("cpu_op", "aten::mm", 0, 5, pid=HOST)]
    assert trace.select_device_tracks(host_only) == ([], [], "none")
    d = trace.digest(_write(tmp_path / "e.json.gz", _meta()))
    assert d["source"] == "none" and d["rows"] == [] and \
        d["compute_ms"] == 0.0
    assert trace.devstep_ms(str(tmp_path / "e.json.gz")) is None


def _cpu_capture(tmp_path):
    """A real torch.profiler CPU capture: three train_step ranges of a
    few ops each, and one sampler range, through the trainer's trace
    handler."""
    from dcgan_tpu_torch.utils.profiling import TraceCapture

    tc = TraceCapture(str(tmp_path / "tr"), start_step=0, num_steps=1)
    x = torch.randn(32, 32)
    tc.maybe_start(0)
    tc.maybe_stop(1)                  # the window's warm-up call
    for _ in range(3):
        with torch.profiler.record_function("train_step"):
            (x @ x).relu().sum()
    with torch.profiler.record_function("sampler"):
        x.tanh()
    tc.maybe_stop(2)
    return trace.find_trace(str(tmp_path / "tr"))


def test_digest_of_a_real_cpu_capture(tmp_path):
    path = _cpu_capture(tmp_path)
    d = trace.digest(path)
    assert d["source"] == "cpu"
    assert (d["program"], d["program_n"]) == ("train_step", 3)
    assert {r["program"] for r in d["rows"]} == {"train_step", "sampler"}
    assert d["compute_ms"] > 0 and d["span_ms"] >= d["compute_ms"]
    rows, source = trace.summarize(path)
    assert source == "cpu" and rows == d["rows"]


def _tool():
    spec = importlib.util.spec_from_file_location(
        "trace_summary_torch", ROOT / "tools" / "trace_summary_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_summary_tool_prints_rows_and_names_the_track(tmp_path, capsys):
    path = _cpu_capture(tmp_path)
    assert _tool().main([str(tmp_path / "tr")]) == 0
    out, err = capsys.readouterr()
    rows = [json.loads(line) for line in out.splitlines()]
    assert rows == trace.summarize(path)[0]
    assert "cpu track" in err
    gpu = _write(tmp_path / "g.json.gz", _meta() + [
        _x("gpu_user_annotation", "train_step", 0, 100, External_id=1),
        _x("kernel", "k", 0, 100)])
    assert _tool().main([gpu]) == 0
    out, err = capsys.readouterr()
    assert json.loads(out)["program"] == "train_step"
    assert "gpu track" in err


def test_summary_tool_fails_without_duration_events(tmp_path, capsys):
    empty = _write(tmp_path / "e.pt.trace.json.gz", _meta())
    tool = _tool()
    assert tool.main([empty]) == 1
    assert "no duration events" in capsys.readouterr().err
    assert tool.main([str(tmp_path / "missing")]) == 1
    assert tool.main([]) == 2
    assert os.path.exists(empty)
