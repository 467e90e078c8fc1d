"""Captured programs: a function recorded once as a CUDA graph and replayed,
the port's counterpart of a JAX program compiled ahead of its dispatch.

A `CapturedProgram` wraps a function of no arguments that reads its inputs
from static tensors its owner keeps (the train state, image and z slots, a
sampler's z) and returns its outputs. On a CUDA device `capture()` records
the function into a `torch.cuda.CUDAGraph` with a private memory pool, and
`run()` replays it: the same kernels with the same arguments, so a replay
gives the same bits as the eager call it was captured from, as long as the
static inputs keep their addresses (the TMA descriptors of kernels 4 and 5,
encoded on the host from the operands' addresses, are baked into the
graph). On the CPU, where CUDA graphs do not exist, `run()` calls the
function eagerly over the same static buffers, so the CPU tests drive every
path but the capture itself.

The function must have run once eagerly on the same device and stream
before its capture (the owner's warm-up, inside `on_stream`): that builds
the kernels, creates the kernels' tickets, lets cuDNN and cuBLAS pick
their algorithms and set up their workspaces for the stream, and makes
each first-time CUDA runtime call (`cudaFuncSetAttribute`,
`cudaGetDriverEntryPoint`) that the capturing thread may not make. The
capture runs in the
`thread_local` mode: the capturing thread may make no call that is unsafe
under capture (a host synchronization in the function fails the
capture), while the data feed's producer and the checkpoint writer go on
with their own CUDA calls on their threads. A capture that fails raises;
nothing falls back to eager dispatch on a CUDA device.

The kernel wrappers count their launches in Python (`.launches`,
`.launches_by_design`), which a replay does not run. So the counts a
capture adds are taken back after it and added again at every replay:
a replayed program counts as the eager calls it was captured from.
Replays run on the dispatch threads of several serve replicas at once, so
`add_counts` updates the counters under one lock.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

Counts = Dict[str, Tuple[int, Dict[str, int]]]

# guards the wrappers' counters against replays on several threads
_COUNTS_LOCK = threading.Lock()


def kernel_wrappers() -> Dict[str, Callable]:
    """The eight kernel wrappers, whose `.launches` count their launches."""
    from dcgan_tpu_torch.ops.flash_attention import flash_dkv, flash_dq, \
        flash_fwd
    from dcgan_tpu_torch.ops.fused import gemm_bias_moments, \
        gemm_bias_scale_act
    from dcgan_tpu_torch.ops.kernels import channel_moments, \
        scale_shift_act, scale_shift_act_bwd

    return {"channel_moments": channel_moments,
            "scale_shift_act": scale_shift_act,
            "scale_shift_act_bwd": scale_shift_act_bwd,
            "gemm_bias_moments": gemm_bias_moments,
            "gemm_bias_scale_act": gemm_bias_scale_act,
            "flash_fwd": flash_fwd, "flash_dq": flash_dq,
            "flash_dkv": flash_dkv}


def launch_counts() -> Counts:
    """{wrapper: (launches, launches by design)} now."""
    return {name: (fn.launches, dict(getattr(fn, "launches_by_design", {})))
            for name, fn in kernel_wrappers().items()}


def counts_delta(after: Counts, before: Counts) -> Counts:
    return {name: (n - before[name][0],
                   {d: c - before[name][1].get(d, 0)
                    for d, c in by.items()})
            for name, (n, by) in after.items()}


def add_counts(delta: Counts, times: int = 1) -> None:
    """Add `times` x `delta` to the wrappers' counters (one thread at a
    time: `+=` on an attribute is a read, an add and a write)."""
    wrappers = kernel_wrappers()
    with _COUNTS_LOCK:
        for name, fn in wrappers.items():
            n, by = delta[name]
            fn.launches += times * n
            by_design = getattr(fn, "launches_by_design", None)
            for design, c in by.items():
                by_design[design] += times * c


@contextlib.contextmanager
def on_stream(stream: Optional["torch.cuda.Stream"]):
    """Run the block on `stream` (a capture stream), ordered after the
    work queued so far on the current stream and before what follows; a
    no-op for None (the CPU)."""
    if stream is None:
        yield
        return
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        yield
    current.wait_stream(stream)


class CapturedProgram:
    """One function of static buffers, captured as a CUDA graph on a CUDA
    device and replayed by `run()`; run eagerly on the CPU."""

    def __init__(self, name: str, fn: Callable[[], Any],
                 device: torch.device,
                 stream: Optional["torch.cuda.Stream"] = None):
        self.name = name
        self.fn = fn
        self.device = device
        self.stream = stream
        self.outputs: Any = None
        self.graph = None
        self.capture_ms: Optional[float] = None
        self.pool_bytes = 0          # device memory reserved by the capture
        self.launches: Optional[Counts] = None  # kernel launches recorded

    @property
    def captured(self) -> bool:
        return self.capture_ms is not None

    def capture(self) -> float:
        """Record the function (on a CUDA device); returns the ms it took.
        On the CPU there is nothing to record and the time is the
        bookkeeping's alone."""
        if self.captured:
            raise RuntimeError(f"{self.name} is captured already")
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            before = launch_counts()
            # the collector stays off while the capture runs: a graph it
            # destroyed there (a dropped owner's) would invalidate the
            # capture
            collecting = gc.isenabled()
            # torch.cuda.graph empties the cache too; emptied first, the
            # growth of the reserved bytes is the graph's private pool
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            graph = torch.cuda.CUDAGraph()
            gc.disable()
            try:
                with torch.cuda.graph(graph, stream=self.stream,
                                      capture_error_mode="thread_local"):
                    self.outputs = self.fn()
            finally:
                if collecting:
                    gc.enable()
            torch.cuda.synchronize(self.device)
            self.launches = counts_delta(launch_counts(), before)
            # the capture launched nothing: its counts come back at every
            # replay
            add_counts(self.launches, -1)
            self.pool_bytes = torch.cuda.memory_reserved(self.device) \
                - reserved
            self.graph = graph
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        return self.capture_ms

    def run(self) -> Any:
        """One replay (the eager call on the CPU); returns the outputs,
        which the next run overwrites."""
        if not self.captured:
            raise RuntimeError(f"{self.name} is not captured")
        if self.graph is None:
            self.outputs = self.fn()
        else:
            self.graph.replay()
            add_counts(self.launches)
        return self.outputs

    def release(self) -> None:
        """Drop the graph, its outputs and the function. The function's
        closure usually refers to the program's owner, which holds the
        program: a cycle that only the garbage collector would break, and
        until then the graph's private pool stays reserved on the device.
        Released, the program is not captured and cannot run."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = None
        self.outputs = None
        self.fn = None
        self.capture_ms = None
