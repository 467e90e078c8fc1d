"""The training loop (the single-device core of
`dcgan_tpu/train/trainer.py`):

- the checkpoint directory first: a `config.json` there of another
  architecture fails the run (with the JAX trainer's message) once the
  directory holds a checkpoint, then this run's `config.json` is written
  in the JAX package's schema;
- seeded init, then `Checkpointer.restore_latest`: a run on a directory
  with checkpoints continues from the newest intact step;
- the data: TFRecord shards from `data_dir` through the native C++ loader
  and the device prefetcher (data/pipeline.py; the record dtype of the
  shards' dataset.json wins over the config's), or the synthetic stream copied
  host -> pinned -> device, which restarts at batch 0 on a resume as the
  JAX trainer's does; a conditional model's feed yields (images, labels)
  pairs, the records' `label_feature` range-checked against num_classes
  on the host (`dcgan_tpu/train/trainer.py:112-113,149-159,240-241`);
- the z of the step that takes the state from step s to s + 1 comes from a
  generator seeded from (seed, s), as the JAX trainer folds s into its
  base key, so a resumed run draws the z an unbroken run draws; the
  step's other draws (`steps.draw_step`: the critic iterations' z,
  WGAN-GP's interpolation weights, the augmentations) come from the same
  generator after z (`step_inputs`), so a run without them draws today's z;
  under pipeline_gd the stage programs' draws come from that generator
  instead (`stage_inputs`, `steps.draw_stages`);
- the steps through `StepRunner` (train/warmup.py): captured CUDA graphs
  over a static state on the card (eager on the CPU), `steps_per_call`
  steps per call where aligned, with one loss readback per call;
  `--aot_warmup` captures every program after the first (eager) step and
  writes their capture times as a `perf/compile_ms/<row>` event; under
  pipeline_gd each step is the runner's three stage rows, driven by its
  GDPipeline (train/gd_pipeline.py), which drains at a stop and at the end;
- the NaN gate: every `nan_check_steps` steps (each step of a call that
  falls on the cadence) the step's metrics must be finite, or the run
  raises `FloatingPointError` with the step, before that step is
  checkpointed (`dcgan_tpu/train/trainer.py:1162-1198`, the abort policy);
  under `nan_policy="rollback"` (train/rollback.py) a trip instead copies
  the last gate-verified snapshot (taken every `rollback_snapshot_steps`
  steps on the device, the gate forced on the snapshot's step) back into
  the runner's static state, drops the checkpoints saved after it, writes
  `anomaly/rollbacks` at the failing step, refills the LR backoff's rate
  cells and folds the rollback count into the step draws' seeds; the data
  iterator is not rewound, a pipelined run drains its fake stack first,
  and nothing is captured again. Past `max_rollbacks` the run raises
  `RollbackExhausted` (`dcgan_tpu/train/trainer.py:1235-1316`);
- the flight recorder (train/flight_recorder.py): one record per step
  (losses, gate verdict, step and host ms, the counter registry's
  snapshot) in a ring of `flight_recorder_steps`, dumped as
  `<checkpoint_dir>/flight_recorder.jsonl` on a NaN abort, a stop, a
  watchdog trip and an uncaught exception;
- the watchdog (`collective_timeout_secs` > 0, train/coordination.py): a
  deadline on each call's dispatch and readback (not on a call that
  captures a program), on the rollback restore and on the saves; a trip
  dumps the ring and every thread's stack and exits 43;
- the host services (train/services.py, `async_services`): every
  MetricWriter call and the grid's PNG run on one worker thread, fed by
  host copies the dispatch thread starts (`services.stage`), drained at
  each save and at the end; `async_services=False` runs them inline;
- the chaos hooks (testing/chaos.py, `DCGAN_CHAOS`): a poisoned gate
  view, a SIGTERM to self and a hang inside the guarded window;
- SIGTERM and SIGINT (train/coordination.py): the loop stops at the next
  call boundary, and the final checkpoint is written as at the end of a
  run, so a preemption resumes where it stopped;
- a `scalars` event every `log_every_steps` steps in the JAX package's
  JSONL format (`<checkpoint_dir>/events.jsonl`: d_loss, d_loss_real,
  d_loss_fake, g_loss and StepTimer's perf/* keys over the last
  `timing_window` steps; data/corrupt_records
  once nonzero), mirrored into TensorBoard files;
- every `sample_every_steps` steps a grid PNG of the samples of the fixed
  `sample_z` (drawn once from seed + 1; a conditional model's row i of
  class i mod K) in `sample_dir`, and an image event;
  then the loss probe (`eval_losses`) on a held-out batch, the synthetic
  stream at seed + 100 or the TFRecord shards of `sample_image_dir` when
  that directory exists (none otherwise), with the fixed z, written as
  `sample/*` scalars (`dcgan_tpu/train/trainer.py:250-290, 1769-1800`);
- every `fid_every_steps` steps the surrogate FID/KID probe
  (train/fid_probe.py): `fid_num_samples` images of the live state
  through the runner's captured `fid_sampler` row, scored against a real
  side computed once from the held-out stream, written as `eval/fid` and
  `eval/kid`, the best-scoring state kept in `<checkpoint_dir>/best`
  with its `score.json`; a resumed run fast-forwards the held-out stream
  past the batches the run before it consumed (`held_out_skip`: the loss
  probes' and the real side's) and reads its best score back;
- every `activation_summary_steps` steps an "activations" event of
  `summarize` on the call's last batch (z from (seed, step, 1));
- under a precision policy, a `perf/precision/policy` (f32 0, bf16 1, fp8
  2) and `perf/precision/master_f32_leaves` row at the first log;
- `maybe_save` after every call (every `save_model_secs` of wall clock),
  the next step waiting on the device for the save's host copy of the
  static state; a final save of the last step and a wait for it to be on
  disk;
- a progressive schedule (`progressive`, progressive/): the run starts in
  the phase that produced the newest checkpoint, whose manifest's phase
  tag must agree, and trains each phase with its own step functions,
  runner and feed; at a phase boundary (never inside a call) the JAX
  trainer's switch (`dcgan_tpu/train/trainer.py:1526-1586`): the writer
  flushed, the pipeline drained, the state carried onto the next phase's
  runner, the checkpoints' tag moved on, the feeds re-opened at the new
  resolution (`{res}` in the data directories), a fresh StepTimer; the
  line `progressive phase i at step s: rA -> rB (batch b, n leaves
  carried) switch_ms=... captures_during_switch=0` after the new phase's
  first call (the graphs captured from the switch's start through that
  call), and a `progressive/switch_ms` row. With --aot_warmup every later
  phase's runner is warmed on zeros and its rows captured at startup
  (`<row>@r<res>`), so a switch captures nothing; without it the runner
  of a phase is built at its switch. The old phase's runner is closed
  once the boundary step's save has copied its state. Inside a fade
  window the real batch is blended (`PhaseRuntime.fade_images`); the log
  rows carry `progressive/phase`, `progressive/resolution` and
  `progressive/alpha`, none for a one-phase schedule;
- the startup breakdown (utils/profiling.py::StartupProfile): the
  `data`, `init`, `restore` and `warmup` phases and the time to the
  first call's readback, printed as the `startup` line with the
  restore's verify stats, and written as a `perf/startup/*` row under
  --aot_warmup (the JAX trainer's warm-start gate; the port has no
  compile cache); a run that dies before its first step dumps the phases
  it completed as the flight record's `startup_partial`;
- trace capture (utils/profiling.py::TraceCapture): a torch.profiler
  window of `profile_num_steps` steps at `profile_start_step` (counted
  from the step the run starts at) when `profile_dir` is set, and one
  at the next call boundary after each touch of `profile_trigger` (the
  file deleted at the window's end; traces in `profile_dir`, else
  `<checkpoint_dir>/trace`). The window opens before a call's dispatch
  with a warm-up call whose events are dropped, records the next
  `profile_num_steps` steps and closes after a readback, the device
  synchronized; the stop writes the trace on the dispatch thread, which
  also finds the file; the services worker digests it (utils/trace.py)
  into a `perf/device/*` row at the window's last step and the `trace
  digest` line (with the stop's ms, the file's bytes and the digest's
  seconds). The step time
  is the busiest program's median over the largest call size in the
  window, or under pipeline_gd the sum of the `d_update` and `g_update`
  medians. A window may span a graph capture (a runner's first calls, a
  progressive switch without --aot_warmup): the window stays open, and
  on an H100 a run whose window spanned the warm-up and both captures
  ended with the parameters of an unprofiled run, bit for bit;
- data parallelism over processes (`dcgan_tpu/train/trainer.py:117-272,
  318-447`): the process joins the world its environment names
  (parallel/distributed.py) and runs `make_parallel_train`'s per-rank
  programs on its share of every global batch (its shards on seed + its
  rank, its rows of the step's draws or its own folded draws); the
  losses it reads are the global ones, so every rank takes the same
  decisions; only the chief (rank 0) writes config.json, events, grids,
  checkpoints and traces, and the ranks agree on the checkpoint they
  restore. Above one rank the FID probe and the rollback NaN policy are
  refused by name (`check_world`). On a spatial mesh (`--mesh_model N
  --mesh_spatial`) the ranks of one model group read one data index's
  share (parallel/api.py::data_shard) and the step splits its rows
  (parallel/spatial.py). A world whose collectives run over gloo on CUDA
  ranks (ranks sharing one card) cannot be captured: its runner runs
  every step eagerly, and the chief says so. Over NCCL (one card per
  rank) the runner captures the step with its collectives; for a
  spatial step that means P2P and all_to_all inside a CUDA graph, which
  has not yet run on several cards nor been held against the eager step.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import pprint
import socket
import time
from typing import Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from dcgan_tpu_torch.config import TrainConfig, load_config, save_config
from dcgan_tpu_torch.data import quarantine
from dcgan_tpu_torch.data.pipeline import DataConfig, make_dataset, \
    read_manifest
from dcgan_tpu_torch.data.synthetic import synthetic_batches
from dcgan_tpu_torch.device import resolve_device
from dcgan_tpu_torch.parallel.api import data_shard, local_config, \
    make_parallel_train
from dcgan_tpu_torch.parallel.distributed import World, initialize_multihost
from dcgan_tpu_torch.progressive import PhaseRuntime, Rebucketer, \
    parse_schedule
from dcgan_tpu_torch.progressive.phases import PHASE_SEED_OFFSET
from dcgan_tpu_torch.testing import chaos
from dcgan_tpu_torch.train.coordination import CoordinatedStop, \
    make_watchdog
from dcgan_tpu_torch.train.fid_probe import NEEDS_HELD_OUT, FidProbe, \
    held_out_skip
from dcgan_tpu_torch.train.flight_recorder import FlightRecorder, \
    recorder_path
from dcgan_tpu_torch.train.rollback import RollbackManager
from dcgan_tpu_torch.train.services import make_services, stage
from dcgan_tpu_torch.train.steps import draw_stages, draw_step, \
    step_generator, tree_leaves
from dcgan_tpu_torch.train.warmup import StepRunner, aot_capture, \
    build_warmup_plan, call_size, metric_keys
# the losses' keys, re-exported for the trainer's callers
from dcgan_tpu_torch.train.warmup import METRIC_KEYS  # noqa: F401
from dcgan_tpu_torch.utils.checkpoint import Checkpointer
from dcgan_tpu_torch.utils.images import save_sample_grid
from dcgan_tpu_torch.utils.metrics import CounterRegistry, MetricWriter
from dcgan_tpu_torch.utils.profiling import StartupProfile, StepTimer, \
    TraceCapture
from dcgan_tpu_torch.utils.trace import digest, find_trace, stage_step_ms

Pytree = dict


# the generator of a step's draws (train/steps.py; the trainer's name)
_step_generator = step_generator


def _draw_z(cfg: TrainConfig, gen: torch.Generator) -> torch.Tensor:
    return torch.rand((cfg.batch_size, cfg.model.z_dim), generator=gen,
                      device=gen.device) * 2.0 - 1.0


def step_inputs(cfg: TrainConfig, step: int, device: torch.device,
                rekey: int = 0
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(z, draws) of the step that takes the state from `step` to
    `step + 1`, from one generator seeded from (cfg.seed, step) and, after
    `rekey` > 0 rollbacks, the rollback count: U(-1, 1) z [batch, z_dim]
    first, then the step's other draws (`steps.draw_step`; empty for a
    config that draws nothing else)."""
    gen = _step_generator(cfg, step, device, rekey=rekey)
    z = _draw_z(cfg, gen)
    return z, draw_step(cfg, gen)


def stage_inputs(cfg: TrainConfig, step: int, device: torch.device,
                 rekey: int = 0) -> Dict[str, torch.Tensor]:
    """The stage programs' draws (`steps.draw_stages`) of the pipelined
    step from state step `step`, from the generator of `step_inputs`."""
    return draw_stages(cfg, _step_generator(cfg, step, device, rekey=rekey))


def check_finite(cfg: TrainConfig, step: int, values: Dict[str, float]
                 ) -> None:
    """The NaN gate of the step that reached `step`: raises
    FloatingPointError (with `.step`) if a metric is not finite, with the
    JAX trainer's message."""
    if all(np.isfinite(v) for v in values.values()):
        return
    err = FloatingPointError(
        f"non-finite training metrics at step {step}: {values} — inspect "
        f"the last checkpoint in {cfg.checkpoint_dir}")
    err.step = step
    raise err


def summary_z(cfg: TrainConfig, step: int, device: torch.device,
              rekey: int = 0) -> torch.Tensor:
    """The z of `summarize` at step `step`, from (cfg.seed, step, 1) (and
    the rollback count, as in step_inputs)."""
    return _draw_z(cfg, _step_generator(cfg, step, device, 1, rekey=rekey))


def _synthetic_feed(cfg: TrainConfig, device: torch.device,
                    skip_batches: int = 0) -> Iterator:
    """The synthetic stream on `device` from its batch `skip_batches`
    (skipped on the host): image batches, or (images, labels) pairs for a
    conditional model; cfg.batch_size and cfg.seed are the rank's."""
    mcfg = cfg.model
    batches = synthetic_batches(cfg.batch_size, mcfg.output_size,
                                mcfg.c_dim, seed=cfg.seed,
                                num_classes=mcfg.num_classes)
    for batch in itertools.islice(batches, skip_batches, None):
        out = tuple(torch.from_numpy(a) for a in
                    (batch if isinstance(batch, tuple) else (batch,)))
        if device.type == "cuda":
            out = tuple(t.pin_memory().to(device, non_blocking=True)
                        for t in out)
        yield out if isinstance(batch, tuple) else out[0]


def split_batch(cfg: TrainConfig, batch
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A feed's batch as (images, labels): labels None for an
    unconditional model."""
    if cfg.model.num_classes:
        return batch
    return batch, None


def make_data(cfg: TrainConfig, device: torch.device, *,
              synthetic_data: bool = False, data_dir: Optional[str] = None,
              seed_offset: int = 0, n_threads: Optional[int] = None,
              min_after_dequeue: Optional[int] = None,
              skip_batches: int = 0, world: Optional[World] = None
              ) -> Iterator:
    """The trainer's batches on `device`: the synthetic stream, or the
    TFRecord shards of `data_dir` (cfg.data_dir by default; the native
    loader; the record dtype of their dataset.json, when they have one),
    seeded from cfg.seed + seed_offset; (images, labels) pairs for a
    conditional model. `skip_batches` fast-forwards past batches an
    earlier run consumed: the synthetic stream skips on the host, the
    shards' stream discards batches (a threaded shuffle stream has no
    exact position to restore). Close it when done.

    In a `world` of processes every rank reads its data index's share of
    the shards on seed + that index, in batches of its share of
    cfg.batch_size (the global batch); the synthetic stream likewise. On
    a spatial mesh the ranks of one model group read the same batches
    (parallel/api.py::data_shard)."""
    shard = (0, 1)
    if world is not None and world.size > 1:
        shard = data_shard(cfg, world)
        cfg = dataclasses.replace(
            local_config(cfg, shard[1]),
            seed=cfg.seed + shard[0] if synthetic_data else cfg.seed)
    if seed_offset:
        cfg = dataclasses.replace(cfg, seed=cfg.seed + seed_offset)
    if synthetic_data:
        return _synthetic_feed(cfg, device, skip_batches)
    data_dir = cfg.data_dir if data_dir is None else data_dir
    # the manifest's wire format is authoritative; cfg.record_dtype covers
    # shards without one
    wire_dtype = read_manifest(data_dir).get("record_dtype",
                                             cfg.record_dtype)
    if wire_dtype != cfg.record_dtype:
        print(f"[dcgan_tpu_torch] adopting record_dtype={wire_dtype!r} "
              f"from {data_dir}/dataset.json (config said "
              f"{cfg.record_dtype!r})", flush=True)
    dcfg = DataConfig(
        data_dir=data_dir, image_size=cfg.model.output_size,
        channels=cfg.model.c_dim, batch_size=cfg.batch_size,
        record_dtype=wire_dtype,
        min_after_dequeue=(cfg.shuffle_buffer if min_after_dequeue is None
                           else min_after_dequeue),
        n_threads=(cfg.num_loader_threads if n_threads is None
                   else n_threads),
        seed=cfg.seed, normalize=cfg.normalize_inputs,
        label_feature=cfg.label_feature if cfg.model.num_classes else "",
        num_classes=cfg.model.num_classes,
        prefetch_device_batches=cfg.prefetch_device_batches,
        max_corrupt_records=cfg.max_corrupt_records)
    ds = make_dataset(dcfg, device, process_index=shard[0],
                      process_count=shard[1])
    for _ in range(skip_batches):
        next(ds)
    return ds


def make_sample_data(cfg: TrainConfig, device: torch.device, *,
                     synthetic_data: bool = False,
                     skip_batches: int = 0,
                     world: Optional[World] = None) -> Optional[Iterator]:
    """The held-out batches of the loss probe and of the FID probe's real
    side: the synthetic stream at seed + 100, or the shards of
    cfg.sample_image_dir (a light loader: 2 threads, a pool of 4 batches)
    when that directory exists; None otherwise (no probe, as in the JAX
    trainer). `skip_batches` as in make_data."""
    if synthetic_data:
        return make_data(cfg, device, synthetic_data=True, seed_offset=100,
                         skip_batches=skip_batches, world=world)
    if os.path.isdir(cfg.sample_image_dir):
        return make_data(cfg, device, data_dir=cfg.sample_image_dir,
                         seed_offset=100, n_threads=2,
                         min_after_dequeue=4 * cfg.batch_size,
                         skip_batches=skip_batches, world=world)
    return None


def eval_z_of(sample_z: torch.Tensor, batch: int) -> torch.Tensor:
    """The loss probe's fixed z: sample_z's rows, cycled to `batch` (the
    JAX trainer's `jnp.resize`)."""
    n, z_dim = sample_z.shape
    return sample_z.reshape(-1).repeat(-(-batch // n))[
        :batch * z_dim].reshape(batch, z_dim)


def grid_labels(n: int, num_classes: int, device: torch.device
                ) -> Optional[torch.Tensor]:
    """The labels of the sample grid's n rows, arange(n) % K (the JAX
    trainer's, `dcgan_tpu/train/trainer.py:577-580`); None for an
    unconditional model."""
    if not num_classes:
        return None
    return torch.arange(n, dtype=torch.int32, device=device) % num_classes


def master_f32_leaves(state: Pytree) -> int:
    """The f32 Adam first moments whose parameter is narrower (the bf16
    and fp8 policies' master moments)."""
    n = 0
    for net in ("gen", "disc"):
        for mu, p in zip(tree_leaves(state["opt"][net]["mu"]),
                         tree_leaves(state["params"][net])):
            if mu.dtype == torch.float32 and p.element_size() < 4:
                n += 1
    return n


def _check_architecture(cfg: TrainConfig, ckpt: Checkpointer) -> None:
    """A resume with another architecture fails here with a readable
    message, not as a tree mismatch inside the restore. Only a directory
    that holds a checkpoint counts: a config.json of a run that died
    before its first save does not claim it."""
    saved = load_config(cfg.checkpoint_dir)
    if saved is None or ckpt.latest_step() is None \
            or saved.model == cfg.model:
        return
    changed = {f.name: (getattr(saved.model, f.name),
                        getattr(cfg.model, f.name))
               for f in dataclasses.fields(cfg.model)
               if getattr(saved.model, f.name) != getattr(cfg.model, f.name)}
    raise ValueError(
        f"checkpoint_dir {cfg.checkpoint_dir!r} holds a run with a "
        f"different architecture (saved != requested): {changed}. "
        "Resume without architecture flags (the config.json is "
        "adopted), or point --checkpoint_dir at a fresh directory.")


def _flight_context(cfg: TrainConfig, startup: StartupProfile,
                    process: int = 0) -> dict:
    """The flight recorder's dump-time header context; a run that died
    before its first step carries the startup phases it completed."""
    out = {"process": process}
    if cfg.precision:
        out["precision"] = cfg.precision
    if not startup.done:
        out["startup_partial"] = {k: round(v, 1) for k, v in
                                  startup.summary().items()}
    return out


class _NullWriter:
    """The MetricWriter of a rank other than the chief: it writes
    nothing (the chief alone writes events, grids and traces)."""

    def write_scalars(self, step: int, row: dict) -> None:
        pass

    def write_image_event(self, step: int, tag: str, path: str) -> None:
        pass

    def write_activations(self, step: int, stats) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


# what the port's data parallelism does not run yet, at world size > 1
WORLD_UNPORTED = {
    "fid_every_steps": "--fid_every_steps at world size > 1: the probe's "
                       "real side split over the ranks and its multi-"
                       "process scoring are not ported to dcgan_tpu_torch "
                       "yet (ROADMAP Queue A item 7)",
    "nan_policy": "--nan_policy rollback at world size > 1: the anomaly "
                  "consensus and the coordinated rollback over ranks are "
                  "not ported to dcgan_tpu_torch yet (ROADMAP Queue A item "
                  "9b)",
}


def check_world(cfg: TrainConfig, world: World) -> None:
    """Refuse, naming its ROADMAP item, a setting the port runs in one
    process only."""
    if world.size <= 1:
        return
    if cfg.fid_every_steps:
        raise NotImplementedError(WORLD_UNPORTED["fid_every_steps"])
    if cfg.nan_policy == "rollback":
        raise NotImplementedError(WORLD_UNPORTED["nan_policy"])


class _QueuedWriter:
    """The MetricWriter's `write_scalars` through the services queue, for
    the FID probe, which runs on the dispatch thread."""

    def __init__(self, svc, writer: MetricWriter):
        self._svc = svc
        self._writer = writer

    def write_scalars(self, step: int, row: dict) -> None:
        self._svc.submit(lambda s=step, r=dict(row):
                         self._writer.write_scalars(s, r),
                         tag="fid-scalars")


def train(cfg: TrainConfig, *, synthetic_data: bool = False,
          max_steps: Optional[int] = None,
          device: Union[str, torch.device] = "cuda") -> Pytree:
    """Train `cfg` on `device` until the state reaches step `max_steps`
    (cfg.max_steps when None), resuming from the newest intact checkpoint
    in cfg.checkpoint_dir, or until SIGTERM or SIGINT stops it at a call
    boundary; either way the last step is checkpointed. Returns the final
    state. A run that dies (a NaN abort, an exhausted rollback budget, any
    exception) leaves the flight recorder's dump in its checkpoint
    directory, if it had written there.

    The process joins the data-parallel world its environment names
    (torchrun's RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR /
    MASTER_PORT, or JAX_COORDINATOR_ADDRESS; parallel/distributed.py) and
    trains its share of every global batch on `device` (an unindexed
    "cuda" is cuda:LOCAL_RANK); a process that names no world trains
    alone, as before."""
    # the time to the first step is profiled from here
    startup = StartupProfile()
    # raises before anything else when the card is missing
    resolve_device(device)
    world = initialize_multihost(device=device)
    check_world(cfg, world)
    flight = FlightRecorder(
        recorder_path(cfg.checkpoint_dir, world.rank),
        capacity=cfg.flight_recorder_steps,
        context=lambda: _flight_context(cfg, startup, world.rank))
    try:
        return _train(cfg, synthetic_data=synthetic_data,
                      max_steps=max_steps, world=world, flight=flight,
                      startup=startup)
    except BaseException as e:
        # a run that failed before it wrote its checkpoint directory (no
        # card, a data_dir without shards) leaves nothing there
        if os.path.isdir(cfg.checkpoint_dir):
            flight.dump("nan-abort" if isinstance(e, FloatingPointError)
                        else "exception",
                        step=getattr(e, "step", None),
                        extra={"error": repr(e)[:500]})
        raise


def _train(cfg: TrainConfig, *, synthetic_data: bool,
           max_steps: Optional[int], world: World,
           flight: FlightRecorder, startup: StartupProfile) -> Pytree:
    dev = world.device
    chief = world.is_chief
    total_steps = cfg.max_steps if max_steps is None else max_steps
    mcfg = cfg.model
    if cfg.fid_every_steps and not synthetic_data \
            and not os.path.isdir(cfg.sample_image_dir):
        raise ValueError(NEEDS_HELD_OUT)
    ckpt = Checkpointer(cfg.checkpoint_dir,
                        save_interval_secs=cfg.save_model_secs,
                        max_to_keep=cfg.max_checkpoints, world=world)
    _check_architecture(cfg, ckpt)
    # a progressive run: the phase that produced the newest checkpoint,
    # its tag checked (a schedule edited between runs fails here), and
    # that phase's config; pcfg is the current phase's config throughout
    prog = None
    pcfg = cfg
    if cfg.progressive:
        prog = PhaseRuntime(cfg, parse_schedule(
            cfg.progressive, model=mcfg, batch_size=cfg.batch_size,
            max_steps=cfg.max_steps, steps_per_call=cfg.steps_per_call,
            grad_accum=cfg.grad_accum,
            fade_steps=cfg.progressive_fade_steps), total_steps,
            world=world)
        latest = ckpt.latest_step()
        prog.start(latest)
        if latest is not None:
            prog.check_resume_tag(ckpt.progressive_tag_of(latest), latest)
        ckpt.progressive_tag = prog.tag()
        pcfg = prog.cfg
        if chief:
            print(f"[dcgan_tpu_torch] progressive schedule "
                  f"{cfg.progressive!r}: starting in phase {prog.index} "
                  f"(r{prog.resolution}, batch {pcfg.batch_size}, "
                  f"{prog.n_phases} phase(s) this run)", flush=True)
    # the world's per-rank programs of the current phase (pcfg), and the
    # rank's share of its batch (lcfg): what the feeds and the runner take
    par = make_parallel_train(cfg, world) if prog is None else prog.par
    lcfg = par.local_cfg
    # this run's quarantine count is the process-wide tally's delta, taken
    # before the loader starts; a data_dir without shards fails here,
    # before anything is written
    corrupt_base = quarantine.count()
    sample_data = None
    rebucketer = None
    if prog is None:
        with startup.phase("data"):
            data = make_data(cfg, dev, synthetic_data=synthetic_data,
                             world=world)
    else:
        # the phase's feeds, re-opened at every switch
        def open_phase(phase_cfg, held_out_skip):
            d = make_data(phase_cfg, dev, synthetic_data=synthetic_data,
                          world=world)
            if not cfg.sample_every_steps:
                return d, None
            try:
                return d, make_sample_data(
                    phase_cfg, dev, synthetic_data=synthetic_data,
                    skip_batches=held_out_skip, world=world)
            except BaseException:
                d.close()
                raise

        rebucketer = Rebucketer(open_phase)
        # the phase's held-out stream opened at its start: the loss probes
        # since then are the batches a resume skips
        done = latest or 0
        with startup.phase("data"):
            data, sample_data = rebucketer.open(pcfg, held_out_skip(
                pcfg, done) - held_out_skip(pcfg, prog.starts[prog.index]))
    writer = None
    runner = None
    trace = None
    # the runners of the phases after the current one, warmed and
    # captured at startup under --aot_warmup
    later_runners: Dict[int, StepRunner] = {}
    warm_ms: dict = {}
    # the telemetry tails' executor: in async mode every MetricWriter
    # call goes through it, so its one worker serializes them
    svc = make_services(cfg.async_services)
    # a deadline on each call's dispatch and readback, the rollback
    # restore and the save (off at collective_timeout_secs=0); a trip
    # dumps the flight recorder's ring beside the stacks
    watchdog = make_watchdog(
        cfg.collective_timeout_secs,
        pre_dump=lambda phase, step: flight.dump(
            "watchdog", step=step, extra={"phase": phase}))
    stop = CoordinatedStop()
    stop.install()
    try:
        if chief:
            pprint.pprint(dataclasses.asdict(cfg))
            save_config(cfg, cfg.checkpoint_dir)
            writer = MetricWriter(cfg.checkpoint_dir,
                                  every_secs=cfg.save_summaries_secs,
                                  tensorboard=cfg.tensorboard)
        else:
            writer = _NullWriter()

        def write_row(step: int, row: dict, tag: str) -> None:
            svc.submit(lambda s=step, r=row: writer.write_scalars(s, r),
                       tag=tag)

        # fixed z for comparable sample grids across the run, drawn once
        rows, cols = cfg.sample_grid
        n_samples = max(cfg.sample_size, rows * cols)

        def new_runner(phase_fns, phase_state, phase_cfg):
            # the rank's share of the phase's batch in every slot
            return StepRunner(phase_fns, phase_state,
                              local_config(phase_cfg, par.mesh.data), dev,
                              sample_z=sample_z, sample_labels=sample_labels)

        with startup.phase("init"):
            fns = par.fns
            state = fns.init(seed=cfg.seed, device=dev)
            sample_z = torch.rand(
                (n_samples, mcfg.z_dim), device=dev,
                generator=torch.Generator(device=dev).manual_seed(
                    cfg.seed + 1)) * 2.0 - 1.0
            # the grid's classes: row i of class i mod K
            sample_labels = grid_labels(n_samples, mcfg.num_classes, dev)
            runner = new_runner(fns, state, pcfg)
            if runner.eager and chief:
                print("[dcgan_tpu_torch] the step's collectives run over "
                      "gloo, which a CUDA graph cannot capture: every step "
                      "runs eagerly", flush=True)
        keys = metric_keys(cfg)
        eval_z = eval_z_of(sample_z, pcfg.batch_size)
        with startup.phase("restore"):
            restored = ckpt.restore_latest(state)
            if restored is not None:
                runner.load(restored)
        if restored is not None:
            del restored
            if chief:
                print(f"[dcgan_tpu_torch] restored checkpoint at step "
                      f"{int(state['step'])}", flush=True)
        if prog is None and (cfg.sample_every_steps or cfg.fid_every_steps):
            # the held-out stream from where the run that reached this
            # step left it
            with startup.phase("data"):
                sample_data = make_sample_data(
                    cfg, dev, synthetic_data=synthetic_data,
                    skip_batches=held_out_skip(cfg, int(state["step"])),
                    world=world)
        probe = FidProbe(cfg, dev) if cfg.fid_every_steps else None
        timer = StepTimer(window=cfg.timing_window,
                          images_per_step=pcfg.batch_size)
        t_start = time.time()
        logged_precision = False
        step_num = int(state["step"])
        switched = None      # the last switch's line, printed after the
                             # new phase's first call
        # NaN rollback-and-skip (train/rollback.py); None under the
        # default abort policy, so the snapshot costs nothing unless armed
        rollback = None
        if cfg.nan_policy == "rollback":
            rollback = RollbackManager(every=cfg.rollback_snapshot_steps,
                                       max_rollbacks=cfg.max_rollbacks,
                                       lr_backoff=cfg.rollback_lr_backoff)
            if cfg.pipeline_gd:
                # the in-flight fake stack was made by the weights the
                # rollback flees: dropped before the copy back
                def _drain_for_restore():
                    with watchdog.guard("pipeline-drain", step_num):
                        if runner.pipeline.drain("rollback"):
                            print("[dcgan_tpu_torch] rollback drained the "
                                  "in-flight pipelined fake stack (stale "
                                  "generator output; refilled from the "
                                  "restored state at the next dispatch)",
                                  flush=True)
                rollback.on_restore = _drain_for_restore
        # one read surface over the run's counters: the scalar rows'
        # recovery extras and the flight recorder's records
        registry = CounterRegistry()
        registry.provide("services_queue", svc.pending)
        registry.provide("services_dropped",
                         lambda: int(getattr(svc, "dropped", 0)))
        registry.provide("corrupt_records",
                         lambda: quarantine.count() - corrupt_base)
        if rollback is not None:
            registry.provide("rollbacks", lambda: rollback.rollbacks)
        if prog is not None:
            registry.provide("progressive_phase", lambda: prog.index)
        master_f32 = master_f32_leaves(state) if cfg.precision else 0
        if cfg.precision:
            registry.provide("master_f32_leaves", lambda: master_f32)

        def health_extras() -> dict:
            """The recovery counters of a scalars row, absent until
            nonzero, so a default run's rows carry neither."""
            c = registry.snapshot()
            out = {}
            if c.rollbacks:
                out["anomaly/rollbacks"] = c.rollbacks
            if c.corrupt_records:
                out["data/corrupt_records"] = c.corrupt_records
            return out

        def record(s: int, vals: dict, gate: str,
                   pipeline_phase: Optional[str]) -> None:
            """One flight-recorder record of the step that reached `s`."""
            if not flight.enabled:
                return
            rec = {"step": s, "time": time.time(), "gate": gate,
                   "step_ms": timer.last_step_ms,
                   "host_ms": timer.last_host_ms,
                   "metrics": dict(vals),
                   "counters": registry.snapshot().as_dict()}
            if pipeline_phase is not None:
                rec["pipeline"] = pipeline_phase
            flight.record(rec)

        def gate(s: int, vals: dict, force: bool,
                 pipeline_phase: Optional[str]) -> None:
            """The NaN gate of the step that reached `s` (every
            nan_check_steps steps, and when `force`d before a snapshot),
            and its flight-recorder record; the failing step is the
            ring's last record."""
            verdict = ""
            if force or (cfg.nan_check_steps
                         and s % cfg.nan_check_steps == 0):
                checked = dict(vals)
                if chaos.should_inject_nan(s):
                    checked["d_loss"] = float("nan")
                try:
                    check_finite(cfg, s, checked)
                except FloatingPointError:
                    record(s, vals, "trip", pipeline_phase)
                    raise
                verdict = "ok"
            record(s, vals, verdict, pipeline_phase)

        # the rollbacks so far, folded into the step draws' seeds when > 0
        # (the draw functions re-keyed with it)
        rekey = 0
        step_draws = par.step_draws(step_inputs)
        stage_draws = par.stage_draws(stage_inputs)
        rank_summary_z = par.summary_z(summary_z)

        def do_rollback(e: FloatingPointError) -> None:
            """Restore the snapshot into the static state (raises
            RollbackExhausted past the budget), drop the checkpoints saved
            inside the poisoned window, write anomaly/rollbacks, apply the
            LR backoff and re-key the step draws. The data iterator is not
            rewound: the offending batch window is skipped."""
            nonlocal step_num, rekey, step_draws, stage_draws, \
                rank_summary_z
            fail_step = getattr(e, "step", step_num)
            watchdog.arm("rollback-restore", fail_step)
            step_num = runner.restore(rollback, e)
            # <checkpoint_dir>/best is kept: its saves are score-gated
            dropped = ckpt.delete_steps_after(step_num)
            if dropped:
                print(f"[dcgan_tpu_torch] dropped checkpoint step(s) "
                      f"{dropped} saved inside the poisoned window",
                      flush=True)
            write_row(fail_step, {"anomaly/rollbacks": rollback.rollbacks},
                      "anomaly")
            watchdog.disarm()
            if rollback.lr_backoff < 1.0:
                scale = rollback.lr_scale()
                runner.set_lr_scale(scale)
                print(f"[dcgan_tpu_torch] rollback LR backoff: base rates "
                      f"scaled by {scale:.3g} (rate cells refilled, "
                      f"nothing captured)", flush=True)
            rekey = rollback.rollbacks
            step_draws = par.step_draws(step_inputs, rekey)
            stage_draws = par.stage_draws(stage_inputs, rekey)
            rank_summary_z = par.summary_z(summary_z, rekey)

        def report_startup(step: int) -> None:
            """The startup breakdown, once, at the first call's readback:
            the phases' ms and the restore's verify stats. Always printed;
            written as a row only under --aot_warmup (the JAX trainer's
            warm-start gate, whose compile cache the port does not
            have)."""
            row = startup.summary()
            rs = ckpt.last_restore_stats
            if rs is not None:
                row.update({
                    "perf/restore/verify_files": rs["files"],
                    "perf/restore/verify_bytes": rs["bytes_read"],
                    # no restore cache: every byte is read
                    "perf/restore/verify_cached_bytes": 0.0,
                    "perf/restore/verify_ms": rs["verify_ms"],
                })
            if chief:
                print("[dcgan_tpu_torch] startup "
                      + json.dumps({k: round(v, 1)
                                    for k, v in row.items()}), flush=True)
            if cfg.aot_warmup:
                write_row(step, row, "startup")

        # trace capture: the scheduled window when profile_dir is set, a
        # window per touch of profile_trigger; a trigger-only run writes
        # its traces under checkpoint_dir/trace
        trace_dir = cfg.profile_dir or (
            os.path.join(cfg.checkpoint_dir, "trace")
            if cfg.profile_trigger else "")
        if not chief:
            trace_dir = ""   # the chief alone traces
        # the call sizes the open window records (its warm-up call is
        # not): the digest divides the busiest program's median by the
        # largest, not by steps_per_call (a window inside a K=1 stretch
        # would read K times too small)
        capture_ks: list = []

        def on_trace_capture(stop_step: int) -> None:
            """A window closed: its file is resolved here, on the dispatch
            thread (the newest of this host's), and digested on the
            services worker into a perf/device/* row."""
            ks = capture_ks[:]
            del capture_ks[:]
            spc = max(ks) if ks else max(1, cfg.steps_per_call)
            try:
                path = find_trace(trace_dir, host=socket.gethostname())
            except OSError as e:
                print(f"[dcgan_tpu_torch] trace capture ending at step "
                      f"{stop_step} left no trace file: {e!r}", flush=True)
                return

            def digest_task(s=stop_step, path=path,
                            stop_ms=trace.last_stop_ms):
                t0 = time.perf_counter()
                d = digest(path)
                digest_s = time.perf_counter() - t0
                if d["source"] == "none":
                    print(f"[dcgan_tpu_torch] trace capture ending at step "
                          f"{s} has no device events; nothing to digest",
                          flush=True)
                    return
                step_ms = d["program_ms_median"] / spc
                if cfg.pipeline_gd:
                    # one step is a d_update and a g_update
                    step_ms = stage_step_ms(d) or step_ms
                row = {
                    "perf/device/compute_ms": d["compute_ms"],
                    "perf/device/collective_ms": d["collective_ms"],
                    "perf/device/idle_gap_ms": d["idle_gap_ms"],
                    "perf/device/span_ms": d["span_ms"],
                    "perf/device/step_ms": step_ms,
                    "perf/device/overlap_frac": d["overlap_frac"],
                }
                print(f"[dcgan_tpu_torch] trace digest (ending step {s}, "
                      f"{d['source']} track, top program {d['program']!r} "
                      f"x{d['program_n']}): "
                      + " ".join(f"{k.rsplit('/', 1)[1]}={v:.3f}"
                                 for k, v in row.items())
                      + f" stop_ms={stop_ms:.1f} trace_bytes="
                      f"{os.path.getsize(path)} digest_s={digest_s:.3f} "
                      f"trace={path}", flush=True)
                writer.write_scalars(s, row)
            svc.submit(digest_task, tag="trace-digest")

        trace = TraceCapture(trace_dir,
                             start_step=step_num + cfg.profile_start_step,
                             num_steps=cfg.profile_num_steps,
                             schedule=bool(cfg.profile_dir),
                             trigger_path=cfg.profile_trigger,
                             on_capture=on_trace_capture, device=dev)
        if rollback is not None:
            # the first restore point: a fresh init or a verified restore
            rollback.snapshot(step_num, state)
        while step_num < total_steps:
            svc.raise_if_failed()  # a dead telemetry worker fails loudly
            chaos.maybe_self_signal(step_num)
            sig, _ = stop.poll()
            if sig is not None:
                print(f"[dcgan_tpu_torch] received signal {sig} — "
                      f"checkpointing at step {step_num} and exiting",
                      flush=True)
                flight.dump("coordinated-stop", step=step_num,
                            extra={"signal": int(sig)})
                if runner.pipeline is not None:
                    with watchdog.guard("pipeline-drain", step_num):
                        runner.pipeline.drain("coordinated-stop")
                # the queued events land before the final save
                svc.drain()
                break
            if prog is not None and prog.switch_due(step_num):
                # the phase switch, at a call boundary
                t_sw = time.perf_counter()
                svc.submit(writer.flush, tag="tb-flush", droppable=False)
                svc.drain()
                if runner.pipeline is not None:
                    runner.pipeline.drain("phase-switch")
                if ckpt.copy_event is not None:
                    # the boundary step's save copies the old runner's
                    # state on a side stream
                    ckpt.copy_event.synchronize()
                old_res = prog.resolution
                merged = prog.advance(runner.state)
                pcfg, fns, par = prog.cfg, prog.fns, prog.par
                lcfg = par.local_cfg
                old, runner = runner, later_runners.pop(prog.index, None)
                if runner is None:
                    runner = new_runner(fns, merged, pcfg)
                else:
                    runner.load(merged)
                del merged
                # its graphs' pools, before the new phase allocates
                old.close()
                del old
                state = runner.state
                ckpt.progressive_tag = prog.tag()
                data, sample_data = rebucketer.reopen(pcfg)
                eval_z = eval_z_of(sample_z, pcfg.batch_size)
                timer = StepTimer(window=cfg.timing_window,
                                  images_per_step=pcfg.batch_size)
                if rollback is not None:
                    # a NaN right after the switch restores the new
                    # phase's tree
                    rollback.snapshot(step_num, state)
                switch_ms = (time.perf_counter() - t_sw) * 1e3
                write_row(step_num, {**prog.scalar_extras(step_num + 1),
                                     "progressive/switch_ms": switch_ms},
                          "progressive")
                switched = (f"[dcgan_tpu_torch] progressive phase "
                            f"{prog.index} at step {step_num}: r{old_res} "
                            f"-> r{prog.resolution} (batch "
                            f"{pcfg.batch_size}, {prog.last_carried} leaves "
                            f"carried) switch_ms={switch_ms:.1f}",
                            runner.captures)
            k = call_size(step_num,
                          total_steps if prog is None else prog.call_limit(),
                          cfg.steps_per_call, runner.warm)
            # the call's dispatch and readback under the deadline, unless
            # it captures or warms up a program
            if runner.ready(k, step_num):
                if runner.pipeline is None:
                    phase = "step-dispatch"
                else:
                    phase = "pipeline-dispatch" if runner.pipeline.primed \
                        else "pipeline-fill"
                watchdog.arm(phase, step_num)
            chaos.maybe_hang(step_num)
            trace.maybe_start(step_num)
            if trace.recording:
                capture_ks.append(k)  # this call is recorded
            batches, labels = zip(*(split_batch(lcfg, next(data))
                                    for _ in range(k)))
            if prog is not None:
                batches = tuple(prog.fade_images(b, step_num + i)
                                for i, b in enumerate(batches))
            if runner.pipeline is not None:
                metrics = runner.pipelined_step(
                    batches[0], stage_draws(pcfg, step_num, dev),
                    start=step_num)
            else:
                zs, draws = zip(*(step_draws(pcfg, step_num + i, dev)
                                  for i in range(k)))
                metrics = runner.step(
                    list(batches), list(zs), list(draws), start=step_num,
                    labels=list(labels) if mcfg.num_classes else None)
            if cfg.aot_warmup and not warm_ms:
                # every row captured right after the warm-up, before the
                # timer is armed; in a progressive run also every later
                # phase's, on a runner warmed on zeros
                with startup.phase("warmup"):
                    if prog is None:
                        warm_ms = aot_capture(runner, build_warmup_plan(
                            cfg, sample=bool(cfg.sample_every_steps)))
                    else:
                        for name, i, row in prog.build_warmup_plan(
                                sample=bool(cfg.sample_every_steps)):
                            r = runner if i == prog.index \
                                else later_runners.get(i)
                            if r is None:
                                cfg_i, fns_i = prog.surface(i)
                                seed_i = cfg.seed + PHASE_SEED_OFFSET + i
                                r = later_runners[i] = new_runner(
                                    fns_i, fns_i.init(seed=seed_i,
                                                      device=dev), cfg_i)
                                r.prime(start=prog.starts[i])
                            warm_ms[name] = r.capture(row)
                if chief:
                    print("[dcgan_tpu_torch] aot warmup captured "
                          f"{len(warm_ms)} program(s): "
                          + ", ".join(f"{n} {ms:.0f}ms"
                                      for n, ms in warm_ms.items()),
                          flush=True)
                write_row(step_num + 1, {f"perf/compile_ms/{n}": ms
                                         for n, ms in warm_ms.items()},
                          "compile-ms")
            # one readback per call: the host waits for the device here,
            # so each tick follows the call's completion; the log reports
            # the call's last step
            per_step = metrics.tolist()
            if not startup.done:
                # the first proven device progress: the time to first step
                startup.first_step()
                report_startup(step_num + k)
            if switched is not None:
                line, before = switched
                print(f"{line} captures_during_switch="
                      f"{runner.captures - before}", flush=True)
                switched = None
            t0 = time.perf_counter()
            pipeline_phase = runner.pipeline.last_phase \
                if runner.pipeline is not None else None
            new_step = step_num + k
            # a snapshot takes only verified state: the gate is forced on
            # the call's last step when a snapshot is due after it
            certify = rollback is not None and rollback.due(new_step)
            try:
                for i, row in enumerate(per_step):
                    gate(step_num + i + 1, dict(zip(keys, row)),
                         certify and i == k - 1, pipeline_phase)
            except FloatingPointError as e:
                if rollback is None:
                    raise
                do_rollback(e)
                continue
            watchdog.disarm()  # the dispatch and readback completed
            values = dict(zip(keys, per_step[-1]))
            timer.note_host(time.perf_counter() - t0)
            timer.tick(steps=k)
            step_num = new_step
            step = step_num
            if step % cfg.log_every_steps == 0:
                t0 = time.perf_counter()
                write_row(step, {**values, **timer.summary(),
                                 **health_extras(),
                                 **(prog.scalar_extras(step)
                                    if prog is not None else {})},
                          "scalars")
                if cfg.precision and not logged_precision:
                    # the policy (numeric code) and the f32 master-moment
                    # census, once; a run without a policy writes neither
                    write_row(step, {
                        "perf/precision/policy": float(
                            {"f32": 0, "bf16": 1, "fp8": 2}[cfg.precision]),
                        "perf/precision/master_f32_leaves":
                            float(master_f32)}, "precision")
                    logged_precision = True
                if chief:
                    print(f"[dcgan_tpu_torch] step {step} time "
                          f"{time.time() - t_start:.1f}s d_loss "
                          f"{values['d_loss']:.8f} g_loss "
                          f"{values['g_loss']:.8f}", flush=True)
                timer.note_host(time.perf_counter() - t0)
            if cfg.sample_every_steps and step % cfg.sample_every_steps == 0:
                t0 = time.perf_counter()
                # the host copies start here, on the dispatch thread: the
                # sampler's output is a static buffer its next replay
                # overwrites
                # every rank samples its rows and gathers the grid; the
                # chief writes it
                staged = stage(runner.sample())
                path = os.path.join(cfg.sample_dir, f"train_{step:08d}.png")

                def grid_task(s=step, st=staged, p=path):
                    imgs = st.get().float().numpy()
                    save_sample_grid(p, imgs[:rows * cols], (rows, cols))
                    writer.write_image_event(s, "samples", p)
                if chief:
                    svc.submit(grid_task, tag="sample-grid")
                if sample_data is not None:
                    # the held-out loss probe with the fixed z (and the
                    # held-out batch's own labels)
                    s_imgs, s_labels = split_batch(lcfg, next(sample_data))
                    ev = stage(fns.eval_losses(state, s_imgs, eval_z,
                                               labels=s_labels))

                    def probe_task(s=step, st=ev):
                        vals = {k: float(v) for k, v in st.get().items()}
                        print(f"[dcgan_tpu_torch] [sample] step {s} d_loss "
                              f"{vals['d_loss']:.8f} g_loss "
                              f"{vals['g_loss']:.8f}", flush=True)
                        writer.write_scalars(s, {f"sample/{k}": v
                                                 for k, v in vals.items()})
                    if chief:
                        svc.submit(probe_task, tag="sample-probe")
                timer.note_host(time.perf_counter() - t0)
            if probe is not None and probe.due(step):
                t0 = time.perf_counter()
                probe.run(step, runner,
                          (split_batch(cfg, b)[0] for b in sample_data),
                          _QueuedWriter(svc, writer))
                timer.note_host(time.perf_counter() - t0)
            if cfg.activation_summary_steps and \
                    step % cfg.activation_summary_steps == 0:
                t0 = time.perf_counter()
                acts = stage(fns.summarize(
                    state, batches[-1], rank_summary_z(pcfg, step, dev),
                    labels[-1]))
                svc.submit(lambda s=step, a=acts:
                           writer.write_activations(s, a.get()),
                           tag="activations")
                timer.note_host(time.perf_counter() - t0)
            trace.maybe_stop(step, sync=metrics)
            if certify:
                with watchdog.guard("snapshot-certify", step):
                    rollback.snapshot(step, state)
            with watchdog.guard("collective-save", step):
                if ckpt.maybe_save(step, state):
                    # the save's host copy reads the static state that the
                    # next step overwrites in place
                    runner.wait_for(ckpt.copy_event)
                    # the events ordered before the checkpoint land first
                    svc.drain()
        svc.submit(writer.flush, tag="tb-flush", droppable=False)
        svc.close()  # drain-on-exit barrier; re-raises a worker failure
        if getattr(svc, "dropped", 0):
            print(f"[dcgan_tpu_torch] host-services backpressure dropped "
                  f"{svc.dropped} telemetry event(s) (training was never "
                  f"stalled for them)", flush=True)
    except BaseException:
        # the final save below does not run: the enforcement thread goes
        # now, so a caller that catches the error and trains again does
        # not collect one per run
        watchdog.close()
        raise
    finally:
        watchdog.disarm()
        stop.restore()
        if runner is not None:
            if runner.pipeline is not None:
                runner.pipeline.drain("shutdown")
            # its graphs' pools, which the closures' cycles would hold
            # until the garbage collector ran
            runner.close()
        for later in later_runners.values():
            later.close()
        for closing in (svc, data, sample_data):
            if closing is None:
                continue
            try:
                closing.close()
            except Exception:
                pass
        if writer is not None:
            writer.close()
        if trace is not None:
            # last: a profiler that fails to stop raises after the rest
            # is closed
            trace.close()
    # the last step (also of a run a signal stopped), unless the cadence
    # saved it already
    try:
        ckpt.wait()
        step = int(state["step"])
        if ckpt.latest_step() != step:
            watchdog.arm("final-save", step)
            ckpt.save(step, state)
            ckpt.wait()
    finally:
        watchdog.close()
    return state
