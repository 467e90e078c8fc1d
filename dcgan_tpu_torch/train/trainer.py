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
- SIGTERM and SIGINT (train/coordination.py): the loop stops at the next
  call boundary, and the final checkpoint is written as at the end of a
  run, so a preemption resumes where it stopped;
- a `scalars` event every `log_every_steps` steps in the JAX package's
  JSONL format (`<checkpoint_dir>/events.jsonl`: d_loss, d_loss_real,
  d_loss_fake, g_loss and StepTimer's perf/* keys; data/corrupt_records
  once nonzero), mirrored into TensorBoard files;
- every `sample_every_steps` steps a grid PNG of the samples of the fixed
  `sample_z` (drawn once from seed + 1; a conditional model's row i of
  class i mod K) in `sample_dir`, and an image event;
  then the loss probe (`eval_losses`) on a held-out batch, the synthetic
  stream at seed + 100 or the TFRecord shards of `sample_image_dir` when
  that directory exists (none otherwise), with the fixed z, written as
  `sample/*` scalars (`dcgan_tpu/train/trainer.py:250-290, 1769-1800`);
- every `activation_summary_steps` steps an "activations" event of
  `summarize` on the call's last batch (z from (seed, step, 1));
- under a precision policy, a `perf/precision/policy` (f32 0, bf16 1, fp8
  2) and `perf/precision/master_f32_leaves` row at the first log;
- `maybe_save` after every call (every `save_model_secs` of wall clock),
  the next step waiting on the device for the save's host copy of the
  static state; a final save of the last step and a wait for it to be on
  disk.
"""

from __future__ import annotations

import dataclasses
import os
import pprint
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
from dcgan_tpu_torch.train.coordination import CoordinatedStop
from dcgan_tpu_torch.train.steps import draw_stages, draw_step, \
    make_train_step, tree_leaves
from dcgan_tpu_torch.train.warmup import StepRunner, aot_capture, \
    build_warmup_plan, call_size, metric_keys
# the losses' keys, re-exported for the trainer's callers
from dcgan_tpu_torch.train.warmup import METRIC_KEYS  # noqa: F401
from dcgan_tpu_torch.utils.checkpoint import Checkpointer
from dcgan_tpu_torch.utils.images import save_sample_grid
from dcgan_tpu_torch.utils.metrics import MetricWriter
from dcgan_tpu_torch.utils.profiling import StepTimer

Pytree = dict


def _step_generator(cfg: TrainConfig, step: int, device: torch.device,
                    *tag: int) -> torch.Generator:
    seed = np.random.SeedSequence(
        [cfg.seed & 0xFFFFFFFFFFFFFFFF, step, *tag]).generate_state(
            1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(seed[0]))


def _draw_z(cfg: TrainConfig, gen: torch.Generator) -> torch.Tensor:
    return torch.rand((cfg.batch_size, cfg.model.z_dim), generator=gen,
                      device=gen.device) * 2.0 - 1.0


def step_inputs(cfg: TrainConfig, step: int, device: torch.device
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(z, draws) of the step that takes the state from `step` to
    `step + 1`, from one generator seeded from (cfg.seed, step): U(-1, 1)
    z [batch, z_dim] first, then the step's other draws
    (`steps.draw_step`; empty for a config that draws nothing else)."""
    gen = _step_generator(cfg, step, device)
    z = _draw_z(cfg, gen)
    return z, draw_step(cfg, gen)


def stage_inputs(cfg: TrainConfig, step: int, device: torch.device
                 ) -> Dict[str, torch.Tensor]:
    """The stage programs' draws (`steps.draw_stages`) of the pipelined
    step from state step `step`, from the generator of `step_inputs`."""
    return draw_stages(cfg, _step_generator(cfg, step, device))


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


def summary_z(cfg: TrainConfig, step: int, device: torch.device
              ) -> torch.Tensor:
    """The z of `summarize` at step `step`, from (cfg.seed, step, 1)."""
    return _draw_z(cfg, _step_generator(cfg, step, device, 1))


def _synthetic_feed(cfg: TrainConfig, device: torch.device) -> Iterator:
    """The synthetic stream on `device`: image batches, or (images,
    labels) pairs for a conditional model."""
    mcfg = cfg.model
    for batch in synthetic_batches(cfg.batch_size, mcfg.output_size,
                                   mcfg.c_dim, seed=cfg.seed,
                                   num_classes=mcfg.num_classes):
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
              min_after_dequeue: Optional[int] = None) -> Iterator:
    """The trainer's batches on `device`: the synthetic stream, or the
    TFRecord shards of `data_dir` (cfg.data_dir by default; the native
    loader; the record dtype of their dataset.json, when they have one),
    seeded from cfg.seed + seed_offset; (images, labels) pairs for a
    conditional model. Close it when done."""
    if seed_offset:
        cfg = dataclasses.replace(cfg, seed=cfg.seed + seed_offset)
    if synthetic_data:
        return _synthetic_feed(cfg, device)
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
    return make_dataset(dcfg, device)


def make_sample_data(cfg: TrainConfig, device: torch.device, *,
                     synthetic_data: bool = False) -> Optional[Iterator]:
    """The held-out batches of the loss probe: the synthetic stream at
    seed + 100, or the shards of cfg.sample_image_dir (a light loader: 2
    threads, a pool of 4 batches) when that directory exists; None
    otherwise (no probe, as in the JAX trainer)."""
    if synthetic_data:
        return make_data(cfg, device, synthetic_data=True, seed_offset=100)
    if os.path.isdir(cfg.sample_image_dir):
        return make_data(cfg, device, data_dir=cfg.sample_image_dir,
                         seed_offset=100, n_threads=2,
                         min_after_dequeue=4 * cfg.batch_size)
    return None


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


def train(cfg: TrainConfig, *, synthetic_data: bool = False,
          max_steps: Optional[int] = None,
          device: Union[str, torch.device] = "cuda") -> Pytree:
    """Train `cfg` on `device` until the state reaches step `max_steps`
    (cfg.max_steps when None), resuming from the newest intact checkpoint
    in cfg.checkpoint_dir, or until SIGTERM or SIGINT stops it at a call
    boundary; either way the last step is checkpointed. Returns the final
    state."""
    dev = resolve_device(device)
    total_steps = cfg.max_steps if max_steps is None else max_steps
    mcfg = cfg.model
    ckpt = Checkpointer(cfg.checkpoint_dir,
                        save_interval_secs=cfg.save_model_secs,
                        max_to_keep=cfg.max_checkpoints)
    _check_architecture(cfg, ckpt)
    # this run's quarantine count is the process-wide tally's delta, taken
    # before the loader starts; a data_dir without shards fails here,
    # before anything is written
    corrupt_base = quarantine.count()
    data = make_data(cfg, dev, synthetic_data=synthetic_data)
    sample_data = None
    writer = None
    runner = None
    warm_ms: dict = {}
    stop = CoordinatedStop()
    stop.install()
    try:
        pprint.pprint(dataclasses.asdict(cfg))
        save_config(cfg, cfg.checkpoint_dir)
        writer = MetricWriter(cfg.checkpoint_dir,
                              every_secs=cfg.save_summaries_secs,
                              tensorboard=cfg.tensorboard)
        fns = make_train_step(cfg)
        state = fns.init(seed=cfg.seed, device=dev)
        # fixed z for comparable sample grids across the run, drawn once
        rows, cols = cfg.sample_grid
        n_samples = max(cfg.sample_size, rows * cols)
        sample_z = torch.rand(
            (n_samples, mcfg.z_dim), device=dev,
            generator=torch.Generator(device=dev).manual_seed(cfg.seed + 1)
        ) * 2.0 - 1.0
        # the grid's classes: row i of class i mod K
        sample_labels = grid_labels(n_samples, mcfg.num_classes, dev)
        runner = StepRunner(fns, state, cfg, dev, sample_z=sample_z,
                            sample_labels=sample_labels)
        keys = metric_keys(cfg)
        if cfg.sample_every_steps:
            sample_data = make_sample_data(cfg, dev,
                                           synthetic_data=synthetic_data)
        # the probe's fixed z: sample_z's rows, cycled to the batch
        eval_z = sample_z.reshape(-1).repeat(
            -(-cfg.batch_size // n_samples))[
                :cfg.batch_size * mcfg.z_dim].reshape(cfg.batch_size,
                                                      mcfg.z_dim)
        restored = ckpt.restore_latest(state)
        if restored is not None:
            runner.load(restored)
            del restored
            print(f"[dcgan_tpu_torch] restored checkpoint at step "
                  f"{int(state['step'])}", flush=True)
        timer = StepTimer(images_per_step=cfg.batch_size)
        t_start = time.time()
        logged_precision = False
        step_num = int(state["step"])
        while step_num < total_steps:
            sig, _ = stop.poll()
            if sig is not None:
                print(f"[dcgan_tpu_torch] received signal {sig} — "
                      f"checkpointing at step {step_num} and exiting",
                      flush=True)
                if runner.pipeline is not None:
                    runner.pipeline.drain("coordinated-stop")
                break
            k = call_size(step_num, total_steps, cfg.steps_per_call,
                          runner.warm)
            batches, labels = zip(*(split_batch(cfg, next(data))
                                    for _ in range(k)))
            if runner.pipeline is not None:
                metrics = runner.pipelined_step(
                    batches[0], stage_inputs(cfg, step_num, dev),
                    start=step_num)
            else:
                zs, draws = zip(*(step_inputs(cfg, step_num + i, dev)
                                  for i in range(k)))
                metrics = runner.step(
                    list(batches), list(zs), list(draws), start=step_num,
                    labels=list(labels) if mcfg.num_classes else None)
            if cfg.aot_warmup and not warm_ms:
                # every row captured right after the warm-up, before the
                # timer is armed
                warm_ms = aot_capture(runner, build_warmup_plan(
                    cfg, sample=bool(cfg.sample_every_steps)))
                print("[dcgan_tpu_torch] aot warmup captured "
                      f"{len(warm_ms)} program(s): "
                      + ", ".join(f"{n} {ms:.0f}ms"
                                  for n, ms in warm_ms.items()), flush=True)
                writer.write_scalars(step_num + 1, {
                    f"perf/compile_ms/{n}": ms for n, ms in warm_ms.items()})
            # one readback per call: the host waits for the device here,
            # so each tick follows the call's completion; the log reports
            # the call's last step
            per_step = metrics.tolist()
            if cfg.nan_check_steps:
                # every step of the call on the cadence, before any save
                for i, row in enumerate(per_step):
                    if (step_num + i + 1) % cfg.nan_check_steps == 0:
                        check_finite(cfg, step_num + i + 1,
                                     dict(zip(keys, row)))
            values = dict(zip(keys, per_step[-1]))
            timer.tick(steps=k)
            step_num += k
            step = step_num
            if step % cfg.log_every_steps == 0:
                t0 = time.perf_counter()
                row = {**values, **timer.summary()}
                corrupt = quarantine.count() - corrupt_base
                if corrupt:
                    row["data/corrupt_records"] = corrupt
                writer.write_scalars(step, row)
                if cfg.precision and not logged_precision:
                    # the policy (numeric code) and the f32 master-moment
                    # census, once; a run without a policy writes neither
                    writer.write_scalars(step, {
                        "perf/precision/policy": float(
                            {"f32": 0, "bf16": 1, "fp8": 2}[cfg.precision]),
                        "perf/precision/master_f32_leaves": float(
                            master_f32_leaves(state))})
                    logged_precision = True
                print(f"[dcgan_tpu_torch] step {step} time "
                      f"{time.time() - t_start:.1f}s d_loss "
                      f"{values['d_loss']:.8f} g_loss "
                      f"{values['g_loss']:.8f}", flush=True)
                timer.note_host(time.perf_counter() - t0)
            if cfg.sample_every_steps and step % cfg.sample_every_steps == 0:
                t0 = time.perf_counter()
                imgs = runner.sample().float().cpu().numpy()
                path = os.path.join(cfg.sample_dir, f"train_{step:08d}.png")
                save_sample_grid(path, imgs[:rows * cols], (rows, cols))
                writer.write_image_event(step, "samples", path)
                if sample_data is not None:
                    # the held-out loss probe with the fixed z (and the
                    # held-out batch's own labels)
                    s_imgs, s_labels = split_batch(cfg, next(sample_data))
                    ev = {k: float(v) for k, v in fns.eval_losses(
                        state, s_imgs, eval_z, labels=s_labels).items()}
                    print(f"[dcgan_tpu_torch] [sample] step {step} d_loss "
                          f"{ev['d_loss']:.8f} g_loss {ev['g_loss']:.8f}",
                          flush=True)
                    writer.write_scalars(step, {f"sample/{k}": v
                                                for k, v in ev.items()})
                timer.note_host(time.perf_counter() - t0)
            if cfg.activation_summary_steps and \
                    step % cfg.activation_summary_steps == 0:
                t0 = time.perf_counter()
                writer.write_activations(step, fns.summarize(
                    state, batches[-1], summary_z(cfg, step, dev),
                    labels[-1]))
                timer.note_host(time.perf_counter() - t0)
            if ckpt.maybe_save(step, state):
                # the save's host copy reads the static state that the
                # next step overwrites in place
                runner.wait_for(ckpt.copy_event)
    finally:
        stop.restore()
        if runner is not None:
            if runner.pipeline is not None:
                runner.pipeline.drain("shutdown")
            # its graphs' pools, which the closures' cycles would hold
            # until the garbage collector ran
            runner.close()
        data.close()
        if sample_data is not None:
            sample_data.close()
        if writer is not None:
            writer.close()
    # the last step (also of a run a signal stopped), unless the cadence
    # saved it already
    ckpt.wait()
    step = int(state["step"])
    if ckpt.latest_step() != step:
        ckpt.save(step, state)
        ckpt.wait()
    return state
