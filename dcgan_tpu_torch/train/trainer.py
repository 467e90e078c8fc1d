"""The training loop (the single-device core of
`dcgan_tpu/train/trainer.py`):

- the checkpoint directory first: a `config.json` there of another
  architecture fails the run (with the JAX trainer's message) once the
  directory holds a checkpoint, then this run's `config.json` is written
  in the JAX package's schema;
- seeded init, then `Checkpointer.restore_latest`: a run on a directory
  with checkpoints continues from the newest intact step;
- the data: TFRecord shards from `data_dir` through the Python loader and
  the device prefetcher (data/pipeline.py; the record dtype of the shards'
  dataset.json wins over the config's), or the synthetic stream copied
  host -> pinned -> device, which restarts at batch 0 on a resume as the
  JAX trainer's does;
- the z of the step that takes the state from step s to s + 1 comes from a
  generator seeded from (seed, s), as the JAX trainer folds s into its
  base key, so a resumed run draws the z an unbroken run draws;
- a `scalars` event every `log_every_steps` steps in the JAX package's
  JSONL format (`<checkpoint_dir>/events.jsonl`: d_loss, d_loss_real,
  d_loss_fake, g_loss and StepTimer's perf/* keys; data/corrupt_records
  once nonzero), mirrored into TensorBoard files;
- every `sample_every_steps` steps a grid PNG of the samples of the fixed
  `sample_z` (drawn once from seed + 1) in `sample_dir`, and an image event;
- `maybe_save` after every step (every `save_model_secs` of wall clock),
  a final save of the last step and a wait for it to be on disk.
"""

from __future__ import annotations

import dataclasses
import os
import pprint
import time
from typing import Iterator, Optional, Union

import numpy as np
import torch

from dcgan_tpu_torch.config import TrainConfig, load_config, save_config
from dcgan_tpu_torch.data import quarantine
from dcgan_tpu_torch.data.pipeline import DataConfig, make_dataset, \
    read_manifest
from dcgan_tpu_torch.data.synthetic import synthetic_batches
from dcgan_tpu_torch.device import resolve_device
from dcgan_tpu_torch.train.steps import make_train_step
from dcgan_tpu_torch.utils.checkpoint import Checkpointer
from dcgan_tpu_torch.utils.images import save_sample_grid
from dcgan_tpu_torch.utils.metrics import MetricWriter
from dcgan_tpu_torch.utils.profiling import StepTimer

Pytree = dict

METRIC_KEYS = ("d_loss", "d_loss_real", "d_loss_fake", "g_loss")


def step_z(cfg: TrainConfig, step: int, device: torch.device
           ) -> torch.Tensor:
    """U(-1, 1) z [batch, z_dim] of the step that takes the state from
    `step` to `step + 1`, from a generator seeded from (cfg.seed, step)."""
    seed = np.random.SeedSequence(
        [cfg.seed & 0xFFFFFFFFFFFFFFFF, step]).generate_state(1, np.uint64)
    gen = torch.Generator(device=device).manual_seed(int(seed[0]))
    return torch.rand((cfg.batch_size, cfg.model.z_dim), generator=gen,
                      device=device) * 2.0 - 1.0


def _synthetic_feed(cfg: TrainConfig, device: torch.device) -> Iterator:
    mcfg = cfg.model
    for batch in synthetic_batches(cfg.batch_size, mcfg.output_size,
                                   mcfg.c_dim, seed=cfg.seed):
        images = torch.from_numpy(batch)
        if device.type == "cuda":
            images = images.pin_memory().to(device, non_blocking=True)
        yield images


def make_data(cfg: TrainConfig, device: torch.device, *,
              synthetic_data: bool = False) -> Iterator:
    """The trainer's batches on `device`: the synthetic stream, or the
    TFRecord shards of cfg.data_dir (the Python loader; the record dtype
    of their dataset.json, when they have one). Close it when done."""
    if synthetic_data:
        return _synthetic_feed(cfg, device)
    # the manifest's wire format is authoritative; cfg.record_dtype covers
    # shards without one
    wire_dtype = read_manifest(cfg.data_dir).get("record_dtype",
                                                 cfg.record_dtype)
    if wire_dtype != cfg.record_dtype:
        print(f"[dcgan_tpu_torch] adopting record_dtype={wire_dtype!r} "
              f"from {cfg.data_dir}/dataset.json (config said "
              f"{cfg.record_dtype!r})", flush=True)
    dcfg = DataConfig(
        data_dir=cfg.data_dir, image_size=cfg.model.output_size,
        channels=cfg.model.c_dim, batch_size=cfg.batch_size,
        record_dtype=wire_dtype, min_after_dequeue=cfg.shuffle_buffer,
        n_threads=cfg.num_loader_threads, seed=cfg.seed,
        normalize=cfg.normalize_inputs,
        prefetch_device_batches=cfg.prefetch_device_batches,
        max_corrupt_records=cfg.max_corrupt_records, use_native=False)
    return make_dataset(dcfg, device)


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
    in cfg.checkpoint_dir; returns the final state."""
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
    writer = None
    try:
        pprint.pprint(dataclasses.asdict(cfg))
        save_config(cfg, cfg.checkpoint_dir)
        writer = MetricWriter(cfg.checkpoint_dir,
                              every_secs=cfg.save_summaries_secs,
                              tensorboard=cfg.tensorboard)
        fns = make_train_step(cfg)
        state = fns.init(seed=cfg.seed, device=dev)
        restored = ckpt.restore_latest(state)
        if restored is not None:
            state = restored
            print(f"[dcgan_tpu_torch] restored checkpoint at step "
                  f"{int(state['step'])}", flush=True)
        # fixed z for comparable sample grids across the run, drawn once
        rows, cols = cfg.sample_grid
        n_samples = max(cfg.sample_size, rows * cols)
        sample_z = torch.rand(
            (n_samples, mcfg.z_dim), device=dev,
            generator=torch.Generator(device=dev).manual_seed(cfg.seed + 1)
        ) * 2.0 - 1.0
        timer = StepTimer(images_per_step=cfg.batch_size)
        t_start = time.time()
        for step_num in range(int(state["step"]), total_steps):
            images = next(data)
            z = step_z(cfg, step_num, dev)
            state, metrics = fns.train_step(state, images, z)
            # one readback per step: the host waits for the device here,
            # so each tick follows one step's completion
            values = dict(zip(METRIC_KEYS, torch.stack(
                [metrics[k] for k in METRIC_KEYS]).tolist()))
            timer.tick()
            step = step_num + 1
            if step % cfg.log_every_steps == 0:
                t0 = time.perf_counter()
                row = {**values, **timer.summary()}
                corrupt = quarantine.count() - corrupt_base
                if corrupt:
                    row["data/corrupt_records"] = corrupt
                writer.write_scalars(step, row)
                print(f"[dcgan_tpu_torch] step {step} time "
                      f"{time.time() - t_start:.1f}s d_loss "
                      f"{values['d_loss']:.8f} g_loss "
                      f"{values['g_loss']:.8f}", flush=True)
                timer.note_host(time.perf_counter() - t0)
            if cfg.sample_every_steps and step % cfg.sample_every_steps == 0:
                t0 = time.perf_counter()
                imgs = fns.sample(state, sample_z).float().cpu().numpy()
                path = os.path.join(cfg.sample_dir, f"train_{step:08d}.png")
                save_sample_grid(path, imgs[:rows * cols], (rows, cols))
                writer.write_image_event(step, "samples", path)
                timer.note_host(time.perf_counter() - t0)
            ckpt.maybe_save(step, state)
    finally:
        data.close()
        if writer is not None:
            writer.close()
    # the last step, unless the cadence saved it already
    ckpt.wait()
    step = int(state["step"])
    if ckpt.latest_step() != step:
        ckpt.save(step, state)
        ckpt.wait()
    return state
