"""The training loop (the single-device core of
`dcgan_tpu/train/trainer.py`): seeded init, the synthetic image stream
copied host -> pinned -> device, z drawn on the device, the step, and a
`scalars` event every `log_every_steps` steps in the JAX package's JSONL
format (`<checkpoint_dir>/events.jsonl`: d_loss, d_loss_real, d_loss_fake,
g_loss and StepTimer's perf/* keys).

Checkpoints, resume, sample grids and the TFRecord feed are later slices.
"""

from __future__ import annotations

import dataclasses
import pprint
import time
from typing import Optional, Union

import torch

from dcgan_tpu_torch.config import TrainConfig
from dcgan_tpu_torch.data.synthetic import synthetic_batches
from dcgan_tpu_torch.device import resolve_device
from dcgan_tpu_torch.train.steps import make_train_step
from dcgan_tpu_torch.utils.metrics import MetricWriter
from dcgan_tpu_torch.utils.profiling import StepTimer

Pytree = dict

METRIC_KEYS = ("d_loss", "d_loss_real", "d_loss_fake", "g_loss")


def train(cfg: TrainConfig, *, synthetic_data: bool = False,
          max_steps: Optional[int] = None,
          device: Union[str, torch.device] = "cuda") -> Pytree:
    """Train `cfg` for `max_steps` steps (cfg.max_steps when None) on
    `device`; returns the final state."""
    if not synthetic_data:
        raise NotImplementedError(
            "the TFRecord data feed is not ported to dcgan_tpu_torch yet; "
            "train on synthetic data (synthetic_data=True, --synthetic)")
    dev = resolve_device(device)
    steps = cfg.max_steps if max_steps is None else max_steps
    mcfg = cfg.model
    pprint.pprint(dataclasses.asdict(cfg))
    fns = make_train_step(cfg)
    state = fns.init(seed=cfg.seed, device=dev)
    stream = synthetic_batches(cfg.batch_size, mcfg.output_size, mcfg.c_dim,
                               seed=cfg.seed)
    zgen = torch.Generator(device=dev).manual_seed(cfg.seed)
    writer = MetricWriter(cfg.checkpoint_dir)
    timer = StepTimer(images_per_step=cfg.batch_size)
    t_start = time.time()
    for _ in range(steps):
        images = torch.from_numpy(next(stream))
        if dev.type == "cuda":
            images = images.pin_memory().to(dev, non_blocking=True)
        z = torch.rand((cfg.batch_size, mcfg.z_dim), generator=zgen,
                       device=dev) * 2.0 - 1.0
        state, metrics = fns.train_step(state, images, z)
        # one readback per step: the host waits for the device here, so
        # each tick follows one step's completion
        values = dict(zip(METRIC_KEYS, torch.stack(
            [metrics[k] for k in METRIC_KEYS]).tolist()))
        timer.tick()
        step = int(state["step"])
        if step % cfg.log_every_steps == 0:
            t0 = time.perf_counter()
            writer.write_scalars(step, {**values, **timer.summary()})
            print(f"[dcgan_tpu_torch] step {step} time "
                  f"{time.time() - t_start:.1f}s d_loss "
                  f"{values['d_loss']:.8f} g_loss {values['g_loss']:.8f}",
                  flush=True)
            timer.note_host(time.perf_counter() - t0)
    return state
