"""Weight sources for the sampler server (the counterpart of
`dcgan_tpu/serve/sources.py`):

- `CheckpointSource` serves the generator of a training checkpoint
  directory: the newest intact step, restored through the Checkpointer's
  verified restore (a corrupt newest step is marked `.corrupt` and the one
  before it is served), the live or the EMA weights;
- `WeightsSource` serves an `.npz` written by `convert.save_weights`.

- `StateSource` serves a generator already in memory (generate.py's
  restored checkpoint).

All present the surface the worker thread drives:

- `prepare()`: load the weights onto the device (cold start, on the
  dispatch thread); returns the source's metadata;
- `bucket_plan(ladder)` / `bind(rungs)` / `compiled_buckets()`: the rungs
  this source will serve. `bind` gives each rung a static z input and
  runs the sampler on it once eagerly (the warm-up: it builds the kernels
  and lets cuDNN pick its algorithms), then captures it as a CUDA graph
  with its static output (graphs.py; eager on the CPU), timing each
  capture into `compile_ms` under the JAX row name `sampler@b<rung>`;
- `sample(bucket, z[, labels])`: z copied into the rung's input, one
  replay, the image copied out to a host float32 array
  [bucket, S, S, c_dim]. `captures` counts every capture, so the server
  can report the captures after warm-up (`serve/recompiles_after_warmup`,
  0 by construction: an unbound rung raises instead of being captured).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dcgan_tpu_torch.device import resolve_device
from dcgan_tpu_torch.graphs import CapturedProgram, on_stream
from dcgan_tpu_torch.serve.buckets import BucketLadder


class _GeneratorSource:
    """The serving surface over a generator's (params, BN state) and its
    ModelConfig, which a subclass's `prepare()` loads."""

    def __init__(self, device: Union[str, torch.device]):
        self.device = resolve_device(device)
        self.z_dim = 0          # known after prepare()
        self.num_classes = 0    # conditional models are not ported yet
        self.granule = 1        # one device: any batch size tiles
        self.cfg = None
        self._params = None
        self._state = None
        self._rungs: Dict[int, Tuple[torch.Tensor, CapturedProgram]] = {}
        self.compile_ms: Dict[str, float] = {}
        self.captures = 0

    def prepare(self) -> dict:
        raise NotImplementedError

    def bucket_plan(self, ladder: BucketLadder) -> Tuple[int, ...]:
        return tuple(ladder.buckets)

    def bind(self, rungs: Sequence[int]) -> None:
        """Warm up and capture one sampler program per rung."""
        from dcgan_tpu_torch.models.dcgan import sampler_apply

        stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        for b in sorted(rungs):
            if b in self._rungs:
                continue
            z = torch.zeros((b, self.z_dim), dtype=torch.float32,
                            device=self.device)

            def fn(z=z):
                return sampler_apply(self._params, self._state, z,
                                     cfg=self.cfg)
            with on_stream(stream):
                fn()
            prog = CapturedProgram(f"sampler@b{b}", fn, self.device, stream)
            self.compile_ms[prog.name] = prog.capture()
            self.captures += 1
            self._rungs[b] = (z, prog)

    def compiled_buckets(self) -> Tuple[int, ...]:
        """Ascending bound bucket rungs."""
        return tuple(sorted(self._rungs))

    def sample(self, bucket: int, z: np.ndarray,
               labels: Optional[np.ndarray] = None) -> np.ndarray:
        if bucket not in self._rungs:
            raise KeyError(f"bucket {bucket} is not a bound rung "
                           f"{self.compiled_buckets()}")
        z = np.asarray(z, np.float32)
        if z.shape != (bucket, self.z_dim):
            raise ValueError(f"z must be [{bucket}, {self.z_dim}], got "
                             f"{z.shape}")
        z_in, prog = self._rungs[bucket]
        z_in.copy_(torch.from_numpy(z))
        return prog.run().cpu().numpy()


class CheckpointSource(_GeneratorSource):
    """Serve the generator of the newest intact checkpoint in a training
    checkpoint directory (its config.json names the architecture)."""

    def __init__(self, checkpoint_dir: str, *, use_ema: bool = False,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__(device)
        self.checkpoint_dir = checkpoint_dir
        self.use_ema = use_ema

    def prepare(self) -> dict:
        from dcgan_tpu_torch.config import load_config
        from dcgan_tpu_torch.train.steps import init_train_state
        from dcgan_tpu_torch.utils.checkpoint import Checkpointer
        from dcgan_tpu_torch.utils.retry import retry_io

        cfg = load_config(self.checkpoint_dir)
        if cfg is None:
            raise FileNotFoundError(
                f"no config.json in {self.checkpoint_dir}")
        template = init_train_state(cfg, device=self.device)
        ckpt = Checkpointer(self.checkpoint_dir)
        # transient IO errors during the restore retry with backoff; a
        # checkpoint that stays broken fails the cold start
        restored = retry_io(lambda: ckpt.restore_latest(template),
                            tag="serve-restore")
        if restored is None:
            raise FileNotFoundError(
                f"no checkpoint under {self.checkpoint_dir}")
        self.cfg = cfg.model
        self._params = (restored["ema_gen"] if self.use_ema
                        else restored["params"]["gen"])
        self._state = restored["bn"]["gen"]
        self.z_dim = self.cfg.z_dim
        return {"source": "checkpoint", "step": int(restored["step"]),
                "weights": "ema" if self.use_ema else "live",
                "device": str(self.device)}


class WeightsSource(_GeneratorSource):
    """Serve the generator stored in a `save_weights` npz."""

    def __init__(self, path: str, *,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__(device)
        self.path = path

    def prepare(self) -> dict:
        from dcgan_tpu_torch.convert import load_weights

        self.cfg, self._params, self._state = load_weights(
            self.path, device=self.device)
        self.z_dim = self.cfg.z_dim
        return {"source": "weights", "step": None, "weights": self.path,
                "device": str(self.device)}


class StateSource(_GeneratorSource):
    """Serve a generator already in memory: (ModelConfig, params, BN
    state) on the source's device."""

    def __init__(self, cfg, params, state, *,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__(device)
        self.cfg = cfg
        self._params = params
        self._state = state
        self.z_dim = cfg.z_dim

    def prepare(self) -> dict:
        return {"source": "state", "step": None, "weights": "memory",
                "device": str(self.device)}
