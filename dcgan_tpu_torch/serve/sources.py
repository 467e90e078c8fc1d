"""Weight source for the sampler server (the counterpart of
`dcgan_tpu/serve/sources.py::CheckpointSource`).

`WeightsSource` serves an `.npz` written by `convert.save_weights` and
presents the surface the worker thread drives:

- `prepare()`: load the weights onto the device (cold start, on the
  dispatch thread); returns the source's metadata;
- `bucket_plan(ladder)` / `bind(rungs)` / `compiled_buckets()`: the rungs
  this source will serve (no AOT compile in the port; the worker's primed
  dispatch per rung is the warm-up);
- `sample(bucket, z[, labels])`: one sampler dispatch at a bound rung,
  materialized to a host float32 array [bucket, S, S, c_dim].
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dcgan_tpu_torch.device import resolve_device
from dcgan_tpu_torch.serve.buckets import BucketLadder


class WeightsSource:
    """Serve the generator stored in a `save_weights` npz."""

    def __init__(self, path: str, *,
                 device: Union[str, torch.device] = "cuda"):
        self.path = path
        self.device = resolve_device(device)
        self.z_dim = 0          # known after prepare()
        self.num_classes = 0    # conditional models are not ported yet
        self.granule = 1        # one device: any batch size tiles
        self.cfg = None
        self._params = None
        self._state = None
        self._rungs: Tuple[int, ...] = ()

    def prepare(self) -> dict:
        from dcgan_tpu_torch.convert import load_weights

        self.cfg, self._params, self._state = load_weights(
            self.path, device=self.device)
        self.z_dim = self.cfg.z_dim
        return {"source": "weights", "step": None, "weights": self.path,
                "device": str(self.device)}

    def bucket_plan(self, ladder: BucketLadder) -> Tuple[int, ...]:
        return tuple(ladder.buckets)

    def bind(self, rungs: Sequence[int]) -> None:
        self._rungs = tuple(sorted(rungs))

    def compiled_buckets(self) -> Tuple[int, ...]:
        """Ascending bound bucket rungs."""
        return self._rungs

    def sample(self, bucket: int, z: np.ndarray,
               labels: Optional[np.ndarray] = None) -> np.ndarray:
        from dcgan_tpu_torch.models.dcgan import sampler_apply

        if bucket not in self._rungs:
            raise KeyError(f"bucket {bucket} is not a bound rung "
                           f"{self._rungs}")
        z = np.asarray(z, np.float32)
        if z.shape != (bucket, self.z_dim):
            raise ValueError(f"z must be [{bucket}, {self.z_dim}], got "
                             f"{z.shape}")
        zt = torch.from_numpy(z).to(self.device)
        img = sampler_apply(self._params, self._state, zt, cfg=self.cfg)
        return img.cpu().numpy()
