"""The (data, model) layout over the world's ranks (the counterpart of
`dcgan_tpu/parallel/mesh.py:29-36`).

A JAX mesh holds devices; here every rank is a process with one device,
so the mesh is the (data, model) sizes over the world's ranks, rank r at
data index r // model and model index r % model (JAX's `reshape(data,
model)`). A model axis runs only as the spatial mesh (parallel/spatial.py
forms the process group of each axis); MeshConfig refuses tensor
parallelism by name (config.py)."""

from __future__ import annotations

import dataclasses
from typing import Optional

from dcgan_tpu_torch.config import MeshConfig

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    data: int
    model: int

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}



def make_mesh(cfg: Optional[MeshConfig] = None, world_size: int = 1) -> Mesh:
    """The mesh of `cfg` over `world_size` ranks; raises where its axes do
    not cover them (MeshConfig.axis_sizes, the JAX arithmetic)."""
    cfg = cfg or MeshConfig()
    data, model = cfg.axis_sizes(world_size)
    return Mesh(data=data, model=model)
