"""The training programs over processes (the counterpart of
`dcgan_tpu/parallel/api.py:43-129, 131-364` and
`parallel/shard_map_backend.py:61-324`).

Every rank runs the same per-rank program on its share of the global
batch: `train/steps.py::make_train_step(local_cfg, group)`, whose
BatchNorm moments (plain or kernels 1 and 4), gradients and losses are
averaged over the ranks (parallel/collectives.py), as the JAX
explicit-collective backend does with `lax.pmean` over "data". The state
is replicated: `init` gives every rank the same state from the same
seed, and the averaged gradients keep it so, bit for bit.

The two JAX backends differ here only in how a step draws its
randomness:
- "gspmd": every rank draws the global batch's z and other draws from
  the step's generator, as the one-device step does, and takes its rows
  (`rank_rows`: under grad_accum K the rows of each global microbatch
  that fall to the rank, since the global step splits the global batch
  into K microbatches that every rank shares). World N is then world 1 on
  the global batch, up to the order of the sums;
- "shard_map": every rank draws its own rows from the step's seed folded
  with its rank (`shard_map_backend.py:216-219` folds `axis_index`).

On a spatial mesh (`MeshConfig(model > 1, spatial=True)`, the gspmd
backend) rank r sits at data index r // model and model index r % model;
the rank's batch is its data index's share and its rows of the images
(parallel/spatial.py: the programs take the data share's whole images
and cut the rank's rows), its draws the rows of its data index, and the
step is `make_train_step(local_cfg, world.group, spatial)`. JAX's routing
holds: with attention the BN and fused kernels are narrowed off
(`bn_pallas`, `pallas_fused`) and kernels 6-8 run as ring x flash; without
attention `use_pallas` is refused (`api.py:140-164`). The sampler gathers
the rows over the model axis, then the images over the data axis.

`make_parallel_train` returns the programs under the JAX `programs`
names: init, train_step, multi_step, sampler, summarize, eval_losses,
gen_fakes, d_update, g_update. `fns` holds the same functions as a
TrainStepFns for the trainer's StepRunner. The sampler takes the whole
z (every rank the same), samples the rank's rows and gathers the images
of every rank (`shard_map_backend.py:221-235`); the loss probe takes the
whole z too and the rank's share of the held-out images.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Tuple

import torch

from dcgan_tpu_torch.config import TrainConfig
from dcgan_tpu_torch.parallel.collectives import gather_rows
from dcgan_tpu_torch.parallel.distributed import World
from dcgan_tpu_torch.parallel.mesh import Mesh, make_mesh
from dcgan_tpu_torch.parallel.spatial import make_spatial
from dcgan_tpu_torch.train.steps import TrainStepFns, draw_stages, \
    draw_step, make_train_step, step_generator

Pytree = dict

# the shard_map draws' fold: (RANK_TAG, rank) joins the step's seed
RANK_TAG = 0x72616E6B
# the stage draws whose batch axis is 1 (a stack of [B, z] slots)
_STACKED_DRAWS = ("fill/z", "g/extra_z")


def rank_rows(batch: int, rank: int, world: int, grad_accum: int = 1
              ) -> torch.Tensor:
    """The rows of a global batch of `batch` that rank `rank` of `world`
    takes under the gspmd draws: the rank's contiguous share of each of
    the grad_accum global microbatches, in order (its contiguous share of
    the batch at grad_accum 1)."""
    micro = batch // grad_accum
    share = micro // world
    return torch.cat([torch.arange(j * micro + rank * share,
                                   j * micro + (rank + 1) * share)
                      for j in range(grad_accum)])


def check_layout(cfg: TrainConfig, n_data: int) -> None:
    """The JAX backends' divisibility checks (`shard_map_backend.py:66-82`,
    `api.py:198-211`), with their messages."""
    if cfg.batch_size % n_data:
        raise ValueError(
            f"global batch {cfg.batch_size} must divide over "
            f"{n_data} data shards")
    if cfg.grad_accum > 1 and (cfg.batch_size // cfg.grad_accum) % n_data:
        raise ValueError(
            f"microbatch {cfg.batch_size // cfg.grad_accum} "
            f"(batch_size/grad_accum) must divide over {n_data} data "
            "shards")


@dataclasses.dataclass(frozen=True)
class ParallelTrain:
    """The per-rank programs of one TrainConfig over one World."""

    cfg: TrainConfig          # the global config (global batch)
    local_cfg: TrainConfig    # the rank's share: batch_size / data
    world: World
    mesh: Mesh
    fns: TrainStepFns         # the programs, as the StepRunner takes them
    programs: Dict[str, Callable] = dataclasses.field(default_factory=dict)

    @property
    def data_index(self) -> int:
        """The rank's index on the data axis (its rank without a model
        axis)."""
        return self.world.rank // self.mesh.model

    @property
    def folds_rank(self) -> bool:
        """Whether the draws are the rank's own (shard_map) rather than its
        rows of the global draws (gspmd)."""
        return self.cfg.backend == "shard_map"

    # -- rows --------------------------------------------------------------

    def rows(self, t: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """This rank's rows of a global-batch tensor along `axis` (the
        gspmd draws' layout; the tensor itself at world size 1)."""
        if self.mesh.data == 1:
            return t
        idx = rank_rows(t.shape[axis], self.data_index, self.mesh.data,
                        self.cfg.grad_accum)
        return t.index_select(axis, idx.to(t.device))

    def share(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous share of `t` along dim 0 (the sampler's
        and the loss probe's inputs, JAX's batch sharding)."""
        n = self.mesh.data
        if n == 1:
            return t
        if t.shape[0] % n:
            raise ValueError(f"{t.shape[0]} rows do not divide over the "
                             f"{n}-way data axis")
        per = t.shape[0] // n
        return t.narrow(0, self.data_index * per, per)

    def _draw_rows(self, draws: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        return {k: self.rows(v, 1 if k in _STACKED_DRAWS else 0)
                for k, v in draws.items()}

    # -- the step's draws --------------------------------------------------
    #
    # Each wrapper takes the trainer's global draw function `base(cfg, step,
    # device[, rekey=])` and returns the rank's `fn(cfg, step, device)`,
    # for the config it is called with (a progressive run's phase): gspmd
    # takes the rank's rows of base's draws (base itself at world size 1,
    # so a one-process run draws what it always drew), shard_map draws
    # the rank's own from the step's seed folded with (RANK_TAG, rank)
    # and ignores base. `rekey` is the rollback count (train/trainer.py).

    def _rank_generator(self, cfg: TrainConfig, step: int, device,
                        *tag: int, rekey: int = 0) -> torch.Generator:
        return step_generator(cfg, step, device, *tag, RANK_TAG,
                              self.world.rank, rekey=rekey)

    def _local_z(self, cfg: TrainConfig, gen: torch.Generator,
                 device) -> torch.Tensor:
        local = local_config(cfg, self.mesh.data)
        return torch.rand((local.batch_size, local.model.z_dim),
                          generator=gen, device=device) * 2.0 - 1.0

    def _global(self, base: Callable, rekey: int) -> Callable:
        return functools.partial(base, rekey=rekey) if rekey else base

    def step_draws(self, base: Callable, rekey: int = 0) -> Callable:
        """The rank's (z, draws) of a step (the trainer's `step_inputs`)."""
        if self.folds_rank:
            def folded(cfg, step, device):
                gen = self._rank_generator(cfg, step, device, rekey=rekey)
                z = self._local_z(cfg, gen, device)
                return z, draw_step(local_config(cfg, self.mesh.data), gen)
            return folded
        glob = self._global(base, rekey)
        if self.mesh.data == 1:
            return glob

        def rows(cfg, step, device):
            z, draws = glob(cfg, step, device)
            return self.rows(z), self._draw_rows(draws)
        return rows

    def stage_draws(self, base: Callable, rekey: int = 0) -> Callable:
        """The rank's draws of a pipelined step (`stage_inputs`)."""
        if self.folds_rank:
            def folded(cfg, step, device):
                return draw_stages(local_config(cfg, self.mesh.data),
                                   self._rank_generator(cfg, step, device,
                                                        rekey=rekey))
            return folded
        glob = self._global(base, rekey)
        if self.mesh.data == 1:
            return glob

        def rows(cfg, step, device):
            return self._draw_rows(glob(cfg, step, device))
        return rows

    def summary_z(self, base: Callable, rekey: int = 0) -> Callable:
        """The rank's z of the activation summary (`summary_z`)."""
        if self.folds_rank:
            def folded(cfg, step, device):
                return self._local_z(cfg, self._rank_generator(
                    cfg, step, device, 1, rekey=rekey), device)
            return folded
        glob = self._global(base, rekey)
        if self.mesh.data == 1:
            return glob

        def rows(cfg, step, device):
            return self.rows(glob(cfg, step, device))
        return rows


def local_config(cfg: TrainConfig, n_data: int) -> TrainConfig:
    """`cfg` with the batch of one of `n_data` data shards (`cfg` itself
    for one)."""
    if n_data == 1:
        return cfg
    return dataclasses.replace(cfg, batch_size=cfg.batch_size // n_data)


def data_shard(cfg: TrainConfig, world: World) -> Tuple[int, int]:
    """(the rank's data index, the data axis's size): whose share of the
    global batch the rank's feed reads, the ranks of one model group
    reading the same."""
    data, model = cfg.mesh.axis_sizes(world.size)
    return world.rank // model, data


def spatial_route(cfg: TrainConfig, mesh: Mesh) -> TrainConfig:
    """The gspmd backend's kernel routing on a mesh with a model axis
    (`dcgan_tpu/parallel/api.py:140-164`): under spatial with attention
    BatchNorm and the fused stages leave the kernels (bn_pallas and
    pallas_fused off; the flash kernels run as ring x flash); anything
    else with use_pallas raises the JAX error."""
    if not (cfg.model.use_pallas and mesh.model > 1):
        return cfg
    if cfg.mesh.spatial and cfg.model.attn_res:
        return dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, bn_pallas=False, pallas_fused=False))
    raise ValueError(
        "use_pallas under the gspmd backend composes with data-"
        f"parallel meshes only, got mesh={dict(mesh.shape)} "
        f"(spatial={cfg.mesh.spatial}); the fused kernels need "
        "full channel vectors per shard")


def check_spatial(cfg: TrainConfig, model: int) -> None:
    """Every map of both nets must split into whole blocks of rows, of
    even height where a stride-2 conv reads them."""
    m = cfg.model
    sizes = [m.base_size * 2 ** i for i in range(m.num_up_layers + 1)]
    for size in sizes:
        if size % model or (size > m.base_size and (size // model) % 2):
            raise ValueError(
                f"the {size}x{size} maps of a {m.output_size} px model do "
                f"not split into even blocks of rows over a {model}-way "
                "model axis")


def make_parallel_train(cfg: TrainConfig, world: World) -> ParallelTrain:
    """The per-rank programs of `cfg` on `world`: the mesh over its ranks
    (a MeshConfig whose axes do not cover them raises, as in JAX), the
    batch and microbatch checked against the data axis, and `cfg` with the
    rank's share of the batch; on a spatial mesh the height-sharded step
    (the module docstring)."""
    mesh = make_mesh(cfg.mesh, world.size)
    check_layout(cfg, mesh.data)
    cfg = spatial_route(cfg, mesh)
    local_cfg = local_config(cfg, mesh.data)
    sp = None
    if cfg.mesh.spatial:
        check_spatial(cfg, mesh.model)
        sp = make_spatial(world, mesh.data, mesh.model)
    inner = make_train_step(local_cfg, group=world.group, spatial=sp)
    wgan = cfg.loss == "wgan-gp"
    par: Optional[ParallelTrain] = None

    def sample(state: Pytree, z: torch.Tensor,
               labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        imgs = inner.sample(state, par.share(z),
                            None if labels is None else par.share(labels))
        if sp is None:
            return gather_rows(world.group, imgs)
        return gather_rows(sp.data_group, sp.gather(imgs))

    def eval_losses(state: Pytree, images: torch.Tensor, z: torch.Tensor,
                    eps: Optional[torch.Tensor] = None,
                    labels: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
        # gspmd: WGAN-GP's fixed interpolation weights are the global
        # batch's (drawn from a generator seeded 0 unless given), each
        # rank taking its share; shard_map: every rank draws its own from
        # the same seed, as each JAX shard draws from the same fixed key
        if wgan and not par.folds_rank and mesh.data > 1:
            if eps is None:
                gen = torch.Generator(device=images.device).manual_seed(0)
                eps = torch.rand((cfg.batch_size,), generator=gen,
                                 device=images.device)
            eps = par.share(eps)
        return inner.eval_losses(state, rows(images), par.share(z), eps,
                                 labels)

    def multi_step(state: Pytree, images: List[torch.Tensor],
                   zs: List[torch.Tensor], draws: List[dict],
                   labels: Optional[List[torch.Tensor]] = None
                   ) -> Tuple[Pytree, Dict[str, torch.Tensor]]:
        """len(images) steps, returning the state and the last step's
        metrics (`make_multi_step_body`, lazy R1's window max aside: the
        trainer's runner reads every step's row)."""
        metrics: Dict[str, torch.Tensor] = {}
        for i, img in enumerate(images):
            state, metrics = fns.train_step(
                state, img, zs[i], draws[i],
                None if labels is None else labels[i])
        return state, metrics

    def rows(images: torch.Tensor) -> torch.Tensor:
        """The rank's rows of its data share's images (themselves without
        a spatial mesh)."""
        return images if sp is None else sp.rows(images)

    def train_step(state: Pytree, images: torch.Tensor, *args, **kwargs):
        return inner.train_step(state, rows(images), *args, **kwargs)

    def grads(state: Pytree, images: torch.Tensor, *args, **kwargs):
        return inner.grads(state, rows(images), *args, **kwargs)

    def summarize(state: Pytree, images: torch.Tensor, *args, **kwargs):
        return inner.summarize(state, rows(images), *args, **kwargs)

    fns = dataclasses.replace(inner, sample=sample, eval_losses=eval_losses)
    if sp is not None:
        fns = dataclasses.replace(fns, train_step=train_step, grads=grads,
                                  summarize=summarize)
    programs = {"init": fns.init, "train_step": fns.train_step,
                "multi_step": multi_step, "sampler": sample,
                "summarize": fns.summarize, "eval_losses": eval_losses,
                "gen_fakes": fns.gen_fakes, "d_update": fns.d_update,
                "g_update": fns.g_update}
    par = ParallelTrain(cfg=cfg, local_cfg=local_cfg, world=world,
                        mesh=mesh, fns=fns, programs=programs)
    return par
