"""The height-sharded step of the spatial mesh (the port's form of the JAX
gspmd step under `MeshConfig(model > 1, spatial=True)`,
`dcgan_tpu/parallel/api.py:140-185` and `parallel/sharding.py:63-77`).

The world's ranks form a (data, model) grid, rank r at data index r //
model and model index r % model (JAX's `reshape(data, model)`). Every 4-D
activation is [B / data, H / model, W, C] on its rank: the batch split
over the data axis and the image's rows over the model axis, JAX's image
sharding `P("data", "model", None, None)`. `Spatial` is one rank's view
of that layout, and the nets (models/dcgan.py) take it as `spatial=`:

- conv and deconv (ops/layers.py) take `halo(x, top, bottom)`: the rows
  above and below the rank's block that the kernel reaches, sent by the
  neighbours that own them, and zeros past the image's edge, where the
  unsharded op pads (the global SAME padding, applied at the edge ranks
  only). `_Halo` is an autograd Function whose backward sends each halo
  row's cotangent back to its owner, which adds it in. A stage whose
  block is shorter than its halo (a 4-row map over 4 ranks holds one row
  a rank) is gathered instead: the whole map all-gathered over the model
  axis and the rank's window cut out, its backward an all-reduce of the
  window's cotangent placed in the whole map. Either way a rank's rows
  equal the unsharded op's rows, up to the order of the sums;
- BatchNorm averages its moments over the whole data x model world (each
  rank holds the same number of pixels), the step's `group`;
- G's projection from z runs whole on every model rank, which keeps its
  rows (`rows`); z is the same across a model group (the gspmd draws
  give each rank the rows of its data index);
- D's last linear (`head`) takes the partial product of the rank's rows
  with their rows of the weight (the bias on model index 0 alone) and
  sums it over the model axis; its backward passes the cotangent
  through, since the loss, and so the cotangent, is the same on every
  model rank;
- the attention runs over `ring`, the model axis's `GroupRing`
  (ops/attention.py: ring, Ulysses, ring x flash);
- a weight's gradient is the sum of the ranks' partial gradients over
  the model axis (each rank differentiates through its own rows) and
  their mean over the data axis: one all-reduce over the world, divided
  by the data axis's size (`grad_count`). Everything a model group
  shares (z, the losses) enters the loss once a rank, so no term is
  counted twice: the fakes carry the reals' sharding by construction (the
  JAX note at `parallel/api.py:176-181`);
- `gather` puts a map's rows back together over the model axis (the
  sampler's images, then gathered over the data axis).

The process groups of the two axes are formed once per world and mesh
(`axis_groups`): the model group of each data index and the data group
of each model index, every rank taking part in every `new_group` call.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from dcgan_tpu_torch.parallel.collectives import GroupRing, \
    all_reduce_sum_, exchange, gather_rows

Pytree = dict

# (world group, data, model) -> the rank's (model group, model ranks,
# data group, data ranks)
_GROUPS: Dict[tuple, tuple] = {}

# halo message tags: rows travelling down (to the next model index) and
# up (to the previous), in the forward and the backward
_DOWN, _UP, _DOWN_GRAD, _UP_GRAD = 0, 1, 2, 3


def axis_groups(world, data: int, model: int) -> tuple:
    """(model group, its global ranks in model order, data group, its
    global ranks in data order) of `world`'s rank on a data x model grid,
    formed on first use: every rank calls `new_group` for every group, in
    one order."""
    import torch.distributed as dist

    key = (world.group, data, model)
    if key not in _GROUPS:
        model_groups = [
            dist.new_group(list(range(d * model, (d + 1) * model)))
            for d in range(data)]
        data_groups = [dist.new_group(list(range(m, data * model, model)))
                       for m in range(model)]
        d, m = divmod(world.rank, model)
        mine = (model_groups[d], tuple(range(d * model, (d + 1) * model)),
                data_groups[m], tuple(range(m, data * model, model)))
        _GROUPS[key] = mine
    return _GROUPS[key]


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp, top, bottom):
        ctx.sp, ctx.top, ctx.bottom = sp, top, bottom
        return sp._halo_fwd(x, top, bottom)

    @staticmethod
    def backward(ctx, g):
        return (ctx.sp._halo_bwd(g.contiguous(), ctx.top, ctx.bottom),
                None, None, None)


class _SumOverModel(torch.autograd.Function):
    """The sum over the model axis of a partial product; the cotangent,
    the same on every model rank, passes through."""

    @staticmethod
    def forward(ctx, t, group):
        return all_reduce_sum_(group, t.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


@dataclasses.dataclass(frozen=True, eq=False)
class Spatial:
    """One rank's place on the spatial mesh: model index `index` of `n`
    (the rows it holds), data index `data_index` of `data`, and the
    groups of its two axes."""

    n: int
    index: int
    data: int
    data_index: int
    model_group: object
    model_ranks: Tuple[int, ...]
    data_group: object
    ring: GroupRing

    # -- rows ---------------------------------------------------------------

    def local(self, height: int) -> int:
        """Rows of a `height`-row map that one rank holds."""
        if height % self.n:
            raise ValueError(f"a {height}-row map does not split over the "
                             f"{self.n}-way model axis")
        return height // self.n

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's rows (dim 1) of a whole [B, H, ...] map."""
        h = self.local(x.shape[1])
        return x.narrow(1, self.index * h, h)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole map from every rank's rows (dim 1), on every rank of
        the model axis; not differentiable."""
        parts = gather_rows(self.model_group, x.contiguous())
        return torch.cat(parts.chunk(self.n, 0), 1)

    # -- halo -------------------------------------------------------------

    def halo(self, x: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
        """[B, h, ...] -> [B, top + h + bottom, ...]: the rank's rows with
        the `top` rows above and the `bottom` rows below them, zeros past
        the image's edge; differentiable."""
        if top == 0 and bottom == 0:
            return x
        return _Halo.apply(x.contiguous(), self, top, bottom)

    def _peer(self, step: int) -> int:
        return self.model_ranks[self.index + step]

    def _gathers(self, h: int, top: int, bottom: int) -> bool:
        """Whether the stage is gathered: a block shorter than its halo
        needs rows of ranks past its neighbours."""
        return h < max(top, bottom)

    def _window(self, h: int, top: int, bottom: int) -> Tuple[int, int]:
        """The rank's window [start, stop) in the whole map's rows."""
        return self.index * h - top, (self.index + 1) * h + bottom

    def _halo_fwd(self, x: torch.Tensor, top: int, bottom: int
                  ) -> torch.Tensor:
        b, h = x.shape[0], x.shape[1]
        if self._gathers(h, top, bottom):
            whole = self.gather(x)
            start, stop = self._window(h, top, bottom)
            big = whole.shape[1]
            parts = [whole.new_zeros((b, max(0, -start), *x.shape[2:])),
                     whole[:, max(start, 0):min(stop, big)],
                     whole.new_zeros((b, max(0, stop - big), *x.shape[2:]))]
            return torch.cat(parts, 1)
        above = x.new_zeros((b, top, *x.shape[2:]))
        below = x.new_zeros((b, bottom, *x.shape[2:]))
        sends: List[tuple] = []
        recvs: List[tuple] = []
        if self.index > 0:
            # my first rows are the previous rank's bottom halo
            if bottom:
                sends.append((self._peer(-1), x[:, :bottom], _UP))
            if top:
                recvs.append((self._peer(-1), above, _DOWN))
        if self.index < self.n - 1:
            if top:
                sends.append((self._peer(1), x[:, h - top:], _DOWN))
            if bottom:
                recvs.append((self._peer(1), below, _UP))
        exchange(self.model_group, sends, recvs)
        return torch.cat([above, x, below], 1)

    def _halo_bwd(self, g: torch.Tensor, top: int, bottom: int
                  ) -> torch.Tensor:
        b = g.shape[0]
        h = g.shape[1] - top - bottom
        if self._gathers(h, top, bottom):
            start, stop = self._window(h, top, bottom)
            big = h * self.n
            whole = g.new_zeros((b, big, *g.shape[2:]))
            lo, hi = max(start, 0), min(stop, big)
            whole[:, lo:hi] = g[:, lo - start:hi - start]
            all_reduce_sum_(self.model_group, whole)
            return whole[:, self.index * h:(self.index + 1) * h].clone()
        gx = g[:, top:top + h].clone()
        sends: List[tuple] = []
        recvs: List[tuple] = []
        from_below = g.new_empty((b, top, *g.shape[2:]))
        from_above = g.new_empty((b, bottom, *g.shape[2:]))
        if self.index > 0:
            # the top halo's cotangent belongs to the previous rank's last
            # rows; the previous rank's bottom halo's, to my first rows
            if top:
                sends.append((self._peer(-1), g[:, :top], _UP_GRAD))
            if bottom:
                recvs.append((self._peer(-1), from_above, _DOWN_GRAD))
        if self.index < self.n - 1:
            if bottom:
                sends.append((self._peer(1), g[:, top + h:], _DOWN_GRAD))
            if top:
                recvs.append((self._peer(1), from_below, _UP_GRAD))
        exchange(self.model_group, sends, recvs)
        if self.index < self.n - 1 and top:
            gx[:, h - top:] += from_below
        if self.index > 0 and bottom:
            gx[:, :bottom] += from_above
        return gx

    # -- the head ---------------------------------------------------------

    def head(self, params: Pytree, x: torch.Tensor,
             compute_dtype: Optional[torch.dtype]) -> torch.Tensor:
        """D's last linear on the rank's rows of the NHWC-flattened map
        [B, h * W * C]: the partial product with the weight's rows of
        those pixels (plus the bias on model index 0), summed in f32 over
        the model axis, in the compute dtype as `linear_apply` returns
        it."""
        w, b = params["w"], params["b"]
        width = x.shape[1]
        w = w.narrow(0, self.index * width, width)
        if compute_dtype is not None:
            x, w = x.to(compute_dtype), w.to(compute_dtype)
        part = torch.matmul(x, w)
        # the bias once: times 0 off model index 0, where its gradient is
        # then 0 (and the graph still reaches it)
        part = part + b.to(part.dtype) * (1.0 if self.index == 0 else 0.0)
        return _SumOverModel.apply(part.float(), self.model_group) \
            .to(part.dtype)

    # -- gradients ----------------------------------------------------------

    @property
    def grad_count(self) -> int:
        """The divisor of the world's gradient sum: the data axis's size
        (the sum over the model axis, the mean over the data axis)."""
        return self.data


def make_spatial(world, data: int, model: int) -> Spatial:
    """`world`'s rank on the data x model grid."""
    model_group, model_ranks, data_group, _ = axis_groups(world, data,
                                                          model)
    d, m = divmod(world.rank, model)
    return Spatial(n=model, index=m, data=data, data_index=d,
                   model_group=model_group, model_ranks=model_ranks,
                   data_group=data_group,
                   ring=GroupRing(model_group, model_ranks, m))
