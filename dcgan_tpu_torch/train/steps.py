"""The GAN train step: two Adam optimizers over dicts of tensors (the
counterpart of `dcgan_tpu/train/steps.py:72-157,404-730,964-1021`).

`train_step(state, images, z, draws)` is the JAX package's fused step, on
the BCE, hinge or WGAN-GP loss (`cfg.loss`), with R1, n_critic critic
updates, gradient accumulation and DiffAugment (`make_train_step` lists
how each follows the JAX step), in both update modes:
- "sequential" (default): D's update first, then G's against the updated D
  and its BN state;
- "fused": both gradients at the pre-update params.
D runs on the real batch and then on the fake one, each with its own batch
statistics, the BN state chaining from the first to the second; the two
batches are never concatenated. In the D step the fake batch comes from G
in train mode without gradients and G's state update (BN moments, SN
vectors) is discarded, as in JAX; likewise D's in the G step.
Gradients are taken with `torch.autograd.grad` with respect to one net's
leaves at a time, so the other net's weights get none.

The JAX step draws z, the critic iterations' z, WGAN-GP's interpolation
weights and the augmentations inside the step from its key; here they are
arguments (the trainer draws them from one `torch.Generator` per step, z
first, then `draw_step`), so the parity tests can hand both packages the
same draws, and a captured step reads them from its input slots.
`eval_losses` and `summarize` are the JAX package's loss probe and
activation summaries.

A conditional model (`num_classes` > 0) takes the real batch's `labels`
[B] in every function but the stage programs (which stay unconditional,
as the JAX package's do): the fakes of D's step and of G's step are
generated on those labels, every critic iteration uses the same batch and
labels, grad_accum splits the labels by the rows it splits the images by,
D reads them in every call (the penalties' critic too), and `sample`
takes the labels of its z rows.

`gen_fakes`, `d_update` and `g_update` are the JAX package's pipelined
stage programs (`:744-946`, train/gd_pipeline.py drives them): the fused
step's own D and G code, with D's fake batch taken from a stack that the
previous step's G update made (its G-loss forward's images and, with
n_critic > 1, fresh slots from the same weights); their draws come from
`draw_stages`.

The state is a nested dict of tensors with the JAX state's names:
    {"params": {"gen", "disc"}, "bn": {"gen", "disc"},
     "opt": {"gen": {"mu", "nu", "count"}, "disc": {...}},
     "ema_gen": ..., "step": int32}
`convert.train_state_from_jax` builds it from the JAX pytree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from dcgan_tpu_torch.config import TrainConfig, parse_policy
from dcgan_tpu_torch.device import resolve_device
from dcgan_tpu_torch.models.dcgan import discriminator_apply, gan_init, \
    generator_apply, sampler_apply
from dcgan_tpu_torch.ops.augment import diff_augment, draw_augment
from dcgan_tpu_torch.parallel.collectives import mean_scalars, mean_tree
from dcgan_tpu_torch.train.losses import bce_gan_losses, \
    gradient_penalty, hinge_losses, r1_penalty, wgan_losses
from dcgan_tpu_torch.utils.metrics import activation_stats

Pytree = dict
Schedule = Callable[[torch.Tensor], torch.Tensor]


def tree_map(fn: Callable, tree: Pytree, *rest: Pytree) -> Pytree:
    """fn over the leaves of nested dicts with the same keys."""
    return {k: tree_map(fn, v, *(r[k] for r in rest))
            if isinstance(v, dict) else fn(v, *(r[k] for r in rest))
            for k, v in tree.items()}


def tree_leaves(tree: Pytree) -> List[torch.Tensor]:
    """The leaves in sorted-key order (jax's flatten order for dicts)."""
    out: List[torch.Tensor] = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(tree_leaves(v) if isinstance(v, dict) else [v])
    return out


def tree_unflatten(like: Pytree, leaves: List[torch.Tensor]) -> Pytree:
    """A tree shaped like `like` holding `leaves` in tree_leaves' order."""
    it = iter(leaves)

    def build(tree):
        return {k: build(tree[k]) if isinstance(tree[k], dict) else next(it)
                for k in sorted(tree)}
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


# ---------------------------------------------------------------------------
# Learning-rate schedules and Adam, in optax's arithmetic
# ---------------------------------------------------------------------------

class LrBackoff:
    """The nets' base learning rates times the rollback LR backoff's
    scale, each a 0-d f32 tensor per device that the schedule reads
    (`make_lr_schedule`'s `base_rate`). `set_scale` fills them in place,
    so a captured step replays at the new rates and nothing is captured
    again. A cell holds f32(base * scale), the value the JAX package's
    rebuilt schedule (`warmup.backoff_config`) starts from; at scale 1 it
    is f32(base), the constant optax's schedule multiplies by."""

    def __init__(self, rates: Dict[str, float]):
        self.rates = dict(rates)
        self.scale = 1.0
        self._cells: Dict[Tuple[str, torch.device], torch.Tensor] = {}

    def cell(self, net: str, device: torch.device) -> torch.Tensor:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            # "cuda" and a tensor's "cuda:0" are one cell
            device = torch.device("cuda", torch.cuda.current_device())
        key = (net, device)
        t = self._cells.get(key)
        if t is None:
            t = self._cells[key] = torch.full(
                (), self.rates[net] * self.scale, dtype=torch.float32,
                device=device)
        return t

    def rate(self, net: str) -> Callable[[torch.device], torch.Tensor]:
        """`net`'s cell on a device, as `make_lr_schedule` reads it."""
        return lambda device: self.cell(net, device)

    def set_scale(self, scale: float) -> None:
        self.scale = scale
        with torch.no_grad():
            for (net, _), t in self._cells.items():
                t.fill_(self.rates[net] * scale)


def make_lr_schedule(cfg: TrainConfig, base_lr: float, *,
                     updates_per_step: int = 1,
                     base_rate: Optional[Callable[[torch.device],
                                                  torch.Tensor]] = None
                     ) -> Schedule:
    """Update count (an int32 tensor) -> f32 learning rate, optax's
    constant / linear / cosine schedules with an optional linear warmup
    (`join_schedules`), decaying to 0 over max_steps. The base rate is
    read from the 0-d device tensor `base_rate` returns (the rollback LR
    backoff's cell, LrBackoff), a cell of `base_lr` of the schedule's own
    when None: the f32 operations of a baked-in base_lr on its f32
    value."""
    warmup = cfg.warmup_steps * updates_per_step
    decay_steps = max(1, cfg.max_steps * updates_per_step - warmup)
    if base_rate is None:
        base_rate = LrBackoff({"base": base_lr}).rate("base")

    def base(count):
        return base_rate(count.device)

    def zero(count):
        return 0.0

    def linear(init, end, steps: int) -> Schedule:
        def schedule(count):
            c = torch.clamp(count, 0, steps)
            frac = 1.0 - c.float() / steps
            return (init(count) - end(count)) * frac + end(count)
        return schedule

    def cosine(count):
        c = torch.minimum(count.float(), torch.full(
            (), float(decay_steps), device=count.device))
        decayed = 0.5 * (1.0 + torch.cos(math.pi * c / float(decay_steps)))
        return base(count) * decayed

    main = {"constant": base,
            "linear": linear(base, zero, decay_steps),
            "cosine": cosine}[cfg.lr_schedule]
    if not warmup:
        return main
    ramp = linear(zero, base, warmup)

    def joined(count):
        return torch.where(count < warmup, ramp(count), main(count - warmup))
    return joined


@dataclasses.dataclass(frozen=True)
class Adam:
    """optax.chain(clip_by_global_norm or identity, adam) over a dict of
    tensors. State {"mu", "nu", "count"} maps one to one onto optax's
    ScaleByAdamState (whose count ScaleByScheduleState repeats)."""

    lr: Schedule
    b1: float
    b2: float = 0.999
    eps: float = 1e-8
    grad_clip: float = 0.0
    mu_dtype: Optional[torch.dtype] = None  # None: the params' dtype

    def init(self, params: Pytree) -> Pytree:
        device = tree_leaves(params)[0].device
        return {"mu": tree_map(lambda p: torch.zeros_like(
                    p, dtype=self.mu_dtype or p.dtype), params),
                "nu": tree_map(torch.zeros_like, params),
                "count": torch.zeros((), dtype=torch.int32, device=device)}

    @torch.no_grad()
    def step(self, params: Pytree, grads: Pytree, state: Pytree
             ) -> Tuple[Pytree, Pytree]:
        """(new params, new state), in optax's order: clip, mu, nu,
        count + 1, the bias corrections 1 - b^t, mu_hat / (sqrt(nu_hat) +
        eps), times -lr(count), then p + u. Each operation rounds in
        optax's dtype: with an f32 mu over bf16 params (mu_dtype) the
        update is f32 and p + u is cast back to the params' dtype.

        Each elementwise operation runs over all the leaves at once
        (`torch._foreach_*`, a few launches for the whole tree instead of
        one per leaf), with the per-leaf arithmetic's operations in its
        order, so the result is the same bits; no fused foreach op
        (addcmul, addcdiv, lerp) is used, since each rounds once where
        the per-leaf form rounds twice."""
        ps, gs = tree_leaves(params), tree_leaves(grads)
        dtype = ps[0].dtype
        if self.grad_clip > 0:
            g_norm = torch.sqrt(sum(torch.sum(sq) for sq in
                                    torch._foreach_mul(gs, gs)))
            keep = g_norm < self.grad_clip
            scaled = torch._foreach_mul(
                torch._foreach_div(gs, g_norm.to(dtype)), self.grad_clip)
            gs = [torch.where(keep, g, c) for g, c in zip(gs, scaled)]
        b1, b2 = self.b1, self.b2
        mu = torch._foreach_add(torch._foreach_mul(gs, 1 - b1),
                                torch._foreach_mul(
                                    tree_leaves(state["mu"]), b1))
        sq = torch._foreach_mul(gs, gs)
        torch._foreach_mul_(sq, 1 - b2)
        nu = torch._foreach_add(sq, torch._foreach_mul(
            tree_leaves(state["nu"]), b2))
        count = state["count"]
        count_inc = count + 1
        t = count_inc.to(torch.float32)
        # f32 constants filled on the device: no host copy, so the step
        # never waits for the stream
        bc1 = 1 - torch.full((), b1, dtype=torch.float32,
                             device=t.device) ** t
        bc2 = 1 - torch.full((), b2, dtype=torch.float32,
                             device=t.device) ** t
        step_size = -self.lr(count)
        # u = (mu / bc1) / (sqrt(nu / bc2) + eps); p + step_size * u
        den = torch._foreach_div(nu, bc2.to(nu[0].dtype))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        u = torch._foreach_div(mu, bc1.to(mu[0].dtype))
        torch._foreach_div_(u, den)
        torch._foreach_mul_(u, step_size.to(u[0].dtype))
        new_params = torch._foreach_add(ps, u)
        if new_params[0].dtype != dtype:
            new_params = [p.to(dtype) for p in new_params]
        return (tree_unflatten(params, new_params),
                {"mu": tree_unflatten(params, mu),
                 "nu": tree_unflatten(params, nu), "count": count_inc})


def make_optimizer(cfg: TrainConfig, lr: Optional[float] = None, *,
                   updates_per_step: int = 1,
                   base_rate: Optional[Callable[[torch.device],
                                                torch.Tensor]] = None
                   ) -> Adam:
    """Adam(lr=2e-4, b1=0.5, b2=0.999, eps=1e-8), the reference's optimizer;
    `lr` overrides the base rate (per-net rates), the schedule applies on
    top (`base_rate`: see make_lr_schedule); grad_clip > 0 clips by global
    norm first."""
    base_lr = cfg.learning_rate if lr is None else lr
    # the bf16 and fp8 policies keep Adam's first moment in f32 (optax's
    # mu_dtype): a small signed running mean that bf16 rounding biases
    mu_dtype = torch.float32 if cfg.precision in ("bf16", "fp8") else None
    return Adam(lr=make_lr_schedule(cfg, base_lr,
                                    updates_per_step=updates_per_step,
                                    base_rate=base_rate),
                b1=cfg.beta1, grad_clip=cfg.grad_clip, mu_dtype=mu_dtype)


def make_lr_backoff(cfg: TrainConfig) -> LrBackoff:
    """The rate cells of both nets' base rates (the rollback LR backoff
    moves them; at scale 1 the step reads the configured rates)."""
    return LrBackoff({
        "gen": cfg.learning_rate if cfg.g_learning_rate is None
        else cfg.g_learning_rate,
        "disc": cfg.learning_rate if cfg.d_learning_rate is None
        else cfg.d_learning_rate})


def init_train_state(cfg: TrainConfig, *, seed: Optional[int] = None,
                     device: Union[str, torch.device] = "cuda") -> Pytree:
    """The full training state: both nets' params and BN state from a
    seeded init, both Adam states at zero, the EMA mirror of G, step 0."""
    dev = resolve_device(device)
    params, bn = gan_init(cfg.model, seed=cfg.seed if seed is None else seed,
                          device=dev)
    opt_g = make_optimizer(cfg, cfg.g_learning_rate)
    opt_d = make_optimizer(cfg, cfg.d_learning_rate,
                           updates_per_step=cfg.n_critic)
    return {
        "params": params,
        "bn": bn,
        "opt": {"gen": opt_g.init(params["gen"]),
                "disc": opt_d.init(params["disc"])},
        "ema_gen": tree_map(torch.clone, params["gen"]),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def lazy_r1(cfg: TrainConfig) -> bool:
    """Whether R1 runs on every r1_interval-th step only."""
    return cfg.r1_gamma > 0.0 and cfg.r1_interval > 1


def penalty_due(cfg: TrainConfig, step: int) -> bool:
    """Whether the step from state step `step` runs the critic's penalty:
    every step for WGAN-GP and R1 at r1_interval 1, every r1_interval-th
    step for lazy R1 (`dcgan_tpu/train/steps.py:460-473`), never without
    a penalty."""
    if cfg.loss == "wgan-gp":
        return True
    if cfg.r1_gamma > 0.0:
        return step % cfg.r1_interval == 0
    return False


# joins the rollback count to a rolled-back run's step-draw seeds
_REKEY = 0x726F6C6C


def step_generator(cfg: TrainConfig, step: int, device: torch.device,
                   *tag: int, rekey: int = 0) -> torch.Generator:
    """The generator of step `step`'s draws, seeded from (seed, step,
    *tag), and from the rollback count `rekey` when it is > 0 (the JAX
    trainer's `fold_in(key(seed + 2), rollbacks)`), so a run that never
    rolls back draws what it always drew."""
    entropy = [cfg.seed & 0xFFFFFFFFFFFFFFFF, step, *tag]
    if rekey:
        entropy += [_REKEY, rekey]
    seed = np.random.SeedSequence(entropy).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(seed[0]))


def draw_step(cfg: TrainConfig, gen: torch.Generator,
              batch: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The random inputs of one step besides z, drawn from `gen` on its
    device, as a flat dict of tensors (empty for a config that uses no
    randomness beyond z):

    - "critic<i>/z" [B, z_dim]: critic iteration i's fresh z (n_critic > 1;
      with n_critic 1 the critic uses the step's z);
    - "critic<i>/eps" [B]: WGAN-GP's interpolation weights, U(0, 1);
    - "critic<i>/real/<aug>", "critic<i>/fake/<aug>": the DiffAugment draws
      (ops/augment.py::draw_augment) of D's real and fake batch;
    - "g/<aug>": those of the fake batch of G's step.

    Per-example draws are [B]: under grad_accum, microbatch j takes rows
    j*B/K .. (j+1)*B/K of each, as it takes those of the images and z."""
    b = cfg.batch_size if batch is None else batch
    m = cfg.model
    policy = parse_policy(cfg.diffaug)
    dev = gen.device
    out: Dict[str, torch.Tensor] = {}
    for i in range(cfg.n_critic):
        p = f"critic{i}/"
        if cfg.n_critic > 1:
            out[p + "z"] = torch.rand((b, m.z_dim), generator=gen,
                                      device=dev) * 2.0 - 1.0
        if cfg.loss == "wgan-gp":
            out[p + "eps"] = torch.rand((b,), generator=gen, device=dev)
        for which in ("real", "fake"):
            for k, v in draw_augment(policy, b, m.output_size,
                                     gen).items():
                out[f"{p}{which}/{k}"] = v
    for k, v in draw_augment(policy, b, m.output_size, gen).items():
        out[f"g/{k}"] = v
    return out


def draw_stages(cfg: TrainConfig, gen: torch.Generator,
                batch: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The random inputs of one pipelined step (the stage programs'
    counterpart of the JAX key schedule `fold_in(key, 0 | 1 | 2)`, D, G
    and the fill), drawn from `gen` on its device as a flat dict, in the
    order listed:

    - "d/critic<i>/eps" (WGAN-GP), "d/critic<i>/real/<aug>",
      "d/critic<i>/fake/<aug>": critic iteration i's draws in `d_update`;
    - "g/z" [B, z_dim]: G's z in `g_update`; "g/extra_z" [n_critic - 1,
      B, z_dim] (n_critic > 1): the z of the next stack's slots 1..;
      "g/aug/<aug>": the augmentation of G's fake batch;
    - "fill/z" [n_critic, B, z_dim]: `gen_fakes`' z per slot, drawn every
      step so that a captured fill reads a slot like the others.

    Per-example draws are [B], split by rows under grad_accum as in
    `draw_step`."""
    b = cfg.batch_size if batch is None else batch
    m = cfg.model
    policy = parse_policy(cfg.diffaug)
    dev = gen.device

    def uniform_z(*lead):
        return torch.rand((*lead, b, m.z_dim), generator=gen,
                          device=dev) * 2.0 - 1.0

    out: Dict[str, torch.Tensor] = {}
    for i in range(cfg.n_critic):
        p = f"d/critic{i}/"
        if cfg.loss == "wgan-gp":
            out[p + "eps"] = torch.rand((b,), generator=gen, device=dev)
        for which in ("real", "fake"):
            for k, v in draw_augment(policy, b, m.output_size,
                                     gen).items():
                out[f"{p}{which}/{k}"] = v
    out["g/z"] = uniform_z()
    if cfg.n_critic > 1:
        out["g/extra_z"] = uniform_z(cfg.n_critic - 1)
    for k, v in draw_augment(policy, b, m.output_size, gen).items():
        out[f"g/aug/{k}"] = v
    out["fill/z"] = uniform_z(cfg.n_critic)
    return out


def _sub(draws: Dict[str, torch.Tensor], prefix: str
         ) -> Dict[str, torch.Tensor]:
    """The draws under `prefix`, with the prefix taken off."""
    return {k[len(prefix):]: v for k, v in draws.items()
            if k.startswith(prefix)}


@dataclasses.dataclass(frozen=True)
class TrainStepFns:
    """The functions of one TrainConfig."""
    train_step: Callable  # (state, images, z, draws=None, labels=None, *,
                          # penalty=None) -> (state, metrics)
    grads: Callable       # (state, images, z, draws=None, labels=None, *,
                          # penalty=None) -> ({"gen", "disc"}, metrics)
    sample: Callable      # (state, z, labels=None) -> images (running-stat
                          # BN)
    init: Callable        # (seed=None, device="cuda") -> state
    eval_losses: Callable  # (state, images, z, eps=None, labels=None) ->
                           # metrics, no update
    summarize: Callable   # (state, images, z, labels=None) -> per-layer
                          # activation stats
                          # (utils/metrics.py::activation_stats)
    gen_fakes: Callable   # (state, draws) -> fake stack (the fill)
    d_update: Callable    # (state, images, fakes, draws, *, penalty=None)
                          # -> (state, D's metrics)
    g_update: Callable    # (state, draws) -> (state, next fake stack,
                          # {"g_loss"})
    lr_backoff: Optional[LrBackoff] = None  # both nets' base-rate cells
                                            # (make_lr_backoff)
    group: Optional[object] = None  # the process group the step's
                                    # collectives run over (None: none)


def _leaves_with_grad(tree: Pytree) -> Pytree:
    return tree_map(lambda p: p.detach().requires_grad_(True), tree)


def _grad(loss: torch.Tensor, leaves: Pytree) -> Pytree:
    """d loss / d leaves as a tree of the leaves' shape; frees the graph."""
    flat = tree_leaves(leaves)
    grads = iter(torch.autograd.grad(loss, flat))
    by_id = {id(p): g for p, g in zip(flat, grads)}
    return tree_map(lambda p: by_id[id(p)], leaves)


def make_train_step(cfg: TrainConfig, group=None,
                    spatial=None) -> TrainStepFns:
    """The step functions of `cfg`, following `dcgan_tpu/train/steps.py`
    line by line; with a process `group`, the per-rank program of the
    data-parallel step (the JAX step with `axis_name` set): every
    BatchNorm's batch moments, both nets' gradients (each update's, after
    the grad_accum mean) and the losses averaged over the ranks
    (parallel/collectives.py), `summarize`'s statistics global. `cfg`'s
    batch is then the rank's share (parallel/api.py):

    - D's loss (`:404-473`): the fake batch from G in train mode without
      gradients (G's state update discarded), D on the real batch, then on
      the fake one, chaining its BN state, each DiffAugmented with its own
      draws; with a penalty, the critic at train=False (running BN
      statistics) on the raw inputs: WGAN-GP's weighted by gp_weight on
      interpolates, R1's by gamma / 2 on the reals (lazy R1: gamma * k / 2
      on the steps `penalty_due` picks, none on the others);
    - n_critic > 1 (`:658-700`): that many Adam updates of D, each on its
      own z, interpolation weights and augmentation draws against the same
      real batch, D's BN state chained across them; the metrics are the
      last iteration's; G then trains on the step's own z;
    - grad_accum K > 1 (`:508-632`): each update's gradient is the mean
      of K microbatches' at fixed params, accumulated in f32 and cast to
      the params' dtype, the BN state chained through the microbatches;
      with n_critic > 1 each critic iteration accumulates its own;
    - G's loss through D at train=True on the augmented fake batch, G's
      gradient flowing through the augmentation.

    Under a spatial mesh (`spatial`, parallel/spatial.py) the images and
    every map are the rank's rows, the nets run their height-sharded form,
    and a gradient is summed over the world and divided by the data axis's
    size (the sum over the model axis of the ranks' partial gradients, the
    mean over the data axis); `summarize`'s statistics of the maps are the
    world's, of z and D's outputs (the same on every model rank) the data
    axis's.

    A config that uses none of these takes the step of n_critic 1 without
    accumulation, augmentation or penalty: the same operations as before
    they existed. The step's randomness comes in as `z` and the `draws` of
    `draw_step`; `penalty` (lazy R1) says whether this step runs the
    penalty, `penalty_due(cfg, int(state["step"]))` when None."""
    mcfg = cfg.model
    backoff = make_lr_backoff(cfg)
    opt_g = make_optimizer(cfg, cfg.g_learning_rate,
                           base_rate=backoff.rate("gen"))
    opt_d = make_optimizer(cfg, cfg.d_learning_rate,
                           updates_per_step=cfg.n_critic,
                           base_rate=backoff.rate("disc"))
    wgan = cfg.loss == "wgan-gp"
    r1 = cfg.r1_gamma > 0.0
    lazy = lazy_r1(cfg)
    penalty_key = "gp" if wgan else "r1" if r1 else None
    policy = parse_policy(cfg.diffaug)
    n_micro = cfg.grad_accum
    draw_names = frozenset(draw_step(cfg, torch.Generator(), batch=1))
    stage_names = frozenset(draw_stages(cfg, torch.Generator(), batch=1))
    grad_count = None if spatial is None else spatial.grad_count

    def reduce_grads(grads: Pytree) -> Pytree:
        return mean_tree(group, grads, grad_count)

    def check_draws(draws: Optional[Dict[str, torch.Tensor]]
                    ) -> Dict[str, torch.Tensor]:
        draws = draws or {}
        if set(draws) != draw_names:
            raise ValueError(
                f"the step's draws are {sorted(draws)}, the config's "
                f"{sorted(draw_names)} (steps.draw_step)")
        return draws

    def losses(real_logits, fake_logits):
        if cfg.loss == "hinge":
            return hinge_losses(real_logits, fake_logits)
        if wgan:
            return wgan_losses(real_logits, fake_logits)
        return bce_gan_losses(real_logits, fake_logits,
                              label_smoothing=cfg.label_smoothing)

    def aug(x: torch.Tensor, draws: Dict[str, torch.Tensor]
            ) -> torch.Tensor:
        return diff_augment(x, draws, policy) if policy else x

    def micro(t: torch.Tensor, j: int) -> torch.Tensor:
        """Microbatch j of a batch-leading tensor (the whole of it at
        K = 1)."""
        if n_micro == 1:
            return t
        m = t.shape[0] // n_micro
        return t.narrow(0, j * m, m)

    def micro_draws(draws: Dict[str, torch.Tensor], j: int
                    ) -> Dict[str, torch.Tensor]:
        return {k: micro(v, j) for k, v in draws.items()}

    def micro_labels(labels: Optional[torch.Tensor], j: int
                     ) -> Optional[torch.Tensor]:
        return None if labels is None else micro(labels, j)

    def make_fake(g_params: Pytree, g_bn: Pytree, z: torch.Tensor,
                  labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        """G's images of z in train mode, without gradients, G's state
        update discarded (D's fake batch)."""
        with torch.no_grad():
            return generator_apply(g_params, g_bn, z, cfg=mcfg, train=True,
                                   labels=labels, group=group,
                                   spatial=spatial)[0]

    def d_loss_fn(d_params: Pytree, g_params: Pytree, bn: Pytree,
                  images: torch.Tensor, z: torch.Tensor,
                  draws: Dict[str, torch.Tensor], penalty: bool,
                  r1_weight: float, augment: bool = True,
                  labels: Optional[torch.Tensor] = None):
        """(D's loss, D's new BN state, d_real, d_fake, the penalty or
        None) on G's fake batch of z (and of the real batch's labels)."""
        return d_loss_on_fake(d_params, bn, images,
                              make_fake(g_params, bn["gen"], z, labels),
                              draws, penalty, r1_weight, augment, labels)

    def d_loss_on_fake(d_params: Pytree, bn: Pytree, images: torch.Tensor,
                       fake: torch.Tensor, draws: Dict[str, torch.Tensor],
                       penalty: bool, r1_weight: float,
                       augment: bool = True,
                       labels: Optional[torch.Tensor] = None):
        """d_loss_fn on a fake batch already made (the fused step makes it
        just before; `d_update` takes it from the fake stack); `draws`
        holds "eps" and the "real/" and "fake/" augmentation draws of this
        batch (augment=False: the probe's unaugmented D)."""
        def d_input(x, which):
            return aug(x, _sub(draws, which)) if augment else x

        _, real_logits, d_bn1 = discriminator_apply(
            d_params, bn["disc"], d_input(images, "real/"), cfg=mcfg,
            train=True, labels=labels, group=group, spatial=spatial)
        _, fake_logits, d_bn = discriminator_apply(
            d_params, d_bn1, d_input(fake, "fake/"), cfg=mcfg, train=True,
            labels=labels, group=group, spatial=spatial)
        d_loss, d_real, d_fake, _ = losses(real_logits, fake_logits)
        gp = None
        if wgan or (r1 and penalty):
            # running BN statistics: batch statistics would couple D(x_i)
            # to every x_j, and the penalties are per-example input
            # gradients on the raw (unaugmented) inputs
            def critic(x):
                return discriminator_apply(d_params, bn["disc"], x,
                                           cfg=mcfg, train=False,
                                           labels=labels)[1][:, 0]
            if wgan:
                gp = gradient_penalty(critic, images.float(), fake.float(),
                                      draws["eps"])
                d_loss = d_loss + cfg.gp_weight * gp
            else:
                gp = r1_penalty(critic, images.float())
                d_loss = d_loss + r1_weight * gp
        return d_loss, d_bn, d_real, d_fake, gp

    def accumulate(acc: Optional[List[torch.Tensor]], grads: Pytree
                   ) -> List[torch.Tensor]:
        gs = [g.float() for g in tree_leaves(grads)]
        return gs if acc is None else torch._foreach_add(acc, gs)

    def average(acc: List[torch.Tensor], like: Pytree) -> Pytree:
        """The f32 sum of K gradients as their mean in the params'
        dtypes."""
        return tree_unflatten(like, [
            (a / n_micro).to(p.dtype)
            for a, p in zip(acc, tree_leaves(like))])

    def d_grads(d_params: Pytree, g_params: Pytree, bn: Pytree,
                images: torch.Tensor, z: Optional[torch.Tensor],
                draws: Dict[str, torch.Tensor], penalty: bool,
                fake: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None):
        """D's gradient for one update -> (grads, D's new BN state,
        (d_loss, d_real, d_fake, penalty or None)), the mean of the K
        microbatches' with the BN state chained through them; on G's fake
        batch of z, or on `fake` when given (z unused)."""
        r1_weight = 0.5 * cfg.r1_gamma * (cfg.r1_interval if lazy else 1)

        def loss_of(d_leaves, bn_j, j):
            if fake is None:
                return d_loss_fn(d_leaves, g_params, bn_j, micro(images, j),
                                 micro(z, j), micro_draws(draws, j),
                                 penalty, r1_weight,
                                 labels=micro_labels(labels, j))
            return d_loss_on_fake(d_leaves, bn_j, micro(images, j),
                                  micro(fake, j), micro_draws(draws, j),
                                  penalty, r1_weight,
                                  labels=micro_labels(labels, j))

        if n_micro == 1:
            d_leaves = _leaves_with_grad(d_params)
            loss, d_bn, d_real, d_fake, gp = loss_of(d_leaves, bn, 0)
            # _grad frees the graph before the G step builds its own
            return (reduce_grads(_grad(loss, d_leaves)), d_bn,
                    (loss, d_real, d_fake, gp))
        acc, d_bn, terms = None, bn["disc"], []
        for j in range(n_micro):
            d_leaves = _leaves_with_grad(d_params)
            out = loss_of(d_leaves, {"gen": bn["gen"], "disc": d_bn}, j)
            d_bn = out[1]
            acc = accumulate(acc, _grad(out[0], d_leaves))
            terms.append([t.detach() for t in (out[0], *out[2:4])]
                         + ([out[4].detach()] if out[4] is not None
                            else []))
        means = [torch.stack(col).mean() for col in zip(*terms)]
        gp = means[3] if len(means) > 3 else None
        return reduce_grads(average(acc, d_params)), d_bn, \
            (*means[:3], gp)

    def g_loss_fn(g_params: Pytree, g_bn: Pytree, disc: Pytree,
                  disc_bn: Pytree, z: torch.Tensor,
                  draws: Dict[str, torch.Tensor], augment: bool = True,
                  fakes: Optional[List[torch.Tensor]] = None,
                  labels: Optional[torch.Tensor] = None):
        """(G's loss, G's new BN state); appends G's images, detached, to
        `fakes` when given (`g_update`'s next fake stack)."""
        fake, new_g_bn = generator_apply(g_params, g_bn, z, cfg=mcfg,
                                         train=True, labels=labels,
                                         group=group, spatial=spatial)
        if fakes is not None:
            fakes.append(fake.detach())
        _, fake_logits, _ = discriminator_apply(
            disc, disc_bn, aug(fake, draws) if augment else fake, cfg=mcfg,
            train=True, labels=labels, group=group, spatial=spatial)
        return losses(fake_logits, fake_logits)[3], new_g_bn

    def g_grads(g_params: Pytree, g_bn: Pytree, disc: Pytree,
                disc_bn: Pytree, z: torch.Tensor,
                draws: Dict[str, torch.Tensor],
                fakes: Optional[List[torch.Tensor]] = None,
                labels: Optional[torch.Tensor] = None):
        """G's gradient against (disc, disc_bn) -> (grads, G's new BN
        state, g_loss), the mean of the K microbatches'; G's images of
        each microbatch appended to `fakes` when given."""
        if n_micro == 1:
            g_leaves = _leaves_with_grad(g_params)
            g_loss, new_g_bn = g_loss_fn(g_leaves, g_bn, disc, disc_bn, z,
                                         draws, fakes=fakes, labels=labels)
            return reduce_grads(_grad(g_loss, g_leaves)), new_g_bn, \
                g_loss
        acc, new_g_bn, g_losses = None, g_bn, []
        for j in range(n_micro):
            g_leaves = _leaves_with_grad(g_params)
            g_loss, new_g_bn = g_loss_fn(g_leaves, new_g_bn, disc, disc_bn,
                                         micro(z, j), micro_draws(draws, j),
                                         fakes=fakes,
                                         labels=micro_labels(labels, j))
            acc = accumulate(acc, _grad(g_loss, g_leaves))
            g_losses.append(g_loss.detach())
        return (reduce_grads(average(acc, g_params)), new_g_bn,
                torch.stack(g_losses).mean())

    def metrics_of(d_terms, g_loss=None) -> Dict[str, torch.Tensor]:
        """D's half of the metric row: the losses, and the penalty where
        the config has one (0 on a lazy-R1 step without it); with
        `g_loss`, the whole row. Averaged over the ranks in one
        collective."""
        out = {k: v.detach() for k, v in zip(
            ("d_loss", "d_loss_real", "d_loss_fake"), d_terms[:3])}
        if penalty_key is not None:
            gp = d_terms[3]
            out[penalty_key] = gp.detach() if gp is not None else \
                torch.zeros((), dtype=torch.float32,
                            device=d_terms[0].device)
        if g_loss is not None:
            out["g_loss"] = g_loss.detach()
        return dict(zip(out, mean_scalars(group, list(out.values()))))

    def resolve_penalty(state: Pytree, penalty: Optional[bool]) -> bool:
        if not lazy:
            return wgan or r1
        if penalty is None:
            # a host read of the step: the captured runner passes it
            return penalty_due(cfg, int(state["step"]))
        return penalty

    def check_stage_draws(draws: Dict[str, torch.Tensor], prefix: str
                          ) -> Dict[str, torch.Tensor]:
        got = {k for k in draws if k.startswith(prefix)}
        want = {k for k in stage_names if k.startswith(prefix)}
        if got != want:
            raise ValueError(
                f"the stage's draws are {sorted(got)}, the config's "
                f"{sorted(want)} (steps.draw_stages)")
        return draws

    def ema_of(state: Pytree, new_gen: Pytree) -> Pytree:
        d_ema = cfg.g_ema_decay   # 0: ema_gen mirrors the live weights
        with torch.no_grad():
            # d * e + (1 - d) * p over all the leaves at once
            return tree_unflatten(new_gen, torch._foreach_add(
                torch._foreach_mul(tree_leaves(state["ema_gen"]), d_ema),
                torch._foreach_mul(tree_leaves(new_gen), 1.0 - d_ema)))

    def critic_inputs(z: torch.Tensor, draws: Dict[str, torch.Tensor],
                      i: int):
        """(z, draws) of critic iteration i."""
        d = _sub(draws, f"critic{i}/")
        return (d.pop("z") if cfg.n_critic > 1 else z), d

    def grads(state: Pytree, images: torch.Tensor, z: torch.Tensor,
              draws: Optional[Dict[str, torch.Tensor]] = None,
              labels: Optional[torch.Tensor] = None, *,
              penalty: Optional[bool] = None
              ) -> Tuple[Pytree, Dict[str, torch.Tensor]]:
        """Both nets' gradients at the state's params, as the "fused"
        update mode takes them (G's against the pre-update D): D's of the
        first critic iteration, with its draws; and the losses. The state
        is not changed."""
        draws = check_draws(draws)
        params, bn = state["params"], state["bn"]
        z0, d0 = critic_inputs(z, draws, 0)
        dg, _, d_terms = d_grads(params["disc"], params["gen"], bn, images,
                                 z0, d0, resolve_penalty(state, penalty),
                                 labels=labels)
        gg, _, g_loss = g_grads(params["gen"], bn["gen"], params["disc"],
                                bn["disc"], z, _sub(draws, "g/"),
                                labels=labels)
        return {"gen": gg, "disc": dg}, metrics_of(d_terms, g_loss)

    def train_step(state: Pytree, images: torch.Tensor, z: torch.Tensor,
                   draws: Optional[Dict[str, torch.Tensor]] = None,
                   labels: Optional[torch.Tensor] = None, *,
                   penalty: Optional[bool] = None
                   ) -> Tuple[Pytree, Dict[str, torch.Tensor]]:
        draws = check_draws(draws)
        params, bn = state["params"], state["bn"]
        pen = resolve_penalty(state, penalty)
        new_disc, d_opt, d_bn = params["disc"], state["opt"]["disc"], \
            bn["disc"]
        for i in range(cfg.n_critic):
            z_i, d_i = critic_inputs(z, draws, i)
            dg, d_bn, d_terms = d_grads(new_disc, params["gen"],
                                        {"gen": bn["gen"], "disc": d_bn},
                                        images, z_i, d_i, pen,
                                        labels=labels)
            new_disc, d_opt = opt_d.step(new_disc, dg, d_opt)
            del dg

        if cfg.update_mode == "sequential":
            g_disc, g_disc_bn = new_disc, d_bn
        else:   # "fused": G's gradients at the pre-update D
            g_disc, g_disc_bn = params["disc"], bn["disc"]
        gg, g_bn, g_loss = g_grads(params["gen"], bn["gen"], g_disc,
                                   g_disc_bn, z, _sub(draws, "g/"),
                                   labels=labels)
        new_gen, g_opt = opt_g.step(params["gen"], gg, state["opt"]["gen"])

        new_state = {
            "params": {"gen": new_gen, "disc": new_disc},
            "bn": {"gen": g_bn, "disc": d_bn},
            "opt": {"gen": g_opt, "disc": d_opt},
            "ema_gen": ema_of(state, new_gen),
            "step": state["step"] + 1,
        }
        return new_state, metrics_of(d_terms, g_loss)

    # --- the pipelined stage programs (`:744-946`), on the code of the
    # fused step above; sequential update mode, unconditional models

    def gen_fakes(state: Pytree, draws: Dict[str, torch.Tensor]
                  ) -> torch.Tensor:
        """The fill program: an [n_critic, B, S, S, c_dim] fake stack from
        the current G, slot i from z "fill/z"[i] (train-mode BN, its state
        update discarded, as D's fake batch in the fused step)."""
        zs = check_stage_draws(draws, "fill/")["fill/z"]
        g_params, g_bn = state["params"]["gen"], state["bn"]["gen"]
        return torch.stack([make_fake(g_params, g_bn, zs[i])
                            for i in range(cfg.n_critic)])

    def d_update(state: Pytree, images: torch.Tensor, fakes: torch.Tensor,
                 draws: Dict[str, torch.Tensor], *,
                 penalty: Optional[bool] = None
                 ) -> Tuple[Pytree, Dict[str, torch.Tensor]]:
        """The critic update(s) on a given fake stack, slot i feeding
        critic iteration i (its draws "d/critic<i>/..."): D's half of the
        state updated, every other leaf passed through as the same
        tensor; returns (state, D's half of the metric row)."""
        draws = check_stage_draws(draws, "d/")
        params, bn = state["params"], state["bn"]
        pen = resolve_penalty(state, penalty)
        new_disc, d_opt, d_bn = params["disc"], state["opt"]["disc"], \
            bn["disc"]
        for i in range(cfg.n_critic):
            dg, d_bn, d_terms = d_grads(
                new_disc, params["gen"], {"gen": bn["gen"], "disc": d_bn},
                images, None, _sub(draws, f"d/critic{i}/"), pen,
                fake=fakes[i])
            new_disc, d_opt = opt_d.step(new_disc, dg, d_opt)
            del dg
        new_state = {
            "params": {"gen": params["gen"], "disc": new_disc},
            "bn": {"gen": bn["gen"], "disc": d_bn},
            "opt": {"gen": state["opt"]["gen"], "disc": d_opt},
            "ema_gen": state["ema_gen"],
            "step": state["step"],
        }
        return new_state, metrics_of(d_terms)

    def g_update(state: Pytree, draws: Dict[str, torch.Tensor]
                 ) -> Tuple[Pytree, torch.Tensor, Dict[str, torch.Tensor]]:
        """G's update against the current D on z "g/z", returning the
        next step's fake stack: slot 0 is the G-loss forward's own images
        (from the pre-update weights), slots 1.. (n_critic > 1) fresh
        images of "g/extra_z" from the same weights and BN state. Returns
        (state with step + 1, fake stack, {"g_loss"})."""
        draws = check_stage_draws(draws, "g/")
        params, bn = state["params"], state["bn"]
        fakes: List[torch.Tensor] = []
        gg, g_bn, g_loss = g_grads(params["gen"], bn["gen"], params["disc"],
                                   bn["disc"], draws["g/z"],
                                   _sub(draws, "g/aug/"), fakes=fakes)
        new_gen, g_opt = opt_g.step(params["gen"], gg, state["opt"]["gen"])
        del gg
        stack = [torch.cat(fakes) if n_micro > 1 else fakes[0]]
        for j in range(cfg.n_critic - 1):
            stack.append(make_fake(params["gen"], bn["gen"],
                                   draws["g/extra_z"][j]))
        new_state = {
            "params": {"gen": new_gen, "disc": params["disc"]},
            "bn": {"gen": g_bn, "disc": bn["disc"]},
            "opt": {"gen": g_opt, "disc": state["opt"]["disc"]},
            "ema_gen": ema_of(state, new_gen),
            "step": state["step"] + 1,
        }
        return new_state, torch.stack(stack), \
            {"g_loss": mean_scalars(group, [g_loss.detach()])[0]}

    def eval_losses(state: Pytree, images: torch.Tensor, z: torch.Tensor,
                    eps: Optional[torch.Tensor] = None,
                    labels: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
        """The loss probe on a held-out batch with a fixed z, no update
        (`:1004-1021`): train-mode BN with its new state discarded, no
        augmentation, R1 on every call with gamma / 2 unscaled by the
        interval, WGAN-GP's interpolation on fixed weights of its own
        (drawn from a generator seeded 0 unless `eps` is given)."""
        params, bn = state["params"], state["bn"]
        draws: Dict[str, torch.Tensor] = {}
        if wgan:
            if eps is None:
                gen = torch.Generator(device=images.device).manual_seed(0)
                eps = torch.rand((images.shape[0],), generator=gen,
                                 device=images.device)
            draws["eps"] = eps
        d_loss, _, d_real, d_fake, gp = d_loss_fn(
            params["disc"], params["gen"], bn, images, z, draws, True,
            0.5 * cfg.r1_gamma, augment=False, labels=labels)
        with torch.no_grad():
            g_loss, _ = g_loss_fn(params["gen"], bn["gen"], params["disc"],
                                  bn["disc"], z, {}, augment=False,
                                  labels=labels)
        return metrics_of((d_loss, d_real, d_fake, gp), g_loss)

    @torch.no_grad()
    def summarize(state: Pytree, images: torch.Tensor, z: torch.Tensor,
                  labels: Optional[torch.Tensor] = None
                  ) -> Dict[str, Dict[str, torch.Tensor]]:
        """Per-layer activation histograms and sparsity (`:964-1002`): one
        train-mode G forward on z and D forwards on the real batch and on
        G's images, the JAX names: gen/h*, disc/h*, disc/logit, z,
        d_real_prob, d_fake_prob."""
        params, bn = state["params"], state["bn"]
        g_cap: dict = {}
        d_cap: dict = {}
        fake, _ = generator_apply(params["gen"], bn["gen"], z, cfg=mcfg,
                                  train=True, labels=labels, capture=g_cap,
                                  group=group, spatial=spatial)
        d_real_prob, _, _ = discriminator_apply(
            params["disc"], bn["disc"], images, cfg=mcfg, train=True,
            labels=labels, capture=d_cap, group=group, spatial=spatial)
        d_fake_prob, _, _ = discriminator_apply(
            params["disc"], bn["disc"], fake, cfg=mcfg, train=True,
            labels=labels, group=group, spatial=spatial)
        acts = {**{f"gen/{k}": v for k, v in g_cap.items()},
                **{f"disc/{k}": v for k, v in d_cap.items()},
                "z": z, "d_real_prob": d_real_prob,
                "d_fake_prob": d_fake_prob}
        if spatial is None:
            return activation_stats(acts, group=group)
        # the maps are the rank's rows; z and D's outputs the model axis's
        shared = ("z", "d_real_prob", "d_fake_prob", "disc/logit")
        stats = activation_stats({k: v for k, v in acts.items()
                                  if k not in shared}, group=group)
        stats.update(activation_stats({k: acts[k] for k in shared},
                                      group=spatial.data_group))
        return {k: stats[k] for k in acts}

    def sample(state: Pytree, z: torch.Tensor,
               labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        # the EMA weights when tracking is on, else the live ones
        g_params = (state["ema_gen"] if cfg.g_ema_decay > 0.0
                    else state["params"]["gen"])
        return sampler_apply(g_params, state["bn"]["gen"], z, cfg=mcfg,
                             labels=labels, spatial=spatial)

    def init(seed: Optional[int] = None,
             device: Union[str, torch.device] = "cuda") -> Pytree:
        return init_train_state(cfg, seed=seed, device=device)

    return TrainStepFns(train_step=train_step, grads=grads, sample=sample,
                        init=init, eval_losses=eval_losses,
                        summarize=summarize, gen_fakes=gen_fakes,
                        d_update=d_update, g_update=g_update,
                        lr_backoff=backoff, group=group)
