"""The GAN train step: two Adam optimizers over dicts of tensors (the
counterpart of `dcgan_tpu/train/steps.py:72-157,404-730`).

One `train_step(state, images, z)` is the JAX package's step at n_critic 1
without accumulation, on the BCE or the hinge loss (`cfg.loss`), in both
update modes:
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

The JAX step draws z inside the step from its key; here z is an argument
(the trainer draws it from a `torch.Generator`), so the parity tests can
hand both the same z.

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

import torch

from dcgan_tpu_torch.config import TrainConfig
from dcgan_tpu_torch.device import resolve_device
from dcgan_tpu_torch.models.dcgan import discriminator_apply, gan_init, \
    generator_apply, sampler_apply
from dcgan_tpu_torch.train.losses import bce_gan_losses, hinge_losses

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


# ---------------------------------------------------------------------------
# Learning-rate schedules and Adam, in optax's arithmetic
# ---------------------------------------------------------------------------

def make_lr_schedule(cfg: TrainConfig, base_lr: float, *,
                     updates_per_step: int = 1) -> Schedule:
    """Update count (an int32 tensor) -> f32 learning rate, optax's
    constant / linear / cosine schedules with an optional linear warmup
    (`join_schedules`), decaying to 0 over max_steps."""
    warmup = cfg.warmup_steps * updates_per_step
    decay_steps = max(1, cfg.max_steps * updates_per_step - warmup)

    def constant(count):
        return torch.full((), base_lr, dtype=torch.float32,
                          device=count.device)

    def linear(init: float, end: float, steps: int) -> Schedule:
        def schedule(count):
            c = torch.clamp(count, 0, steps)
            frac = 1.0 - c.float() / steps
            return (init - end) * frac + end
        return schedule

    def cosine(count):
        c = torch.minimum(count.float(), torch.full(
            (), float(decay_steps), device=count.device))
        decayed = 0.5 * (1.0 + torch.cos(math.pi * c / float(decay_steps)))
        return base_lr * decayed

    main = {"constant": constant,
            "linear": linear(base_lr, 0.0, decay_steps),
            "cosine": cosine}[cfg.lr_schedule]
    if not warmup:
        return main
    ramp = linear(0.0, base_lr, warmup)

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

    def init(self, params: Pytree) -> Pytree:
        device = tree_leaves(params)[0].device
        return {"mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params),
                "count": torch.zeros((), dtype=torch.int32, device=device)}

    @torch.no_grad()
    def step(self, params: Pytree, grads: Pytree, state: Pytree
             ) -> Tuple[Pytree, Pytree]:
        """(new params, new state), in optax's order: clip, mu, nu,
        count + 1, the bias corrections 1 - b^t, mu_hat / (sqrt(nu_hat) +
        eps), times -lr(count), then p + u."""
        if self.grad_clip > 0:
            g_norm = torch.sqrt(sum(torch.sum(g * g)
                                    for g in tree_leaves(grads)))
            keep = g_norm < self.grad_clip
            grads = tree_map(lambda g: torch.where(
                keep, g, (g / g_norm.to(g.dtype)) * self.grad_clip), grads)
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads,
                      state["nu"])
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
        eps = self.eps

        def update(p, m, v):
            u = (m / bc1.to(m.dtype)) / (torch.sqrt(v / bc2.to(v.dtype))
                                         + eps)
            return (p + step_size.to(u.dtype) * u).to(p.dtype)

        new_params = tree_map(update, params, mu, nu)
        return new_params, {"mu": mu, "nu": nu, "count": count_inc}


def make_optimizer(cfg: TrainConfig, lr: Optional[float] = None, *,
                   updates_per_step: int = 1) -> Adam:
    """Adam(lr=2e-4, b1=0.5, b2=0.999, eps=1e-8), the reference's optimizer;
    `lr` overrides the base rate (per-net rates), the schedule applies on
    top; grad_clip > 0 clips by global norm first."""
    base_lr = cfg.learning_rate if lr is None else lr
    return Adam(lr=make_lr_schedule(cfg, base_lr,
                                    updates_per_step=updates_per_step),
                b1=cfg.beta1, grad_clip=cfg.grad_clip)


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

@dataclasses.dataclass(frozen=True)
class TrainStepFns:
    """The functions of one TrainConfig."""
    train_step: Callable  # (state, images, z) -> (state, metrics)
    grads: Callable       # (state, images, z) -> ({"gen", "disc"}, metrics)
    sample: Callable      # (state, z) -> images (running-stat BN)
    init: Callable        # (seed=None, device="cuda") -> state


def _leaves_with_grad(tree: Pytree) -> Pytree:
    return tree_map(lambda p: p.detach().requires_grad_(True), tree)


def _grad(loss: torch.Tensor, leaves: Pytree) -> Pytree:
    """d loss / d leaves as a tree of the leaves' shape; frees the graph."""
    flat = tree_leaves(leaves)
    grads = iter(torch.autograd.grad(loss, flat))
    by_id = {id(p): g for p, g in zip(flat, grads)}
    return tree_map(lambda p: by_id[id(p)], leaves)


def make_train_step(cfg: TrainConfig) -> TrainStepFns:
    mcfg = cfg.model
    opt_g = make_optimizer(cfg, cfg.g_learning_rate)
    opt_d = make_optimizer(cfg, cfg.d_learning_rate,
                           updates_per_step=cfg.n_critic)

    def losses(real_logits, fake_logits):
        if cfg.loss == "hinge":
            return hinge_losses(real_logits, fake_logits)
        return bce_gan_losses(real_logits, fake_logits,
                              label_smoothing=cfg.label_smoothing)

    def d_grads(params: Pytree, bn: Pytree, images: torch.Tensor,
                z: torch.Tensor):
        """D's gradients -> (grads, D's new BN state, (d_loss, d_real,
        d_fake)): the fake batch without gradients, G's BN update
        discarded; D on real, then on fake, chaining its BN state."""
        with torch.no_grad():
            fake, _ = generator_apply(params["gen"], bn["gen"], z, cfg=mcfg,
                                      train=True)
        d_leaves = _leaves_with_grad(params["disc"])
        _, real_logits, d_bn1 = discriminator_apply(
            d_leaves, bn["disc"], images, cfg=mcfg, train=True)
        _, fake_logits, d_bn = discriminator_apply(
            d_leaves, d_bn1, fake, cfg=mcfg, train=True)
        d_loss, d_real, d_fake, _ = losses(real_logits, fake_logits)
        # _grad frees the graph before the G step builds its own
        return _grad(d_loss, d_leaves), d_bn, (d_loss, d_real, d_fake)

    def g_grads(g_params: Pytree, g_bn: Pytree, disc: Pytree,
                disc_bn: Pytree, z: torch.Tensor):
        """G's gradients against (disc, disc_bn) -> (grads, G's new BN
        state, g_loss)."""
        g_leaves = _leaves_with_grad(g_params)
        fake, new_g_bn = generator_apply(g_leaves, g_bn, z, cfg=mcfg,
                                         train=True)
        _, fake_logits, _ = discriminator_apply(disc, disc_bn, fake,
                                                cfg=mcfg, train=True)
        g_loss = losses(fake_logits, fake_logits)[3]
        return _grad(g_loss, g_leaves), new_g_bn, g_loss

    def metrics_of(d_terms, g_loss) -> Dict[str, torch.Tensor]:
        return {k: v.detach() for k, v in zip(
            ("d_loss", "d_loss_real", "d_loss_fake", "g_loss"),
            (*d_terms, g_loss))}

    def grads(state: Pytree, images: torch.Tensor, z: torch.Tensor
              ) -> Tuple[Pytree, Dict[str, torch.Tensor]]:
        """Both nets' gradients at the state's params, as the "fused"
        update mode takes them (G's against the pre-update D), and the
        losses; the state is not changed."""
        params, bn = state["params"], state["bn"]
        dg, _, d_terms = d_grads(params, bn, images, z)
        gg, _, g_loss = g_grads(params["gen"], bn["gen"], params["disc"],
                                bn["disc"], z)
        return {"gen": gg, "disc": dg}, metrics_of(d_terms, g_loss)

    def train_step(state: Pytree, images: torch.Tensor, z: torch.Tensor
                   ) -> Tuple[Pytree, Dict[str, torch.Tensor]]:
        params, bn = state["params"], state["bn"]
        dg, d_bn, d_terms = d_grads(params, bn, images, z)
        new_disc, d_opt = opt_d.step(params["disc"], dg,
                                     state["opt"]["disc"])
        del dg

        if cfg.update_mode == "sequential":
            g_disc, g_disc_bn = new_disc, d_bn
        else:   # "fused": G's gradients at the pre-update D
            g_disc, g_disc_bn = params["disc"], bn["disc"]
        gg, g_bn, g_loss = g_grads(params["gen"], bn["gen"], g_disc,
                                   g_disc_bn, z)
        new_gen, g_opt = opt_g.step(params["gen"], gg, state["opt"]["gen"])

        d_ema = cfg.g_ema_decay   # 0: ema_gen mirrors the live weights
        with torch.no_grad():
            ema_gen = tree_map(lambda e, p: d_ema * e + (1.0 - d_ema) * p,
                               state["ema_gen"], new_gen)
        new_state = {
            "params": {"gen": new_gen, "disc": new_disc},
            "bn": {"gen": g_bn, "disc": d_bn},
            "opt": {"gen": g_opt, "disc": d_opt},
            "ema_gen": ema_gen,
            "step": state["step"] + 1,
        }
        return new_state, metrics_of(d_terms, g_loss)

    def sample(state: Pytree, z: torch.Tensor) -> torch.Tensor:
        # the EMA weights when tracking is on, else the live ones
        g_params = (state["ema_gen"] if cfg.g_ema_decay > 0.0
                    else state["params"]["gen"])
        return sampler_apply(g_params, state["bn"]["gen"], z, cfg=mcfg)

    def init(seed: Optional[int] = None,
             device: Union[str, torch.device] = "cuda") -> Pytree:
        return init_train_state(cfg, seed=seed, device=device)

    return TrainStepFns(train_step=train_step, grads=grads, sample=sample,
                        init=init)
