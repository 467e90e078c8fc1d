"""GAN losses (the counterpart of `dcgan_tpu/train/losses.py:27-77`).

`bce_gan_losses` is the reference's loss trio:

    d_loss_real = BCE(D_logits(real), 1)
    d_loss_fake = BCE(D_logits(fake), 0)
    g_loss      = BCE(D_logits(fake), 1)        # non-saturating generator loss
    d_loss      = d_loss_real + d_loss_fake

from logits, in the stable log(1 + e^-|x|) form. `wgan_losses` and
`hinge_losses` have the same arity.

The penalties (`r1_penalty`, `gradient_penalty`,
`dcgan_tpu/train/losses.py:80-111`) take the critic's input gradient with
`torch.autograd.grad(..., create_graph=True)`, so that D's loss
differentiates through it: double backward. They run on the plain route
(cuDNN convolutions, torch BatchNorm), whose every op carries a second
derivative; config.py refuses them on a kernel route, as the JAX package
cannot take them through a Pallas kernel.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

Losses = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def sigmoid_bce(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Mean BCE-with-logits against a constant 0/1 target. The maximum is
    torch.maximum, which splits the gradient at a tie as jnp.maximum does."""
    zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
    loss = torch.maximum(logits, zero) - logits * target \
        + torch.log1p(torch.exp(-torch.abs(logits)))
    return loss.mean()


def bce_gan_losses(real_logits: torch.Tensor, fake_logits: torch.Tensor, *,
                   label_smoothing: float = 0.0) -> Losses:
    """(d_loss, d_loss_real, d_loss_fake, g_loss); label_smoothing > 0
    softens D's real target to 1 - eps (one-sided)."""
    d_loss_real = sigmoid_bce(real_logits, 1.0 - label_smoothing)
    d_loss_fake = sigmoid_bce(fake_logits, 0.0)
    g_loss = sigmoid_bce(fake_logits, 1.0)
    return d_loss_real + d_loss_fake, d_loss_real, d_loss_fake, g_loss


def wgan_losses(real_logits: torch.Tensor,
                fake_logits: torch.Tensor) -> Losses:
    """Wasserstein critic/generator losses (no penalty term)."""
    d_loss_real = -real_logits.mean()
    d_loss_fake = fake_logits.mean()
    g_loss = -fake_logits.mean()
    return d_loss_real + d_loss_fake, d_loss_real, d_loss_fake, g_loss


def hinge_losses(real_logits: torch.Tensor,
                 fake_logits: torch.Tensor) -> Losses:
    """Hinge losses: E[relu(1 - D(real))], E[relu(1 + D(fake))],
    g = -E[D(fake)]. relu's gradient at 0 is 0, as jax.nn.relu's."""
    d_loss_real = torch.relu(1.0 - real_logits).mean()
    d_loss_fake = torch.relu(1.0 + fake_logits).mean()
    g_loss = -fake_logits.mean()
    return d_loss_real + d_loss_fake, d_loss_real, d_loss_fake, g_loss


def _sq_grad_norms(critic: Callable[[torch.Tensor], torch.Tensor],
                   x: torch.Tensor) -> torch.Tensor:
    """Per-example squared input-gradient norms |grad_x D(x)|^2, [B], in
    f32, with the graph kept for the outer derivative."""
    x = x.detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(critic(x).sum(), x, create_graph=True)
    return torch.square(grads.float()).sum(dim=tuple(range(1, grads.ndim)))


def r1_penalty(critic: Callable[[torch.Tensor], torch.Tensor],
               real: torch.Tensor) -> torch.Tensor:
    """R1 (Mescheder et al. 2018): E[|grad_x D(x)|^2] on the real images;
    the caller scales it by gamma / 2."""
    return _sq_grad_norms(critic, real).mean()


def gradient_penalty(critic: Callable[[torch.Tensor], torch.Tensor],
                     real: torch.Tensor, fake: torch.Tensor,
                     eps: torch.Tensor) -> torch.Tensor:
    """WGAN-GP's E[(|grad_x D(x^)| - 1)^2] on x^ = eps * real + (1 - eps)
    * fake, with the interpolation weights `eps` [B] (U(0, 1), drawn by the
    caller) in real's dtype."""
    e = eps.to(real.dtype).view((real.shape[0],) + (1,) * (real.ndim - 1))
    interp = e * real + (1.0 - e) * fake
    norms = torch.sqrt(_sq_grad_norms(critic, interp) + 1e-12)
    return torch.square(norms - 1.0).mean()
