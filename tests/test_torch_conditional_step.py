"""The conditional train step against `dcgan_tpu`'s on the CPU (K = 4
classes, 16 px, gf = df = 8, batch 4): the routes, with and without
conditional BN, n_critic, grad_accum, DiffAugment, WGAN-GP and labels out
of range. The probe, the summaries, the runner, the feed and the trainer
are tests/test_torch_conditional_train.py's.

Both packages start from one state in the JAX init's tree, its weights
numpy draws from a seed (`torch_jax_draws.numpy_init`, carried over),
and take 2 steps on the same numpy images, labels and the JAX step's
draws (tests/torch_jax_draws.py); JAX jitted with its Pallas kernels in
interpret mode, the port on its plain versions. Tolerances are
tests/test_torch_train.py's (f32): losses 1e-5 at every step (WGAN-GP's,
whose d_loss carries 10x the penalty, 1e-5 of max(1, |loss|), and each
step from JAX's state, as tests/test_torch_penalties.py holds them);
every state leaf 1e-5 abs + 1e-5 rel, the biases that feed a BatchNorm
held to Adam's bound 2 * lr per update of their net.
"""

import numpy as np
import pytest
import torch_jax_draws as D
from torch_jax_draws import one_torch_thread  # noqa: F401

K = 4
COND = dict(num_classes=K)
CBN = dict(num_classes=K, conditional_bn=True)
OUT_OF_RANGE = np.array([-1, K, K + 3, -K - 1], np.int32)


def _check(jm, tm, js, ts, updates=2):
    for j, t in zip(jm, tm):
        assert set(j) == set(t)
        for k in j:
            assert abs(j[k] - t[k]) <= 1e-5 * max(1.0, abs(j[k])), \
                (k, j[k], t[k])
    D.assert_f32_state(js, ts, steps=updates)


@pytest.mark.parametrize("route,model_kw", [
    ("plain", COND), ("fused", COND), ("use_pallas", CBN)])
def test_train_step_matches_jax(route, model_kw):
    """Every route, with and without conditional BN: the cBN tables and
    their Adam moments are state leaves like the others."""
    _check(*D.run_both({}, route, steps=2, model_kw=model_kw,
                        numpy_weights=True)[:4])


@pytest.mark.parametrize("kw,route", [
    ({"n_critic": 2, "grad_accum": 2}, "fused"),
    ({"diffaug": "color,translation,cutout", "n_critic": 2,
      "grad_accum": 2}, "plain"),
    ({"loss": "wgan-gp", "grad_accum": 2}, "plain")])
def test_step_variants_match_jax(kw, route):
    """n_critic (every critic iteration on the same labels), grad_accum
    (labels split by the images' rows), DiffAugment (the maps joined
    after the augmentation) and WGAN-GP (the penalty's critic reads the
    labels; each step from JAX's state), conditional BN on the routes
    that have it."""
    model_kw = CBN if route == "plain" else COND
    wgan = kw.get("loss") == "wgan-gp"
    _check(*D.run_both(kw, route, steps=2, model_kw=model_kw,
                       resync=wgan, numpy_weights=True)[:4],
           updates=(1 if wgan else 2) * kw.get("n_critic", 1))


def test_out_of_range_labels_step_matches_jax():
    """Labels [-1, K, K+3, -K-1] at every step, conditional BN: the zero
    one-hot, the clamped table rows, and a table gradient that drops the
    labels out of range after the wrap, as JAX's."""
    _check(*D.run_both({}, "plain", steps=2, model_kw=CBN,
                       labels=OUT_OF_RANGE, numpy_weights=True)[:4])
