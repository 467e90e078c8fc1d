"""The port's DiffAugment (`ops/augment.py`) against `dcgan_tpu`'s on the
CPU: the JAX function draws from its key, the port takes those draws as
tensors (recomputed from the key by tests/torch_jax_draws.py), and both
transform the same numpy images. f32; the transforms are elementwise,
gathers and means, so they agree to 1e-6 (summation order of the means
only); the translation and cutout masks agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_jax_draws as D

from dcgan_tpu.ops import augment as jaug
from dcgan_tpu_torch.ops import augment as taug
from torch_jax_draws import one_torch_thread  # noqa: F401

B, S = 6, 16


def _x(seed=0, size=S):
    rng = np.random.default_rng(seed)
    return np.tanh(rng.normal(size=(B, size, size, 3))).astype(np.float32)


POLICIES = [("color",), ("translation",), ("cutout",),
            ("color", "translation", "cutout"), ("cutout", "color")]


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("size", [16, 12])
def test_policy_matches_jax(policy, size):
    """Each policy alone and chained, at a size a multiple of 8 and at one
    whose cutout is even and translation 1 pixel (12: the hole's corner
    range and the canvas's pad are the off-by-one spots)."""
    x = _x(1, size)
    for seed in range(3):
        key = jax.random.key(seed)
        want = np.asarray(jaug.diff_augment(jnp.asarray(x), key, policy))
        draws = D.to_torch(D.aug_draws(key, policy, B, size))
        got = taug.diff_augment(torch.from_numpy(x), draws, policy).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("policy", POLICIES[3:4] + [("translation",)])
def test_gradient_through_augment_matches_jax(policy):
    """G's gradient flows through the augmentation: d sum(w * aug(x)) / dx
    against jax.grad."""
    x = _x(2)
    w = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)
    key = jax.random.key(7)
    want = np.asarray(jax.grad(lambda a: jnp.sum(
        jnp.asarray(w) * jaug.diff_augment(a, key, policy)))(
            jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    draws = D.to_torch(D.aug_draws(key, policy, B, S))
    (g,) = torch.autograd.grad(
        (torch.from_numpy(w) * taug.diff_augment(xt, draws, policy)).sum(),
        xt)
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-5, atol=1e-6)


def test_draws_cover_the_jax_ranges():
    """draw_augment's fields, dtypes and ranges: the JAX distributions'
    (brightness [-0.5, 0.5), saturation [0, 2), contrast [0.5, 1.5), shifts
    -S/8..S/8, the hole's corner -S/4..S - S/4 - (S/2 mod 2))."""
    gen = torch.Generator().manual_seed(0)
    d = taug.draw_augment(("color", "translation", "cutout"), 4096, S, gen)
    assert sorted(d) == sorted(["0/brightness", "0/saturation",
                                "0/contrast", "1/ty", "1/tx", "2/oy",
                                "2/ox"])
    for k, (lo, hi) in {"0/brightness": (-0.5, 0.5),
                        "0/saturation": (0.0, 2.0),
                        "0/contrast": (0.5, 1.5)}.items():
        assert d[k].dtype == torch.float32
        assert lo <= float(d[k].min()) and float(d[k].max()) < hi
        assert float(d[k].max()) - float(d[k].min()) > 0.9 * (hi - lo)
    for k in ("1/ty", "1/tx"):
        assert d[k].dtype == torch.int32
        assert sorted(d[k].unique().tolist()) == list(range(-2, 3))
    for k in ("2/oy", "2/ox"):
        assert sorted(d[k].unique().tolist()) == list(range(-4, 13))
    assert taug.draw_augment((), 4, S, gen) == {}
    with pytest.raises(ValueError, match="unknown diffaug policy"):
        taug.parse_policy("color,flip")
    assert taug.parse_policy(" color, cutout ") == ("color", "cutout")
