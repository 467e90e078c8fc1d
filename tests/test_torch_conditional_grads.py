"""Class conditioning in the port against `dcgan_tpu`'s on the CPU, with
tests/test_torch_conditional.py's weights and routes: labels out of range
(JAX's zero one-hot and clamped cBN row) through G and D, the gradients of
both nets with labels (the cBN tables included), and the conditional
config and its refusals.

Tolerances: images and logits f32 1e-4 (summation order only); gradients
rtol 1e-3 of each leaf's largest value plus 1e-5
(tests/test_torch_models.py's rule).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcgan_tpu.config import ModelConfig as JModelConfig
from dcgan_tpu.config import TrainConfig as JTrainConfig
from dcgan_tpu.models import dcgan as jdcgan
from dcgan_tpu_torch import convert
from dcgan_tpu_torch.config import ModelConfig, TrainConfig
from dcgan_tpu_torch.models import dcgan as tdcgan
from test_torch_conditional import CASES, K, _gan, _j, _labels, _mk, _t
from torch_jax_draws import one_torch_thread  # noqa: F401

OUT_OF_RANGE = np.array([-1, K, K + 3, -K - 1], np.int32)


class TestModels:
    @pytest.mark.parametrize("route,cbn", CASES)
    def test_out_of_range_labels_match_jax(self, route, cbn):
        """Labels [-1, K, K+3, -K-1]: JAX's zero one-hot and clamped cBN
        row, in G (train and sample) and D, f32 1e-4."""
        params, bn = _gan(cbn, seed=2)
        jcfg, tcfg = JModelConfig(**_mk(route, cbn)), \
            ModelConfig(**_mk(route, cbn))
        z = np.random.default_rng(4).uniform(-1, 1, (4, 8)).astype(
            np.float32)
        for train in (False, True):
            want, _ = jdcgan.generator_apply(
                _j(params["gen"]), bn["gen"], jnp.asarray(z), cfg=jcfg,
                train=train, labels=jnp.asarray(OUT_OF_RANGE))
            got, _ = tdcgan.generator_apply(
                _t(params["gen"]), _t(bn["gen"]), torch.from_numpy(z),
                cfg=tcfg, train=train,
                labels=torch.from_numpy(OUT_OF_RANGE))
            assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-4
        img = np.asarray(want)
        _, jl, _ = jdcgan.discriminator_apply(
            params["disc"], bn["disc"], jnp.asarray(img), cfg=jcfg,
            train=True, labels=jnp.asarray(OUT_OF_RANGE))
        _, tl, _ = tdcgan.discriminator_apply(
            _t(params["disc"]), _t(bn["disc"]), torch.from_numpy(img),
            cfg=tcfg, train=True, labels=torch.from_numpy(OUT_OF_RANGE))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)

    @pytest.mark.parametrize("route,cbn", CASES)
    def test_gradients_match_jax(self, route, cbn):
        """d/d(params) of a scalar through G then D with labels (train
        mode, D's BN state chained from a real batch), f32, against
        jax.grad for both nets, the cBN tables included: rtol 1e-3 of
        each leaf's largest gradient plus 1e-5."""
        params, bn = _gan(cbn, seed=5)
        rng = np.random.default_rng(6)
        z = rng.uniform(-1, 1, (4, 8)).astype(np.float32)
        img = np.tanh(rng.normal(size=(4, 16, 16, 3))).astype(np.float32)
        lab = _labels(7)
        jcfg, tcfg = JModelConfig(**_mk(route, cbn)), \
            ModelConfig(**_mk(route, cbn))

        def jloss(p):
            fake, _ = jdcgan.generator_apply(
                p["gen"], bn["gen"], jnp.asarray(z), cfg=jcfg, train=True,
                labels=jnp.asarray(lab))
            _, real_l, d_bn = jdcgan.discriminator_apply(
                p["disc"], bn["disc"], jnp.asarray(img), cfg=jcfg,
                train=True, labels=jnp.asarray(lab))
            _, fake_l, _ = jdcgan.discriminator_apply(
                p["disc"], d_bn, fake, cfg=jcfg, train=True,
                labels=jnp.asarray(lab))
            return jnp.mean(real_l) - jnp.mean(fake_l * fake_l)

        want = convert.flatten(jax.tree_util.tree_map(
            np.asarray, jax.jit(jax.grad(jloss))(_j(params))))
        tparams = _t(params)
        flat = convert.flatten(tparams)
        for t in flat.values():
            t.requires_grad_(True)
        tl = torch.from_numpy(lab)
        fake, _ = tdcgan.generator_apply(tparams["gen"], _t(bn["gen"]),
                                         torch.from_numpy(z), cfg=tcfg,
                                         train=True, labels=tl)
        _, real_l, d_bn = tdcgan.discriminator_apply(
            tparams["disc"], _t(bn["disc"]), torch.from_numpy(img),
            cfg=tcfg, train=True, labels=tl)
        _, fake_l, _ = tdcgan.discriminator_apply(
            tparams["disc"], d_bn, fake, cfg=tcfg, train=True, labels=tl)
        loss = real_l.mean() - (fake_l * fake_l).mean()
        grads = torch.autograd.grad(loss, list(flat.values()))
        assert sorted(want) == sorted(flat)
        if cbn:
            assert flat["gen/bn1/scale"].shape == (K, 8)
        for path, g in zip(flat, grads):
            w = want[path]
            err = np.abs(g.numpy() - w).max()
            assert err <= 1e-3 * np.abs(w).max() + 1e-5, (path, err)


class TestConfig:
    @pytest.mark.parametrize("kw", [
        {"num_classes": 10}, {"num_classes": 10, "conditional_bn": True},
        {"num_classes": 10, "use_pallas": True, "pallas_fused": True},
        {"num_classes": 10, "conditional_bn": True, "use_pallas": True}])
    def test_conditional_models_construct_as_in_jax(self, kw):
        assert dataclasses.asdict(ModelConfig(**kw)) == \
            dataclasses.asdict(JModelConfig(**kw))

    @pytest.mark.parametrize("make", [
        lambda M, T: M(num_classes=10, conditional_bn=True, use_pallas=True,
                       pallas_fused=True),
        lambda M, T: M(conditional_bn=True),
        lambda M, T: T(model=M(num_classes=10), pipeline_gd=True)])
    def test_jax_refusals_kept(self, make):
        """pallas_fused with conditional_bn, conditional_bn without
        classes, pipeline_gd with a conditional model: both packages
        raise ValueError, the port's message a prefix of the JAX one's
        or the same."""
        errors = []
        for M, T in ((JModelConfig, JTrainConfig), (ModelConfig,
                                                    TrainConfig)):
            with pytest.raises(ValueError) as e:
                make(M, T)
            errors.append(str(e.value))
        assert errors[0].startswith(errors[1].split(" (")[0])

    def test_label_feature_round_trips(self, tmp_path):
        """TrainConfig.label_feature (default "label") and the model's
        conditioning through config.json, in both packages."""
        from dcgan_tpu.config import load_config as j_load
        from dcgan_tpu.config import save_config as j_save
        from dcgan_tpu_torch.config import load_config, save_config

        t = TrainConfig(model=ModelConfig(num_classes=10,
                                          conditional_bn=True),
                        label_feature="cls")
        save_config(t, str(tmp_path / "port"))
        j = j_load(str(tmp_path / "port"))
        assert j.label_feature == "cls" and j.model.conditional_bn
        j_save(JTrainConfig(model=JModelConfig(num_classes=7)),
               str(tmp_path / "jax"))
        back = load_config(str(tmp_path / "jax"))
        assert back.model.num_classes == 7 and back.label_feature == "label"
