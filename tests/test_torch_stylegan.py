"""The port's StyleGAN2-lite family (`arch="stylegan"`, with the residual
critic) against `dcgan_tpu`'s on the CPU: weights from numpy in the JAX
init's tree (`torch_jax_draws.numpy_init`), carried over with
`convert.py`, numpy inputs.

Tolerances:
- names and shapes: equal to the JAX init's; G's state is `{}`;
- G's images: f32 1e-4 (summation order only); bf16 against the JAX
  package's f32 images, within twice the JAX package's own bf16 distance
  from them (each package rounds the modulated convolutions' bf16
  products and sums at its own points: both land 1.5e-2 to 3e-2 from
  the f32 images at these weights, and 1.2e-2 to 3.1e-2 from each
  other); the mapped latents `w` (capture) f32 1e-5;
- gradients (f32): every leaf of both nets within 1e-4 of the net's
  largest leaf gradient;
- lazy R1 (gamma 10, interval 2, G EMA 0.999), two steps from state step
  0: the penalty runs on step 0 only; metrics 1e-5 at every step and
  every state leaf as `torch_jax_draws.assert_f32_state` holds it, at
  learning rate 1e-7 (tests/test_torch_resnet.py's STEP_LR says why);
  the captured runner's path (eager on the CPU) at K = 2 equals two eager
  steps bit for bit;
- checkpoints: bit for bit both ways, the empty G state and the `const`
  leaf included; the JAX sampler on the port's checkpoint 1e-4;
- int8 serving: the JAX rule (`w` leaves of two or more dimensions), so
  `const` stays exact, and the JAX report; the exported program equals
  the plain sampler (1e-6).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_jax_draws as D

from dcgan_tpu import config as j_config
from dcgan_tpu.config import ModelConfig as JModelConfig
from dcgan_tpu.config import TrainConfig as JTrainConfig
from dcgan_tpu.models import dcgan as jdcgan
from dcgan_tpu.serve import quantize as jquant
from dcgan_tpu.train import steps as jsteps
from dcgan_tpu.utils.checkpoint import Checkpointer as JCheckpointer
from dcgan_tpu_torch import config, convert
from dcgan_tpu_torch import export as t_export
from dcgan_tpu_torch.config import ModelConfig, TrainConfig, save_config
from dcgan_tpu_torch.models import dcgan as tdcgan
from dcgan_tpu_torch.serve import quantize as tquant
from dcgan_tpu_torch.train import steps as tsteps
from dcgan_tpu_torch.train import warmup
from dcgan_tpu_torch.utils.checkpoint import Checkpointer
from torch_jax_draws import one_torch_thread  # noqa: F401

TINY = dict(arch="stylegan", output_size=16, gf_dim=8, df_dim=8, z_dim=8)
BATCH = 4
LAZY_R1 = dict(r1_gamma=10.0, r1_interval=2, g_ema_decay=0.999,
               learning_rate=1e-7)


def _train_cfgs(kw, **train_kw):
    return (JTrainConfig(model=JModelConfig(**kw), batch_size=BATCH,
                         **train_kw),
            TrainConfig(model=ModelConfig(**kw), batch_size=BATCH,
                        **train_kw))


def _state(kw, seed=0, **train_kw):
    """(JAX numpy state, port state, JAX step functions) from numpy
    weights; G's weights scaled up so its images are not near 0."""
    jcfg, _ = _train_cfgs(kw, **train_kw)
    jfns = jsteps.make_train_step(jcfg)
    jstate = D.numpy_init(jfns.init, seed=seed)
    for tree in (jstate["params"]["gen"], jstate["ema_gen"]):
        for name, p in tree.items():
            if isinstance(p, dict):
                p["w"] = p["w"] * 20.0
    return jstate, convert.train_state_from_jax(jstate, device="cpu"), jfns


def _z(n, dim=8, seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, (n, dim)).astype(
        np.float32)


@pytest.mark.parametrize("size", [16, 32])
def test_names_and_shapes_equal_jax_init(size):
    kw = dict(TINY, output_size=size)
    jparams, jstate = jax.eval_shape(
        lambda k: jdcgan.gan_init(k, JModelConfig(**kw)), jax.random.key(0))
    tparams, tstate = tdcgan.gan_init(ModelConfig(**kw), device="cpu")
    assert D.tree_shapes(tparams) == D.tree_shapes(jparams)
    assert D.tree_shapes(tstate) == D.tree_shapes(jstate)
    assert tstate["gen"] == {} and tparams["gen"]["const"].ndim == 3
    # the unit-scale constant, not the 0.02 weight convention
    assert 0.5 < float(tparams["gen"]["const"].std()) < 1.5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("classes", [0, 4], ids=["uncond", "cond"])
def test_generator_matches_jax(dtype, classes):
    """G's images (train and sampler are one function) and the mapped
    latents w of the capture."""
    kw = dict(TINY, compute_dtype=dtype, num_classes=classes)
    jstate, tstate, _ = _state(kw)
    z = _z(BATCH)
    labels = (np.arange(BATCH) % classes).astype(np.int32) \
        if classes else None
    jcfg, tcfg = JModelConfig(**kw), ModelConfig(**kw)

    def jax_g(jcfg):
        def g(p, z, labels):
            cap = {}
            img, _ = jdcgan.generator_apply(p, {}, z, cfg=jcfg, train=True,
                                            labels=labels, capture=cap)
            return img, cap["w"]
        return jax.jit(g)(jstate["params"]["gen"], z, labels)

    jimg, jw = jax_g(jcfg)
    cap = {}
    with torch.no_grad():
        timg, new = tdcgan.generator_apply(
            tstate["params"]["gen"], tstate["bn"]["gen"],
            torch.from_numpy(z), cfg=tcfg, train=True,
            labels=None if labels is None else torch.from_numpy(labels),
            capture=cap)
    assert new == {}
    jimg = np.asarray(jimg)
    assert timg.shape == jimg.shape == (BATCH, 16, 16, 3)
    assert jimg.std() > 0.05
    if dtype == "float32":
        assert np.abs(timg.numpy() - jimg).max() <= 1e-4
        assert np.abs(cap["w"].numpy() - np.asarray(jw)).max() <= 1e-5
    else:
        f32 = np.asarray(jax_g(JModelConfig(
            **dict(kw, compute_dtype="float32")))[0])
        jax_err = np.abs(jimg - f32).max()
        assert 0 < jax_err < 0.05
        assert np.abs(timg.numpy() - f32).max() <= 2 * jax_err


def test_gradients_match_jax():
    """d/d(params) of sum(D(G(z))) + sum(D(x)) in f32: G's gradient
    through the modulated convolutions and the skip tRGB sum, the const
    leaf's included; D's through the residual critic."""
    kw = dict(TINY, compute_dtype="float32")
    jstate, tstate, _ = _state(kw, seed=2)
    z = _z(BATCH, seed=3)
    images = np.tanh(np.random.default_rng(4).normal(
        size=(BATCH, 16, 16, 3))).astype(np.float32)
    jcfg, tcfg = JModelConfig(**kw), ModelConfig(**kw)
    bn = jstate["bn"]

    def jloss(p):
        img, _ = jdcgan.generator_apply(p["gen"], {}, jnp.asarray(z),
                                        cfg=jcfg, train=True)
        _, lf, _ = jdcgan.discriminator_apply(p["disc"], bn["disc"], img,
                                              cfg=jcfg, train=True)
        _, lr, _ = jdcgan.discriminator_apply(p["disc"], bn["disc"],
                                              jnp.asarray(images), cfg=jcfg,
                                              train=True)
        return jnp.sum(lf) + jnp.sum(lr)

    want = convert.flatten(jax.device_get(
        jax.jit(jax.grad(jloss))(jstate["params"])))
    tp = tsteps.tree_map(lambda t: t.requires_grad_(True),
                         tstate["params"])
    img, _ = tdcgan.generator_apply(tp["gen"], {}, torch.from_numpy(z),
                                    cfg=tcfg, train=True)
    _, lf, _ = tdcgan.discriminator_apply(tp["disc"], tstate["bn"]["disc"],
                                          img, cfg=tcfg, train=True)
    _, lr, _ = tdcgan.discriminator_apply(tp["disc"], tstate["bn"]["disc"],
                                          torch.from_numpy(images), cfg=tcfg,
                                          train=True)
    grads = torch.autograd.grad(lf.sum() + lr.sum(), tsteps.tree_leaves(tp))
    got = dict(zip(convert.flatten(tp), grads))
    assert sorted(got) == sorted(want) and "gen/const" in got
    for net in ("gen", "disc"):
        scale = max(np.abs(w).max() for p, w in want.items()
                    if p.startswith(net))
        for path in (p for p in want if p.startswith(net)):
            err = np.abs(got[path].numpy() - want[path]).max()
            assert err <= 1e-4 * scale, (path, err, scale)


def test_lazy_r1_steps_equal_jax_on_every_leaf():
    """stylegan64's regularizer at interval 2: R1 on the step from state
    step 0 (gamma * 2 / 2), none on the next; G's EMA at 0.999."""
    jm, tm, jstate, tstate, _ = D.run_both(
        LAZY_R1, "plain", steps=2, batch=BATCH, model_kw={"arch": "stylegan"},
        numpy_weights=True)
    assert tm[0]["r1"] > 0 and tm[1]["r1"] == 0.0
    for j, t in zip(jm, tm):
        for k in j:
            assert abs(j[k] - t[k]) <= 1e-5 * max(1, abs(j[k])), k
    D.assert_f32_state(jstate, tstate, lr=LAZY_R1["learning_rate"],
                       steps=2)
    assert tstate["bn"]["gen"] == {}


def test_runner_over_the_r1_pattern_equals_eager():
    """The captured runner's path (eager on the CPU) at K = 2 over the
    lazy-R1 pattern: the warm-up step from 0 (R1), then one call of
    steps 1-2 (the r1=01 row at interval 2), bit for bit against three
    eager steps; the empty G state through the static state."""
    kw = dict(TINY, compute_dtype="float32")
    cfg = TrainConfig(model=ModelConfig(**kw), batch_size=BATCH,
                      steps_per_call=2, sample_every_steps=0,
                      activation_summary_steps=0, **LAZY_R1)
    fns = tsteps.make_train_step(cfg)
    rng = np.random.default_rng(5)
    images = [torch.from_numpy(np.tanh(rng.normal(
        size=(BATCH, 16, 16, 3))).astype(np.float32)) for _ in range(3)]
    zs = [torch.from_numpy(_z(BATCH, seed=20 + i)) for i in range(3)]
    eager = fns.init(seed=0, device="cpu")
    rows = []
    for i in range(3):
        eager, m = fns.train_step(eager, images[i], zs[i])
        rows.append([float(m[k]) for k in warmup.metric_keys(cfg)])
    runner = warmup.StepRunner(fns, fns.init(seed=0, device="cpu"), cfg,
                               torch.device("cpu"))
    got = runner.step(images[:1], zs[:1], start=0).tolist()
    assert runner.row(2, start=1) == "multi_step@k2/r1=10" or \
        runner.row(2, start=1) == "multi_step@k2/r1=01"
    got += runner.step(images[1:], zs[1:], start=1).tolist()
    assert got == rows
    assert rows[0][-1] > 0 and rows[1][-1] == 0 and rows[2][-1] > 0
    flat, want = convert.flatten(runner.state), convert.flatten(eager)
    assert sorted(flat) == sorted(want) and runner.state["bn"]["gen"] == {}
    assert all(torch.equal(flat[k], want[k]) for k in want)


def test_port_checkpoint_samples_in_jax(tmp_path):
    """The port's checkpoint (empty G state, `const`) restores bit for bit
    in the port, grafts into the JAX state tree bit for bit
    (`port_to_jax_state`), and the JAX sampler on it gives the port's
    EMA images."""
    kw = dict(TINY, compute_dtype="float32")
    jstate, tstate, jfns = _state(kw, **LAZY_R1)
    _, cfg = _train_cfgs(kw, checkpoint_dir=str(tmp_path), **LAZY_R1)
    save_config(cfg, str(tmp_path))
    ck = Checkpointer(str(tmp_path))
    ck.save(3, tstate)
    ck.wait()
    restored = Checkpointer(str(tmp_path)).restore_latest(
        tsteps.init_train_state(cfg, device="cpu"))
    assert restored["bn"]["gen"] == {}
    flat = convert.flatten(tstate)
    back = convert.flatten(restored)
    assert sorted(back) == sorted(flat) and "params/gen/const" in flat
    assert all(torch.equal(back[k], flat[k]) for k in flat)

    grafted = D.export_tool().port_to_jax_state(str(tmp_path), jstate)
    assert grafted["bn"]["gen"] == {}
    again = convert.flatten(convert.train_state_from_jax(grafted,
                                                         device="cpu"))
    assert sorted(again) == sorted(flat)
    assert all(torch.equal(again[k], flat[k]) for k in flat)
    zs = _z(6, seed=3)
    jimg = np.asarray(jax.jit(jfns.sample)(
        jax.tree_util.tree_map(jnp.asarray, grafted), jnp.asarray(zs)))
    timg = tdcgan.sampler_apply(restored["ema_gen"], {},
                                torch.from_numpy(zs), cfg=cfg.model).numpy()
    assert np.abs(jimg - timg).max() <= 1e-4


def test_orbax_checkpoint_exports_bit_for_bit(tmp_path):
    """An Orbax checkpoint of the JAX Checkpointer, exported by the tool,
    restores in the port equal to train_state_from_jax of the saved state:
    `const` and the empty G state carried."""
    kw = dict(TINY, compute_dtype="float32")
    jcfg = JTrainConfig(model=JModelConfig(**kw), batch_size=BATCH,
                        checkpoint_dir=str(tmp_path / "jax"), **LAZY_R1)
    rng = np.random.default_rng(6)
    state = jax.tree_util.tree_map(
        lambda s: jax.device_put(
            rng.normal(size=s.shape).astype(s.dtype)
            if s.dtype == jnp.float32 else np.full(s.shape, 4, s.dtype)),
        jax.eval_shape(lambda k: jsteps.init_train_state(k, jcfg),
                       jax.random.key(4)))
    j_config.save_config(jcfg, jcfg.checkpoint_dir)
    jck = JCheckpointer(jcfg.checkpoint_dir)
    jck.save(4, state, force=True)
    jck.close()
    out = str(tmp_path / "port")
    assert D.export_tool().export(jcfg.checkpoint_dir, out) == 4
    port_cfg = config.load_config(out)
    assert port_cfg.model.arch == "stylegan"
    restored = Checkpointer(out).restore_latest(
        tsteps.init_train_state(port_cfg, device="cpu"))
    want = convert.flatten(convert.train_state_from_jax(
        jax.device_get(state), device="cpu"))
    got = convert.flatten(restored)
    assert sorted(got) == sorted(want) and restored["bn"]["gen"] == {}
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_int8_follows_the_jax_rule(tmp_path):
    """int8 quantizes the `w` leaves of two or more dimensions: the
    report equals the JAX function's and `const` (3-D, not a `w`) stays
    exact; the exported program of the checkpoint equals the plain
    sampler."""
    kw = dict(TINY, compute_dtype="float32")
    jstate, tstate, _ = _state(kw, **LAZY_R1)
    gen = tstate["params"]["gen"]
    q, report = tquant.quantize_dequantize_int8(gen)
    _, jreport = jquant.quantize_dequantize_int8(
        jax.tree_util.tree_map(jnp.asarray, jstate["params"]["gen"]))
    assert report == jreport
    assert torch.equal(q["const"], gen["const"])
    assert report["quantized_leaves"] == 2 + 6 * 2

    _, cfg = _train_cfgs(kw, checkpoint_dir=str(tmp_path), **LAZY_R1)
    save_config(cfg, str(tmp_path))
    ck = Checkpointer(str(tmp_path))
    ck.save(3, tstate)
    ck.wait()
    out = tmp_path / "s.pt2"
    t_export.export_sampler(str(tmp_path), str(out), device="cpu")
    program = t_export.load_sampler(str(out))
    z = _z(5, seed=8)
    got = program(torch.from_numpy(z)).numpy()
    want = tdcgan.sampler_apply(gen, {}, torch.from_numpy(z),
                                cfg=cfg.model).numpy()
    assert want.std() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_summaries_carry_the_mapped_latents():
    """summarize's records carry the JAX names (`jax.eval_shape`, nothing
    of JAX's runs), the capture's mapped latents `gen/w` among them, each
    record's fields as JAX's and finite."""
    kw = dict(TINY, compute_dtype="float32")
    _, tcfg = _train_cfgs(kw, **LAZY_R1)
    jstate, tstate, jfns = _state(kw, **LAZY_R1)
    images = np.tanh(np.random.default_rng(9).normal(
        size=(BATCH, 16, 16, 3))).astype(np.float32)
    want = jax.eval_shape(jfns.summarize, jstate, jnp.asarray(images),
                          jax.random.key(3))
    got = tsteps.make_train_step(tcfg).summarize(
        tstate, torch.from_numpy(images), torch.from_numpy(_z(BATCH)))
    assert sorted(got) == sorted(want) and "gen/w" in got
    for name, rec in got.items():
        assert sorted(rec) == sorted(want[name]), name
        assert all(bool(torch.isfinite(torch.as_tensor(v)).all())
                   for v in rec.values())
