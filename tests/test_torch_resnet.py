"""The port's residual family (`arch="resnet"`) against `dcgan_tpu`'s on
the CPU: the JAX init carried over with `convert.py`, numpy inputs.

Tolerances:
- names and shapes: equal to the JAX init's, every leaf of both nets;
- forwards in f32: 1e-4 on G's tanh images (summation order only) and
  1e-4 of the largest |logit| on D's logits; bf16: 2e-2 on G's images and
  2e-2 of the largest |logit| (the two frameworks' convolutions round bf16
  products and sums at other points, through every block);
- under `use_pallas` G's BatchNorm runs the kernels' plain versions on
  the port's side and the Pallas kernels in interpret mode on the JAX
  side: the same tolerances;
- gradients (f32): every leaf within 1e-4 of the net's largest leaf
  gradient;
- one train step (hinge, n_critic 5, spectral norm on D): every state
  leaf as `torch_jax_draws.assert_f32_state` holds it (1e-5 abs + 1e-5 of
  its largest value; the biases that feed a BatchNorm to Adam's bound),
  and the losses 1e-5;
- WGAN-GP under `use_pallas`, which the norm-free critic lets the JAX
  package trace: the losses and the penalty 1e-5, the state as above;
- the steps run at learning rate 1e-7 (STEP_LR says why);
- checkpoints: bit for bit both ways.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_jax_draws as D

from dcgan_tpu.config import ModelConfig as JModelConfig
from dcgan_tpu.config import TrainConfig as JTrainConfig
from dcgan_tpu.models import dcgan as jdcgan
from dcgan_tpu.train import steps as jsteps
from dcgan_tpu_torch import convert, generate
from dcgan_tpu_torch.config import ModelConfig, TrainConfig, \
    load_model_config, save_config
from dcgan_tpu_torch.models import dcgan as tdcgan
from dcgan_tpu_torch.train import steps as tsteps
from dcgan_tpu_torch.train.trainer import train
from dcgan_tpu_torch.utils.checkpoint import Checkpointer
from torch_jax_draws import one_torch_thread  # noqa: F401

TINY = dict(arch="resnet", output_size=16, gf_dim=8, df_dim=8, z_dim=8)
# the composition of tests/test_resnet.py::TestComposition: conditional,
# cBN, two-head attention at 8x8, spectral norm on both nets
COMPOSED = dict(TINY, gf_dim=16, df_dim=16, num_classes=4,
                conditional_bn=True, attn_res=8, attn_heads=2,
                spectral_norm="gd")
BATCH = 4
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def numpy_tree(shapes, rng):
    """A tree of the JAX init's shapes (`jax.eval_shape`: nothing of the
    init runs) filled from numpy as the init fills it, with nonzero
    shifts: weights N(0, 0.02) cut at 2 sigma, BN scales 1 + that noise,
    biases and BN betas small normals, attention gamma 0.5 (0 would pass
    the block's input through), spectral-norm vectors unit normals,
    running means 0 and variances 1 (`_calibrate` sets them), a learned
    constant N(0, 1)."""
    def fill(path, leaf):
        name = getattr(path[-1], "key", None)
        if name in ("w", "scale"):
            noise = np.clip(rng.normal(0, 0.02, leaf.shape), -0.04, 0.04)
            return (noise + (name == "scale")).astype(leaf.dtype)
        if name in ("b", "bias"):
            return rng.normal(0, 0.02, leaf.shape).astype(leaf.dtype)
        if name == "gamma":
            return np.full(leaf.shape, 0.5, leaf.dtype)
        if name == "const":
            return rng.normal(size=leaf.shape).astype(leaf.dtype)
        if str(name).startswith("sn_"):
            u = rng.normal(size=leaf.shape)
            return (u / np.linalg.norm(u)).astype(leaf.dtype)
        return np.full(leaf.shape, name == "var", leaf.dtype)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _calibrate(kw, params, state, z, labels):
    """G's running statistics set to one train-mode batch's moments (the
    port's G at momentum 0), perturbed, so that the sampler's BatchNorm
    sees activations of its own scale."""
    rng = np.random.default_rng(9)
    tcfg = ModelConfig(**dict(kw, bn_momentum=0.0))
    tp = _to_port({"gen": params["gen"]})["gen"]
    ts = _to_port({"gen": state["gen"]})["gen"]
    with torch.no_grad():
        _, moments = tdcgan.generator_apply(
            tp, ts, torch.from_numpy(z), cfg=tcfg, train=True,
            labels=None if labels is None else torch.from_numpy(labels))
    for name, s in moments.items():
        if isinstance(s, dict):
            c = s["mean"].shape
            state["gen"][name] = {
                "mean": (s["mean"].numpy() * (1 + rng.normal(0, 0.1, c))
                         ).astype(np.float32),
                "var": (s["var"].numpy() * rng.uniform(0.8, 1.25, c)
                        ).astype(np.float32)}


def _weights(kw, seed=0):
    """Both nets' (params, state) as numpy in the JAX init's tree."""
    params, state = numpy_tree(jax.eval_shape(
        lambda k: jdcgan.gan_init(k, JModelConfig(**kw)),
        jax.random.key(0)), np.random.default_rng(seed))
    z, _, labels = _inputs(kw)
    _calibrate(kw, params, state, z, labels)
    return params, state


def _inputs(kw, seed=1):
    rng = np.random.default_rng(seed)
    z = rng.uniform(-1, 1, (BATCH, kw["z_dim"])).astype(np.float32)
    images = np.tanh(rng.normal(size=(BATCH, kw["output_size"],
                                      kw["output_size"], 3))).astype(
        np.float32)
    k = kw.get("num_classes", 0)
    labels = (np.arange(BATCH) % k).astype(np.int32) if k else None
    return z, images, labels


def _to_port(tree):
    return {net: convert.generator_from_jax(tree[net], {}, device="cpu")[0]
            for net in tree}


def _forwards(kw, train, seed=0):
    """G's images and D's logits on the real batch, both packages: (JAX
    numpy, port numpy) pairs."""
    params, state = _weights(kw, seed)
    z, images, labels = _inputs(kw)
    jcfg, tcfg = JModelConfig(**kw), ModelConfig(**kw)
    jl = None if labels is None else jnp.asarray(labels)
    tl = None if labels is None else torch.from_numpy(labels)

    @jax.jit
    def jax_forwards(p, s, z, images, labels):
        img, _ = jdcgan.generator_apply(p["gen"], s["gen"], z, cfg=jcfg,
                                        train=train, labels=labels)
        _, logit, _ = jdcgan.discriminator_apply(
            p["disc"], s["disc"], images, cfg=jcfg, train=train,
            labels=labels)
        return img, logit

    jimg, jlogit = jax_forwards(params, state, z, images, jl)
    tp, ts = _to_port(params), _to_port(state)
    with torch.no_grad():
        timg, _ = tdcgan.generator_apply(tp["gen"], ts["gen"],
                                         torch.from_numpy(z), cfg=tcfg,
                                         train=train, labels=tl)
        _, tlogit, _ = tdcgan.discriminator_apply(
            tp["disc"], ts["disc"], torch.from_numpy(images), cfg=tcfg,
            train=train, labels=tl)
    return ((np.asarray(jimg), timg.numpy()),
            (np.asarray(jlogit), tlogit.numpy()))


@pytest.mark.parametrize("kw", [TINY, dict(TINY, output_size=32),
                                COMPOSED],
                         ids=["16px", "32px", "composed"])
def test_names_and_shapes_equal_jax_init(kw):
    jparams, jstate = jax.eval_shape(
        lambda k: jdcgan.gan_init(k, JModelConfig(**kw)), jax.random.key(0))
    tparams, tstate = tdcgan.gan_init(ModelConfig(**kw), device="cpu")
    assert D.tree_shapes(tparams) == D.tree_shapes(jparams)
    assert D.tree_shapes(tstate) == D.tree_shapes(jstate)
    # the critic is norm-free: its state holds spectral-norm vectors only
    assert all(k.startswith("sn_") for k in tstate["disc"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["plain", "use_pallas"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "sampler"])
def test_forwards_match_jax(route, dtype, train):
    kw = dict(TINY, compute_dtype=dtype, **D.ROUTES[route])
    (jimg, timg), (jlogit, tlogit) = _forwards(kw, train)
    assert timg.shape == jimg.shape == (BATCH, 16, 16, 3)
    assert jimg.std() > 0.05   # not a near-constant image
    assert np.abs(timg - jimg).max() <= TOL[dtype]
    assert np.abs(tlogit - jlogit).max() <= \
        TOL[dtype] * np.abs(jlogit).max()


@pytest.mark.parametrize("route", ["plain", "use_pallas"])
def test_composition_forwards_match_jax(route):
    """cBN + two-head attention (the flash kernels' plain versions under
    use_pallas, interpret-mode Pallas on the JAX side) + SN on both nets,
    in train mode, f32."""
    kw = dict(COMPOSED, compute_dtype="float32", **D.ROUTES[route])
    (jimg, timg), (jlogit, tlogit) = _forwards(kw, train=True)
    assert np.abs(timg - jimg).max() <= TOL["float32"]
    assert np.abs(tlogit - jlogit).max() <= \
        TOL["float32"] * np.abs(jlogit).max()


@pytest.mark.parametrize("route", ["plain", "use_pallas"])
def test_gradients_match_jax(route):
    """d/d(params) of sum(D(G(z))) + sum(D(x)) in train mode, f32: G's
    gradient through its BatchNorm (kernel 3's plain version under
    use_pallas) and D's."""
    kw = dict(TINY, compute_dtype="float32", **D.ROUTES[route])
    params, state = _weights(kw, seed=2)
    z, images, _ = _inputs(kw, seed=3)
    jcfg, tcfg = JModelConfig(**kw), ModelConfig(**kw)

    def jloss(p):
        img, _ = jdcgan.generator_apply(p["gen"], state["gen"],
                                        jnp.asarray(z), cfg=jcfg,
                                        train=True)
        _, lf, _ = jdcgan.discriminator_apply(p["disc"], state["disc"], img,
                                              cfg=jcfg, train=True)
        _, lr, _ = jdcgan.discriminator_apply(p["disc"], state["disc"],
                                              jnp.asarray(images), cfg=jcfg,
                                              train=True)
        return jnp.sum(lf) + jnp.sum(lr)

    jgrads = jax.jit(jax.grad(jloss))(params)
    tp = {net: tsteps.tree_map(lambda t: t.requires_grad_(True), tree)
          for net, tree in _to_port(params).items()}
    ts = _to_port(state)
    img, _ = tdcgan.generator_apply(tp["gen"], ts["gen"],
                                    torch.from_numpy(z), cfg=tcfg,
                                    train=True)
    _, lf, _ = tdcgan.discriminator_apply(tp["disc"], ts["disc"], img,
                                          cfg=tcfg, train=True)
    _, lr, _ = tdcgan.discriminator_apply(tp["disc"], ts["disc"],
                                          torch.from_numpy(images),
                                          cfg=tcfg, train=True)
    leaves = tsteps.tree_leaves(tp)
    grads = torch.autograd.grad(lf.sum() + lr.sum(), leaves)
    got = dict(zip(convert.flatten(tp), grads))
    want = convert.flatten(jax.device_get(jgrads))
    assert sorted(got) == sorted(want)
    for net in ("gen", "disc"):
        scale = max(np.abs(w).max() for p, w in want.items()
                    if p.startswith(net))
        for path in (p for p in want if p.startswith(net)):
            err = np.abs(got[path].numpy() - want[path]).max()
            assert err <= 1e-4 * scale, (path, err, scale)


SNGAN = dict(loss="hinge", beta1=0.0, n_critic=5)
# G's biases whose output reaches the image through BatchNorms only (the
# blocks' convs and skips: the 3x3 convolutions all follow a BatchNorm,
# the skips are 1x1 or the identity; proj's bias is one per position and
# channel, so its gradient is real) and the running means they shift
RESNET_PRE_BN = re.compile(
    r"^(params/gen|ema_gen|opt/gen/(mu|nu)|bn/gen)/"
    r"(b\d+_(conv\d|skip)/b|(b\d+_bn\d|bn_out)/mean)$")
# the steps' learning rate: Adam's first updates move every element by
# ~lr times the sign of its gradient, so an element whose true gradient
# is 0 moves by +-lr on the sign of f32 summation noise. Beyond G's
# BN-fed biases, the hinge critic has such elements wherever a channel of
# its last block is active at every position of both batches (the real
# and the fake batch's terms cancel), and five critic updates carry the
# flips into every later gradient. At this rate a flip moves a leaf by
# less than the tolerance, while Adam's moments still pin each update's
# gradient: mu holds the last critic iteration's (beta1 0), nu all of them
STEP_LR = 1e-7


@pytest.mark.parametrize("route", ["use_pallas"])
def test_sngan_step_equals_jax_on_every_leaf(route):
    """One train step of the sngan-cifar10 recipe (hinge, n_critic 5,
    beta1 0, SN on D) at 16 px with G's BatchNorm on the kernels' plain
    versions (interpret-mode Pallas in JAX): five critic updates, each on
    its own z, then G's; every state leaf against the JAX step's."""
    jm, tm, jstate, tstate, _ = D.run_both(
        dict(SNGAN, learning_rate=STEP_LR), route, steps=1, batch=BATCH,
        model_kw={"arch": "resnet", "spectral_norm": "d"},
        numpy_weights=True)
    for k in jm[0]:
        assert abs(jm[0][k] - tm[0][k]) <= 1e-5, k
    D.assert_f32_state(jstate, tstate, lr=STEP_LR, steps=5,
                       pre_bn=RESNET_PRE_BN)


def test_wgan_gp_under_use_pallas_equals_jax():
    """The combination the port refused before: a penalty with G's
    BatchNorm on the kernels (WGAN-GP, n_critic 2). The JAX package traces
    it (its critic is norm-free), and the port's double backward runs
    through D only; R1 on the same critic is tests/test_torch_stylegan.py's
    lazy-R1 step."""
    jm, tm, jstate, tstate, _ = D.run_both(
        {"loss": "wgan-gp", "n_critic": 2, "beta1": 0.0,
         "learning_rate": STEP_LR}, "use_pallas", steps=1, batch=BATCH,
        model_kw={"arch": "resnet"}, numpy_weights=True)
    assert tm[0]["gp"] > 0
    for k in jm[0]:
        assert abs(jm[0][k] - tm[0][k]) <= 1e-5 * max(1, abs(jm[0][k])), k
    D.assert_f32_state(jstate, tstate, lr=STEP_LR, steps=2,
                       pre_bn=RESNET_PRE_BN)


def test_checkpoints_load_in_both_packages(tmp_path):
    """A JAX training state carried into the port, saved by the port's
    Checkpointer, restores bit for bit in the port and grafts into the
    JAX state tree bit for bit (`port_to_jax_state`), where the JAX
    sampler gives the port's images (1e-4)."""
    mk = dict(TINY, compute_dtype="float32", spectral_norm="d")
    jcfg = JTrainConfig(model=JModelConfig(**mk), batch_size=BATCH,
                        **SNGAN)
    cfg = TrainConfig(model=ModelConfig(**mk), batch_size=BATCH,
                      checkpoint_dir=str(tmp_path), **SNGAN)
    jfns = jsteps.make_train_step(jcfg)
    template = D.numpy_init(jfns.init)
    rng = np.random.default_rng(4)
    moved = jax.tree_util.tree_map(
        lambda a: (a + rng.normal(0, 0.01, a.shape)).astype(a.dtype)
        if a.dtype == np.float32 else a, template)
    state = convert.train_state_from_jax(moved, device="cpu")
    save_config(cfg, str(tmp_path))
    ck = Checkpointer(str(tmp_path))
    ck.save(3, state)
    ck.wait()
    restored = Checkpointer(str(tmp_path)).restore_latest(
        tsteps.init_train_state(cfg, device="cpu"))
    flat, back = convert.flatten(state), convert.flatten(restored)
    assert sorted(flat) == sorted(back)
    assert all(torch.equal(flat[k], back[k]) for k in flat)

    jstate = D.export_tool().port_to_jax_state(str(tmp_path), template)
    again = convert.flatten(convert.train_state_from_jax(jstate,
                                                         device="cpu"))
    assert sorted(again) == sorted(flat)
    assert all(torch.equal(again[k], flat[k]) for k in flat)
    zs = np.random.default_rng(3).uniform(-1, 1, (6, 8)).astype(np.float32)
    jimg = np.asarray(jax.jit(jfns.sample)(
        jax.tree_util.tree_map(jnp.asarray, jstate), jnp.asarray(zs)))
    timg = tdcgan.sampler_apply(restored["params"]["gen"],
                                restored["bn"]["gen"], torch.from_numpy(zs),
                                cfg=cfg.model).numpy()
    assert np.abs(jimg - timg).max() <= 1e-4


def test_summaries_carry_the_jax_names():
    """summarize's per-layer records carry the JAX names (gen/h0..h{k+1},
    disc/h*, disc/logit; `jax.eval_shape`, nothing of JAX's runs), with
    finite statistics."""
    kw = dict(TINY, compute_dtype="float32")
    jfns = jsteps.make_train_step(JTrainConfig(model=JModelConfig(**kw),
                                               batch_size=BATCH))
    tfns = tsteps.make_train_step(TrainConfig(model=ModelConfig(**kw),
                                              batch_size=BATCH))
    jstate = D.numpy_init(jfns.init)
    z, images, _ = _inputs(kw)
    want = jax.eval_shape(jfns.summarize, jstate, jnp.asarray(images),
                          jax.random.key(3))
    got = tfns.summarize(convert.train_state_from_jax(jstate, device="cpu"),
                         torch.from_numpy(images), torch.from_numpy(z))
    assert sorted(got) == sorted(want)
    assert "gen/h3" in got and "disc/logit" in got
    for name, rec in got.items():
        assert sorted(rec) == sorted(want[name]), name
        assert all(bool(torch.isfinite(torch.as_tensor(v)).all())
                   for v in rec.values())


def test_consumers_rebuild_the_family_from_config(tmp_path):
    """A resnet run's checkpoint directory generates with no flags: the
    consumers read config.json's arch, and generate's images are the
    sampler's on the restored weights."""
    cfg = TrainConfig(model=ModelConfig(**TINY), batch_size=BATCH,
                      checkpoint_dir=str(tmp_path), sample_every_steps=0,
                      activation_summary_steps=0, tensorboard=False,
                      **SNGAN)
    state = train(cfg, synthetic_data=True, max_steps=1, device="cpu")
    assert load_model_config(str(tmp_path)).arch == "resnet"
    out = tmp_path / "g.npz"
    generate.main(["--checkpoint_dir", str(tmp_path), "--num_images", "4",
                   "--batch_size", "4", "--grid", "2x2", "--npz", str(out),
                   "--out_dir", str(tmp_path / "grids"), "--device", "cpu"])
    with np.load(out) as data:
        images = data["images"]
    z = torch.from_numpy(generate.generate_z(0, 0, 4, TINY["z_dim"]))
    want = tdcgan.sampler_apply(state["params"]["gen"], state["bn"]["gen"],
                                z, cfg=cfg.model).numpy()
    np.testing.assert_array_equal(images, want)
