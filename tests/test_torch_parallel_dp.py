"""The port's data parallelism over processes against the JAX package's
two backends on the CPU (gf = df = 8, 16 px, global batch 8).

A gloo world of 2 ranks (the kernel-route case of 4), spawned by
`dcgan_tpu_torch/testing/multihost.py::run_world` (tests/torch_dp_worker.py
holds the ranks), trains 2 steps from the JAX backend's own init on the
same numpy images and the JAX draws: under `gspmd` the global draws of
`step_draws(key)`, each rank taking its rows; under `shard_map` each
rank's draws of `step_draws(fold_in(key, rank))`, as the JAX backend
folds the shard index. The JAX side runs `make_parallel_train` on as
many virtual CPU devices, its Pallas kernels in interpret mode; the
port's ranks run the kernels' plain twins. After 2 steps every rank's
state is bit for bit the same, and every leaf agrees with JAX within
tests/torch_jax_draws.py's f32 rule (1e-5 abs + 1e-5 x the leaf's
largest value; the biases that feed a BatchNorm and the running means
they shift within Adam's own bound, 2 * lr * updates, n_critic updates
a step, as tests/test_torch_critic_accum.py holds them); the losses within
1e-5 (the order of the cross-rank sums differs from XLA's).

One difference is the reference's: on the plain route the JAX shard_map
backend checks replication (check_vma), and its AD then sums the
gradient of every replicated parameter over the shards before the
step's explicit pmean divides it by N, so its gradients are N times the
mean (the kernel route runs unchecked and takes the mean, as gspmd
does). The parameters, BN statistics and EMA still agree (Adam's update
does not see the scale), and the JAX Adam moments are N and N^2 times
the port's; the case pins exactly that (ROADMAP Queue C item 16), and
fails the day the reference takes the mean.

Also: the sampler's gathered images, `eval_losses` and `summarize`'s
global statistics against JAX's on JAX's trained state (the same
weights: the BN-feeding biases, held to Adam's bound above, do not
cancel under running statistics), within 1e-5; world N against the
port's own world 1 on the same global batch and draws (the port's init
and draws, grad_accum and n_critic in one case: each rank's rows of every
global microbatch), within the same rule.

And the units that hold the port against the JAX copies: `MeshConfig`
and the TrainConfig mesh fields (defaults, checks and messages,
config.json both ways), the settings refused by name (ROADMAP Queue A
item 7), the mesh's axis sizes, the layout checks, the gspmd rows, the
programs' names, the per-process shards.

The units share this file with the parity worlds so that it collects
many tests: pytest-xdist's loadfile queue takes files by test count,
largest first, and so starts the worlds early in a run, not at its
tail.
"""

import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

from dcgan_tpu import config as j_config
from dcgan_tpu.config import MeshConfig as JMeshConfig
from dcgan_tpu.config import ModelConfig as JModelConfig
from dcgan_tpu.config import TrainConfig as JTrainConfig
from dcgan_tpu.data import pipeline as j_pipeline
from dcgan_tpu.parallel import make_parallel_train
from dcgan_tpu.parallel.mesh import make_mesh as j_make_mesh
from dcgan_tpu_torch import config
from dcgan_tpu_torch.config import MeshConfig, ModelConfig, TrainConfig
from dcgan_tpu_torch.data.pipeline import shard_for_process
from dcgan_tpu_torch.parallel.api import check_layout, rank_rows
from dcgan_tpu_torch.parallel.api import \
    make_parallel_train as t_make_parallel_train
from dcgan_tpu_torch.parallel.distributed import World
from dcgan_tpu_torch.parallel.mesh import make_mesh as t_make_mesh
from dcgan_tpu_torch.testing.multihost import run_world
from dcgan_tpu_torch.train import steps as tsteps
from torch_jax_draws import ROUTES, flat_state, one_torch_thread, \
    step_draws  # noqa: F401

TESTS = str(__import__("pathlib").Path(__file__).resolve().parent)
BATCH, SIZE, STEPS, LR = 8, 16, 2, 2e-4
PRE_BN = re.compile(r"(proj|deconv[1-9]|conv[1-9])/b$|bn[0-9]+/mean$")
WORLD_TIMEOUT = 240.0
SAGAN = {"attn_res": 8, "spectral_norm": "gd", "use_pallas": True,
         "bn_pallas": False}
TINY = dict(output_size=16, gf_dim=8, df_dim=8, z_dim=8,
            compute_dtype="float32")
CASES = {
    # (route, backend, world, model extras, train extras)
    "gspmd-plain": ("plain", "gspmd", 2, {}, {}),
    "shard_map-plain": ("plain", "shard_map", 2, {}, {}),
    "gspmd-kernels-w4": ("fused", "gspmd", 4, {}, {}),
    "shard_map-sagan": ("plain", "shard_map", 2, SAGAN,
                        {"loss": "hinge", "beta1": 0.0,
                         "g_ema_decay": 0.999}),
}


def _model_kw(route, extra):
    return dict(output_size=SIZE, gf_dim=8, df_dim=8, z_dim=8,
                compute_dtype="float32", **ROUTES[route], **extra)


def _jax_run(route, backend, n, model_extra, train_extra, probes=False):
    """2 steps of the JAX backend on n virtual devices; returns (the
    numpy init, the per-step inputs in the port's layout, JAX's metrics
    per step, its final numpy state, its probes)."""
    mk = _model_kw(route, model_extra)
    jcfg = JTrainConfig(model=JModelConfig(**mk), batch_size=BATCH,
                        mesh=JMeshConfig(data=n), backend=backend,
                        **train_extra)
    pt = make_parallel_train(jcfg, j_make_mesh(jcfg.mesh,
                                               jax.devices()[:n]))
    state = pt.init(jax.random.key(0))
    init = jax.device_get(state)
    rng = np.random.default_rng(1)
    steps, metrics = [], []
    for i in range(STEPS):
        images = np.tanh(rng.normal(size=(BATCH, SIZE, SIZE, 3))).astype(
            np.float32)
        key = jax.random.fold_in(jax.random.key(5), i)
        if backend == "gspmd":
            z, draws = step_draws(jcfg, key, BATCH)
        else:
            per = [step_draws(jcfg, jax.random.fold_in(key, r), BATCH // n)
                   for r in range(n)]
            z, draws = [p[0] for p in per], [p[1] for p in per]
        steps.append({"images": images, "z": z, "draws": draws})
        state, m = pt.step(state, jax.numpy.asarray(images), key)
        metrics.append({k: float(v) for k, v in m.items()})
    out = {}
    if probes:
        images = np.tanh(rng.normal(size=(BATCH, SIZE, SIZE, 3))).astype(
            np.float32)
        z = np.asarray(jax.random.uniform(jax.random.key(7), (BATCH, 8),
                                          minval=-1.0, maxval=1.0))
        skey = jax.random.key(9)
        if backend == "gspmd":
            sz = np.asarray(jax.random.uniform(skey, (BATCH, 8),
                                               minval=-1.0, maxval=1.0))
        else:
            sz = [np.asarray(jax.random.uniform(
                jax.random.fold_in(skey, r), (BATCH // n, 8), minval=-1.0,
                maxval=1.0)) for r in range(n)]
        out = {"inputs": {"sample_z": z, "eval_images": images,
                          "eval_z": z, "summary_images": images,
                          "summary_z": sz},
               "sample": np.asarray(pt.sample(state, z)),
               "eval": {k: float(v) for k, v in pt.eval_losses(
                   state, images, z).items()},
               "summary": jax.device_get(pt.summarize(state, images,
                                                      skey))}
    return init, steps, metrics, jax.device_get(state), out


def _port_run(route, backend, n, model_extra, train_extra, init, steps,
              probes=None):
    return run_world("torch_dp_worker:train", n, kwargs=dict(
        model_kw=_model_kw(route, model_extra), train_kw=dict(
            batch_size=BATCH, **train_extra), backend=backend, state=init,
        steps=steps, probes=probes), paths=[TESTS], timeout=WORLD_TIMEOUT)


def _assert_ranks_equal(outs):
    for r in range(1, len(outs)):
        for path, v in outs[0]["state"].items():
            assert np.array_equal(outs[r]["state"][path], v), (r, path)
        assert outs[r]["metrics"] == outs[0]["metrics"]


def _want(jstate):
    from dcgan_tpu_torch import convert

    return flat_state(convert.train_state_from_jax(jstate, device="cpu"))


def _assert_leaves(got, want, scale=None, updates=STEPS):
    """Every leaf within the f32 rule (`updates` Adam updates); `scale
    (path)` multiplies the port's leaf first (the reference's shard_map
    moments)."""
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path].astype(np.float64) * (scale(path) if scale else 1.0)
        bound = 2 * LR * updates if PRE_BN.search(path) \
            else 1e-5 + 1e-5 * np.abs(w).max(initial=0.0)
        err = float(np.abs(g - w).max(initial=0.0))
        assert err <= bound, (path, err, bound)


def _assert_metrics(got, want):
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert abs(g[k] - w[k]) <= 1e-5 * max(1.0, abs(w[k])), (k, g, w)


@pytest.mark.parametrize("case", sorted(CASES))
def test_world_matches_jax_backend(case):
    route, backend, n, mx, tx = CASES[case]
    probes = case in ("gspmd-plain", "shard_map-plain")
    init, steps, jm, jstate, jprobe = _jax_run(route, backend, n, mx, tx,
                                               probes=probes)
    outs = _port_run(route, backend, n, mx, tx, init, steps,
                     probes and {**jprobe["inputs"], "state": jstate})
    _assert_ranks_equal(outs)
    _assert_metrics(outs[0]["metrics"], jm)
    scale = None
    if case == "shard_map-plain":
        # the reference's check_vma sum: JAX's mu is n x, nu n^2 x
        def scale(path):
            return n if "/mu/" in path else n * n if "/nu/" in path else 1
    _assert_leaves(outs[0]["state"], _want(jstate), scale,
                   updates=STEPS * tx.get("n_critic", 1))
    if probes:
        for out in outs:
            np.testing.assert_allclose(out["sample"], jprobe["sample"],
                                       atol=1e-5, rtol=1e-5)
            _assert_metrics([out["eval"]], [jprobe["eval"]])
            _assert_summary(out["summary"], jprobe["summary"])


def _assert_summary(got, want):
    """The global activation statistics: every layer's count exactly,
    min, max, mean, std, zero share and edges within 1e-5, and the bin
    counts within 2 of JAX's (a value within f32 rounding of an edge may
    fall on either side)."""
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert int(g["count"]) == int(w["count"]), name
        for k in ("min", "max", "mean", "std", "zero_fraction",
                  "bin_edges"):
            np.testing.assert_allclose(np.asarray(g[k]), np.asarray(w[k]),
                                       atol=1e-5, rtol=1e-5,
                                       err_msg=f"{name}/{k}")
        gc, wc = np.asarray(g["bin_counts"]), np.asarray(w["bin_counts"])
        assert gc.sum() == wc.sum() == int(w["count"]), name
        assert np.abs(gc - wc).max() <= 2, (name, gc, wc)


@pytest.mark.parametrize("route,n,tx", [
    ("fused", 2, {}), ("plain", 4, {"grad_accum": 2, "n_critic": 2})])
def test_world_matches_port_world_one(route, n, tx):
    """World n against the port's own world 1 on the same global batch
    and draws (gspmd: the trainer's step generator, each rank taking its
    rows of every global microbatch): the ranks bit for bit equal, every
    leaf within the f32 rule of world 1's (only the order of the
    cross-rank sums differs)."""
    cfg = TrainConfig(model=ModelConfig(**_model_kw(route, {})),
                      batch_size=BATCH, **tx)
    rng = np.random.default_rng(1)
    steps = []
    for i in range(STEPS):
        gen = tsteps.step_generator(cfg, i, torch.device("cpu"))
        z = torch.rand((BATCH, 8), generator=gen) * 2 - 1
        steps.append({
            "images": np.tanh(rng.normal(size=(BATCH, SIZE, SIZE, 3))
                              ).astype(np.float32), "z": z.numpy(),
            "draws": {k: v.numpy()
                      for k, v in tsteps.draw_step(cfg, gen).items()}})
    one = _port_run(route, "gspmd", 1, {}, tx, None, steps)[0]
    outs = _port_run(route, "gspmd", n, {}, tx, None, steps)
    _assert_ranks_equal(outs)
    _assert_metrics(outs[0]["metrics"], one["metrics"])
    _assert_leaves(outs[0]["state"], one["state"],
                   updates=STEPS * tx.get("n_critic", 1))


# ---------------------------------------------------------------------------
# MeshConfig and the TrainConfig fields against the JAX copies
# ---------------------------------------------------------------------------

def test_mesh_fields_and_defaults_are_the_jax_ones():
    assert dataclasses.asdict(MeshConfig()) == \
        dataclasses.asdict(JMeshConfig())
    assert MeshConfig() == JMeshConfig() and JMeshConfig() == MeshConfig()
    assert MeshConfig(data=8) != JMeshConfig() and MeshConfig(data=8) != 8
    assert len({MeshConfig(), MeshConfig(data=-1)}) == 1
    for name in ("mesh", "backend", "comm_overlap", "comm_bucket_mb"):
        assert getattr(TrainConfig(), name) == getattr(JTrainConfig(), name)


@pytest.mark.parametrize("kw", [{"zero_stage": 4},
                                {"spatial": True},
                                {"zero_stage": 2, "spatial": True,
                                 "model": 2}])
def test_mesh_checks_carry_the_jax_messages(kw):
    with pytest.raises(ValueError) as j:
        JMeshConfig(**kw)
    with pytest.raises(ValueError) as t:
        MeshConfig(**kw)
    assert str(t.value) == str(j.value)


@pytest.mark.parametrize("mesh,train", [
    ({"model": 2}, {}), ({"model": 2, "spatial": True, "shard_opt": True},
                         {}),
    ({"shard_opt": True}, {}), ({"zero_stage": 2}, {}),
    ({"zero_stage": 3}, {}), ({}, {"comm_overlap": "bucket"})])
def test_unported_mesh_settings_refused_by_name(mesh, train):
    """What the JAX package trains and the port does not: refused with
    NotImplementedError naming Queue A item 7, in the constructor and in
    a JAX config.json."""
    jcfg = JTrainConfig(mesh=JMeshConfig(**mesh), **train)
    with pytest.raises(NotImplementedError, match="Queue A item 7"):
        TrainConfig(mesh=MeshConfig(**mesh), **train)
    d = j_config.config_to_dict(jcfg) if hasattr(j_config, "config_to_dict") \
        else dataclasses.asdict(jcfg)
    with pytest.raises(NotImplementedError, match="Queue A item 7"):
        config.config_from_dict(d)


def test_train_config_checks_carry_the_jax_messages():
    for kw in ({"backend": "pmap"}, {"comm_overlap": "nope"},
               {"comm_bucket_mb": 0}):
        with pytest.raises(ValueError) as j:
            JTrainConfig(**kw)
        with pytest.raises(ValueError) as t:
            TrainConfig(**kw)
        assert str(t.value) == str(j.value)


@pytest.mark.parametrize("mesh,n", [({}, 4), ({"data": 2}, 2),
                                    ({"data": 8}, 2), ({"data": 3}, 4)])
def test_axis_sizes_equal_jax(mesh, n):
    """The (data, model) layout over n ranks, or the JAX error (data=8 on
    a world of another size raises)."""
    try:
        want = j_make_mesh(JMeshConfig(**mesh), jax.devices()[:n]).shape
    except ValueError as e:
        with pytest.raises(ValueError) as t:
            t_make_mesh(MeshConfig(**mesh), n)
        assert str(t.value) == str(e)
        return
    assert t_make_mesh(MeshConfig(**mesh), n).shape == dict(want)


def test_config_json_round_trips_the_mesh(tmp_path):
    jcfg = JTrainConfig(model=JModelConfig(**TINY), batch_size=16,
                        mesh=JMeshConfig(data=8), backend="shard_map",
                        comm_bucket_mb=8)
    j_config.save_config(jcfg, str(tmp_path / "jax"))
    cfg = config.load_config(str(tmp_path / "jax"))
    assert isinstance(cfg.mesh, MeshConfig) and cfg.mesh == jcfg.mesh
    assert (cfg.backend, cfg.comm_overlap, cfg.comm_bucket_mb) == \
        ("shard_map", "off", 8)
    config.save_config(cfg, str(tmp_path / "port"))
    assert j_config.load_config(str(tmp_path / "port")) == jcfg


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch,world,accum,want", [
    (8, 2, 1, [[0, 1, 2, 3], [4, 5, 6, 7]]),
    (8, 2, 2, [[0, 1, 4, 5], [2, 3, 6, 7]]),
    (8, 4, 2, [[0, 4], [1, 5], [2, 6], [3, 7]])])
def test_rank_rows(batch, world, accum, want):
    """The gspmd rows: the rank's share of each global microbatch."""
    got = [rank_rows(batch, r, world, accum).tolist() for r in range(world)]
    assert got == want


@pytest.mark.parametrize("batch,accum,n", [(6, 1, 4), (8, 4, 4)])
def test_layout_checks_carry_the_jax_messages(batch, accum, n):
    from dcgan_tpu.parallel.shard_map_backend import make_shard_map_train

    jcfg = JTrainConfig(model=JModelConfig(**TINY), batch_size=batch,
                        grad_accum=accum, backend="shard_map")
    with pytest.raises(ValueError) as j:
        make_shard_map_train(jcfg, j_make_mesh(JMeshConfig(),
                                               jax.devices()[:n]))
    with pytest.raises(ValueError) as t:
        check_layout(TrainConfig(model=ModelConfig(**TINY),
                                 batch_size=batch, grad_accum=accum), n)
    assert str(t.value) == str(j.value)


def test_programs_under_the_jax_names():
    w = World(rank=0, size=1, local_rank=0, device=torch.device("cpu"))
    par = t_make_parallel_train(TrainConfig(model=ModelConfig(**TINY),
                                            batch_size=4), w)
    assert sorted(par.programs) == sorted(
        ["init", "train_step", "multi_step", "sampler", "summarize",
         "eval_losses", "gen_fakes", "d_update", "g_update"])
    assert par.local_cfg is par.cfg and par.mesh.shape == {"data": 1,
                                                           "model": 1}
    with pytest.raises(ValueError, match="does not cover 1 devices"):
        t_make_parallel_train(TrainConfig(model=ModelConfig(**TINY),
                                          mesh=MeshConfig(data=8)), w)


def test_shard_for_process_equals_jax():
    for n_shards, count in ((5, 2), (1, 3), (8, 4)):
        paths = [f"s{i}.tfrecord" for i in range(n_shards)]
        for idx in range(count):
            assert shard_for_process(paths, idx, count) == \
                j_pipeline.shard_for_process(paths, idx, count)
