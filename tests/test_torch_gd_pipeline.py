"""Pipelined G/D dispatch (`pipeline_gd`) in the port against `dcgan_tpu`'s
on the CPU.

- GDPipeline's lifecycle (fill, steady, drain) on stub stage programs,
  each case run against both packages' classes
  (`tests/test_gd_pipeline.py:59-143`'s cases);
- the three config errors, with the JAX package's messages;
- the stage programs `gen_fakes`, `d_update` and `g_update` against the
  JAX package's, jitted (Pallas in interpret mode), from one state (JAX's
  init, carried over) over two pipelined steps: the fill, then D on the
  fill's stack and G making the next, then a steady step on that stack.
  Both get the JAX draws (`torch_jax_draws.stage_draws`) and the same
  numpy images. On all three routings with n_critic 1 and 2, and on the
  kernel route with grad_accum 2 and DiffAugment. Tolerances are
  tests/test_torch_train.py's (f32): losses 1e-5, fake stacks 1e-5 (tanh
  range), every state leaf 1e-5 abs + 1e-5 rel, the biases that feed a
  BatchNorm held to Adam's bound 2 * lr per update of their net;
- the trainer: the metric row's key set is the fused step's, checkpoints
  cross between the modes (the buffer is outside the state tree), the
  runner's stage rows equal eager stages bit for bit, a resume refills,
  and a JAX `config.json` with pipeline_gd=true trains in the port.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_jax_draws as D

from dcgan_tpu.config import ModelConfig as JModelConfig
from dcgan_tpu.config import TrainConfig as JTrainConfig
from dcgan_tpu.config import save_config as j_save_config
from dcgan_tpu.train import steps as jsteps
from dcgan_tpu.train.gd_pipeline import GDPipeline as JGDPipeline
from dcgan_tpu_torch import convert
from dcgan_tpu_torch.config import ModelConfig, TrainConfig, load_config
from dcgan_tpu_torch.train import cli, steps, trainer
from dcgan_tpu_torch.train.gd_pipeline import GDPipeline
from dcgan_tpu_torch.train.warmup import StepRunner, build_warmup_plan, \
    metric_keys
from dcgan_tpu_torch.utils.checkpoint import Checkpointer

BATCH = 4
SIZE = 16


# ---------------------------------------------------------------------------
# the buffer's lifecycle, on stub stage programs
# ---------------------------------------------------------------------------

class _Buf:
    def __init__(self, tag):
        self.tag = tag


class StubPT:
    """Records the stage calls the pipeline makes."""

    def __init__(self, name="pt"):
        self.name = name
        self.calls = []
        self._n = 0

    def gen_fakes(self, state, key):
        self._n += 1
        buf = _Buf(f"{self.name}-fill{self._n}")
        self.calls.append(("gen_fakes", buf.tag))
        return buf

    def d_update(self, state, images, fakes, key):
        self.calls.append(("d_update", fakes.tag))
        return state, {"d_loss": 0.5}

    def g_update(self, state, key):
        self._n += 1
        buf = _Buf(f"{self.name}-g{self._n}")
        self.calls.append(("g_update", buf.tag))
        return state, buf, {"g_loss": 0.25}


PIPELINES = pytest.mark.parametrize("cls", [GDPipeline, JGDPipeline],
                                    ids=["port", "jax"])


class TestLifecycle:
    @PIPELINES
    def test_first_step_fills_then_steady_state_consumes(self, cls):
        pipe, pt = cls(), StubPT()
        state = {}
        for _ in range(3):
            state, metrics = pipe.step(pt, state, None, None)
        assert metrics == {"d_loss": 0.5, "g_loss": 0.25}
        assert pipe.fills == 1 and pipe.steps == 3
        consumed = [tag for op, tag in pt.calls if op == "d_update"]
        assert consumed == ["pt-fill1", "pt-g2", "pt-g3"]

    @PIPELINES
    def test_checkpoint_boundary_keeps_buffer(self, cls):
        pipe, pt = cls(), StubPT()
        state, _ = pipe.step(pt, {}, None, None)
        state, _ = pipe.step(pt, state, None, None)
        assert pipe.fills == 1 and pipe.drains == 0 and pipe.primed

    @PIPELINES
    def test_drain_releases_buffer_and_next_step_refills(self, cls):
        pipe, pt = cls(), StubPT()
        state, _ = pipe.step(pt, {}, None, None)
        held = next(tag for op, tag in pt.calls if op == "g_update")
        assert pipe.drain("coordinated-stop") is True
        assert pipe._buf is None
        assert not pipe.primed and pipe.drains == 1
        assert (pipe.last_phase, pipe.last_drain_reason) == (
            "drain", "coordinated-stop")
        pipe.step(pt, state, None, None)
        assert pipe.fills == 2 and pipe.last_phase == "fill"
        consumed = [tag for op, tag in pt.calls if op == "d_update"]
        refill = [tag for op, tag in pt.calls if op == "gen_fakes"][-1]
        assert consumed[-1] == refill != held

    @PIPELINES
    def test_drain_on_empty_buffer_is_noop(self, cls):
        pipe = cls()
        assert pipe.drain("shutdown") is False and pipe.drains == 0
        pipe.step(StubPT(), {}, None, None)
        assert pipe.drain("stop") is True
        assert pipe.drain("stop") is False
        assert pipe.drains == 1

    @PIPELINES
    def test_phase_tags_follow_the_lifecycle(self, cls):
        pipe, pt = cls(), StubPT()
        assert pipe.last_phase == ""
        pipe.step(pt, {}, None, None)
        assert pipe.last_phase == "fill"
        pipe.step(pt, {}, None, None)
        assert pipe.last_phase == "steady"
        pipe.drain("x")
        assert pipe.last_phase == "drain"

    @PIPELINES
    def test_refill_uses_the_current_stage_programs(self, cls):
        pipe, old, new = cls(), StubPT("old"), StubPT("new")
        pipe.step(old, {}, None, None)
        pipe.drain("restore")
        pipe.step(new, {}, None, None)
        assert [tag for op, tag in new.calls if op == "d_update"] == [
            "new-fill1"]


# ---------------------------------------------------------------------------
# the config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {"update_mode": "fused"}, {"steps_per_call": 2}, "conditional"])
def test_config_errors_match_jax(kw):
    """pipeline_gd's three ValueErrors, with the JAX messages; a
    conditional model is served, and refused with pipeline_gd only."""
    if kw == "conditional":
        jm = JModelConfig(output_size=SIZE, num_classes=4)
        tm = ModelConfig(output_size=SIZE, num_classes=4)
        kw = {}
    else:
        jm, tm = JModelConfig(output_size=SIZE), ModelConfig(
            output_size=SIZE)
    errors = []
    for cls, m in ((JTrainConfig, jm), (TrainConfig, tm)):
        with pytest.raises(ValueError) as e:
            cls(model=m, pipeline_gd=True, **kw)
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "pipeline_gd" in errors[0]
    assert TrainConfig(model=ModelConfig(output_size=SIZE, num_classes=4))


def test_cli_flag_and_plan_rows():
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        ["--pipeline_gd", "--nan_check_steps", "7"]))
    assert cfg.pipeline_gd and cfg.nan_check_steps == 7
    assert not cli.config_from_args(cli.build_parser().parse_args(
        ["--pipeline_gd", "false"])).pipeline_gd
    assert build_warmup_plan(cfg, sample=True) == [
        "gen_fakes", "d_update", "g_update", "sampler"]
    lazy = dataclasses.replace(cfg, r1_gamma=1.0, r1_interval=4)
    assert build_warmup_plan(lazy, sample=False) == [
        "gen_fakes", "d_update/r1=0", "d_update/r1=1", "g_update"]


def test_draw_stages_layout():
    gen = torch.Generator().manual_seed(0)
    cfg = TrainConfig(model=ModelConfig(output_size=SIZE, z_dim=8),
                      batch_size=BATCH, loss="wgan-gp", n_critic=2,
                      diffaug="translation", pipeline_gd=True)
    d = steps.draw_stages(cfg, gen)
    assert sorted(d) == sorted(
        [f"d/critic{i}/{k}" for i in range(2)
         for k in ("eps", "real/0/ty", "real/0/tx", "fake/0/ty",
                   "fake/0/tx")]
        + ["g/z", "g/extra_z", "g/aug/0/ty", "g/aug/0/tx", "fill/z"])
    assert d["g/extra_z"].shape == (1, BATCH, 8)
    assert d["fill/z"].shape == (2, BATCH, 8)
    jcfg = JTrainConfig(model=JModelConfig(output_size=SIZE, z_dim=8),
                        batch_size=BATCH, loss="wgan-gp", n_critic=2,
                        diffaug="translation", pipeline_gd=True)
    want = D.stage_draws(jcfg, jax.random.key(3), BATCH)
    assert sorted(want) == sorted(d)
    assert all(want[k].shape == tuple(d[k].shape) for k in d)


# ---------------------------------------------------------------------------
# the stage programs against the JAX package's
# ---------------------------------------------------------------------------

CASES = [("plain", {}), ("plain", {"n_critic": 2}),
         ("use_pallas", {}), ("use_pallas", {"n_critic": 2}),
         ("fused", {}), ("fused", {"n_critic": 2}),
         ("fused", {"grad_accum": 2, "diffaug": "color,translation,cutout"})]
CASE_IDS = [f"{r}-" + ("-".join(f"{k}{v}" for k, v in kw.items()) or "base")
            for r, kw in CASES]


def _cfgs(route, kw):
    mk = dict(output_size=SIZE, gf_dim=8, df_dim=8, z_dim=8,
              compute_dtype="float32", **D.ROUTES[route])
    return (JTrainConfig(model=JModelConfig(**mk), batch_size=BATCH,
                         pipeline_gd=True, **kw),
            TrainConfig(model=ModelConfig(**mk), batch_size=BATCH,
                        pipeline_gd=True, **kw))


@functools.lru_cache(maxsize=None)
def _jax_init_cached(dtype):
    """One jitted JAX init for every case: the state tree does not depend
    on the routing, n_critic or grad_accum."""
    jcfg, _ = _cfgs("plain", {})
    return jax.device_get(jax.jit(jsteps.make_train_step(jcfg).init)(
        jax.random.key(0)))


def _jax_init(dtype):
    return jax.tree_util.tree_map(jnp.asarray, _jax_init_cached(dtype))


@pytest.fixture(scope="module", params=CASES, ids=CASE_IDS)
def two_steps(request):
    """Two pipelined steps of both packages from one state: (JAX
    records, port records), each {"fill", "d1", "g1", "d2", "g2"}: the
    fill's stack, then per step the state and metrics after d_update and
    the state, metrics and next stack after g_update."""
    route, kw = request.param
    jcfg, tcfg = _cfgs(route, kw)
    jfns = jsteps.make_train_step(jcfg)
    tfns = steps.make_train_step(tcfg)
    jstate = _jax_init(jcfg.model.compute_dtype)
    tstate = convert.train_state_from_jax(jax.device_get(jstate),
                                          device="cpu")
    jgen, jd, jg = (jax.jit(jfns.gen_fakes), jax.jit(jfns.d_update),
                    jax.jit(jfns.g_update))
    rng = np.random.default_rng(1)
    jrec, trec = {"cfg": tcfg}, {"cfg": tcfg}
    jfakes = tfakes = None
    for i in (1, 2):
        images = np.tanh(rng.normal(size=(BATCH, SIZE, SIZE, 3))).astype(
            np.float32)
        key = jax.random.fold_in(jax.random.key(5), i)
        draws = D.to_torch(D.stage_draws(jcfg, key, BATCH))
        if jfakes is None:
            jfakes, tfakes = jgen(jstate, key), tfns.gen_fakes(tstate,
                                                               draws)
            jrec["fill"], trec["fill"] = np.asarray(jfakes), tfakes.numpy()
        jstate, jm = jd(jstate, jnp.asarray(images), jfakes, key)
        tstate, tm = tfns.d_update(tstate, torch.from_numpy(images),
                                   tfakes, draws)
        jrec[f"d{i}"] = (jax.device_get(jstate), jm)
        trec[f"d{i}"] = (tstate, tm)
        jstate, jfakes, jgm = jg(jstate, key)
        tstate, tfakes, tgm = tfns.g_update(tstate, draws)
        jrec[f"g{i}"] = (jax.device_get(jstate), jgm, np.asarray(jfakes))
        trec[f"g{i}"] = (tstate, tgm, tfakes.numpy())
    return jrec, trec


def _metrics_close(jm, tm):
    assert set(jm) == set(tm)
    for k in jm:
        assert abs(float(jm[k]) - float(tm[k])) <= 1e-5, (k, jm[k], tm[k])


def test_gen_fakes_matches_jax(two_steps):
    jrec, trec = two_steps
    assert trec["fill"].shape == jrec["fill"].shape == (
        trec["cfg"].n_critic, BATCH, SIZE, SIZE, 3)
    np.testing.assert_allclose(trec["fill"], jrec["fill"], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("i", [1, 2], ids=["fill-step", "steady-step"])
def test_d_update_matches_jax(two_steps, i):
    jrec, trec = two_steps
    n = trec["cfg"].n_critic
    (js, jm), (ts, tm) = jrec[f"d{i}"], trec[f"d{i}"]
    _metrics_close(jm, tm)
    assert set(tm) == set(metric_keys(trec["cfg"])) - {"g_loss"}
    D.assert_f32_state(js, ts, steps=i * n)
    assert int(ts["opt"]["disc"]["count"]) == i * n
    assert int(ts["step"]) == i - 1


@pytest.mark.parametrize("i", [1, 2], ids=["fill-step", "steady-step"])
def test_g_update_matches_jax(two_steps, i):
    jrec, trec = two_steps
    n = trec["cfg"].n_critic
    (js, jm, jf), (ts, tm, tf) = jrec[f"g{i}"], trec[f"g{i}"]
    _metrics_close(jm, tm)
    assert tf.shape == jf.shape
    np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-5)
    D.assert_f32_state(js, ts, steps=i * n)
    assert int(ts["step"]) == i and int(ts["opt"]["gen"]["count"]) == i


# ---------------------------------------------------------------------------
# the trainer and the runner
# ---------------------------------------------------------------------------

def _train_cfg(tmp_path, **kw):
    base = dict(model=ModelConfig(output_size=SIZE, gf_dim=8, df_dim=8,
                                  z_dim=8, compute_dtype="float32"),
                batch_size=BATCH, checkpoint_dir=str(tmp_path / "ck"),
                sample_dir=str(tmp_path / "sm"), sample_every_steps=0,
                activation_summary_steps=0, save_model_secs=0.0,
                save_summaries_secs=0.0, tensorboard=False)
    base.update(kw)
    return TrainConfig(**base)


def _scalar_rows(directory):
    with open(os.path.join(directory, "events.jsonl")) as f:
        return [json.loads(line) for line in f
                if json.loads(line)["kind"] == "scalars"]


def test_runner_stage_rows_equal_eager_stages(tmp_path):
    """The runner's three stage rows (eager on the CPU, over the static
    state and stack slot) equal a GDPipeline over the step functions bit
    for bit: a fill, steady steps, a drain and a refill, on the kernel
    route with n_critic 2."""
    cfg = _train_cfg(tmp_path, n_critic=2, pipeline_gd=True,
                     model=ModelConfig(output_size=SIZE, gf_dim=8, df_dim=8,
                                       z_dim=8, compute_dtype="float32",
                                       use_pallas=True, pallas_fused=True))
    fns = steps.make_train_step(cfg)
    s0 = fns.init(seed=0, device="cpu")
    runner = StepRunner(fns, steps.tree_map(torch.clone, s0), cfg,
                        torch.device("cpu"))
    pipe, state = GDPipeline(), s0
    g = torch.Generator().manual_seed(3)
    for i in range(4):
        images = torch.rand(BATCH, SIZE, SIZE, 3, generator=g) * 2 - 1
        draws = trainer.stage_inputs(cfg, i, torch.device("cpu"))
        state, m = pipe.step(fns, state, images, draws)
        got = runner.pipelined_step(images, draws, start=i)
        assert got.tolist()[0] == [float(m[k]) for k in runner.keys]
        if i == 1:
            pipe.drain("x")
            runner.pipeline.drain("x")
    assert pipe.fills == runner.pipeline.fills == 2
    assert sorted(runner.programs) == ["d_update", "g_update", "gen_fakes"]
    for a, b in zip(steps.tree_leaves(state),
                    steps.tree_leaves(runner.state)):
        assert torch.equal(a, b)
    runner.close()
    assert not runner.programs


def test_trainer_rows_and_checkpoints_cross_modes(tmp_path, monkeypatch):
    """A pipelined run writes the fused run's metric keys; its checkpoint
    has the fused run's state tree; a fused run resumes from it and a
    pipelined run from the fused run's, each resume refilling."""
    fused = _train_cfg(tmp_path / "a")
    piped = dataclasses.replace(
        _train_cfg(tmp_path / "b"), pipeline_gd=True)
    trainer.train(fused, synthetic_data=True, max_steps=2, device="cpu")
    trainer.train(piped, synthetic_data=True, max_steps=2, device="cpu")
    rf, rp = _scalar_rows(fused.checkpoint_dir), _scalar_rows(
        piped.checkpoint_dir)
    assert [r["step"] for r in rp] == [1, 2]
    assert set(rf[-1]["values"]) == set(rp[-1]["values"])
    trees = [np.load(os.path.join(c.checkpoint_dir, "2", "state.npz"))
             for c in (fused, piped)]
    assert sorted(trees[0].files) == sorted(trees[1].files)
    fills = []
    real_load = StepRunner.load

    def load(self, tree):
        real_load(self, tree)
        if self.pipeline is not None:
            fills.append(self.pipeline.primed)
    monkeypatch.setattr(StepRunner, "load", load)
    # each directory resumes in the other mode
    a = trainer.train(dataclasses.replace(fused, pipeline_gd=True),
                      synthetic_data=True, max_steps=3, device="cpu")
    b = trainer.train(dataclasses.replace(piped, pipeline_gd=False),
                      synthetic_data=True, max_steps=3, device="cpu")
    assert int(a["step"]) == int(b["step"]) == 3
    assert fills == [False]   # the restored pipelined runner refills
    assert Checkpointer(fused.checkpoint_dir).latest_step() == 3


def test_jax_config_with_pipeline_gd_trains(tmp_path):
    """A JAX `config.json` with pipeline_gd=true loads (no longer
    refused) and trains in the port."""
    jcfg = JTrainConfig(model=JModelConfig(output_size=SIZE, gf_dim=8,
                                           df_dim=8, z_dim=8,
                                           compute_dtype="float32"),
                        batch_size=BATCH, pipeline_gd=True,
                        checkpoint_dir=str(tmp_path / "ck"),
                        sample_dir=str(tmp_path / "sm"),
                        sample_every_steps=0, activation_summary_steps=0)
    j_save_config(jcfg, jcfg.checkpoint_dir)
    cfg = load_config(jcfg.checkpoint_dir)
    assert cfg.pipeline_gd
    cfg = dataclasses.replace(cfg, tensorboard=False)
    state = trainer.train(cfg, synthetic_data=True, max_steps=2,
                          device="cpu")
    assert int(state["step"]) == 2
    rows = _scalar_rows(cfg.checkpoint_dir)
    assert all(np.isfinite(v) for v in rows[-1]["values"].values())
