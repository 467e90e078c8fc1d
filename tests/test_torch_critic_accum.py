"""n_critic, gradient accumulation and DiffAugment in the port's step
against `dcgan_tpu`'s on the CPU, and the same steps through the trainer
and its captured runner's CPU path.

Both packages start from the JAX init (carried over), take 2 steps on the
same numpy images with the JAX step's draws (z per critic iteration,
microbatch and augmentation streams, recomputed from its key by
tests/torch_jax_draws.py); JAX jitted with its Pallas kernels in interpret
mode, the port on its plain versions. Tolerances are
tests/test_torch_train.py's (f32): losses 1e-5 at every step; every state
leaf 1e-5 abs + 1e-5 rel, the biases that feed a BatchNorm held to Adam's
bound 2 * lr per update of their net.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch_jax_draws as D

from dcgan_tpu_torch.config import ModelConfig, TrainConfig
from dcgan_tpu_torch.train import cli, steps, trainer
from dcgan_tpu_torch.train.warmup import StepRunner, build_warmup_plan, \
    metric_keys, r1_patterns
from torch_jax_draws import one_torch_thread  # noqa: F401

CASES = [{"n_critic": 2}, {"grad_accum": 2},
         {"n_critic": 2, "grad_accum": 2, "diffaug": "color"}]


@pytest.mark.parametrize("route", ["plain", "fused"])
@pytest.mark.parametrize("kw", CASES)
def test_two_steps_match_jax(kw, route):
    jm, tm, js, ts, _ = D.run_both(kw, route, steps=2)
    for j, t in zip(jm, tm):
        assert set(j) == set(t)
        for k in j:
            assert abs(j[k] - t[k]) <= 1e-5, (k, j[k], t[k])
    D.assert_f32_state(js, ts, steps=2 * kw.get("n_critic", 1))
    assert int(ts["opt"]["disc"]["count"]) == 2 * kw.get("n_critic", 1)
    assert int(ts["opt"]["gen"]["count"]) == 2


def test_draw_step_layout():
    """The draws of one step: the critic iterations' z, WGAN-GP's weights,
    the augmentations of D's two batches per iteration and of G's; none
    for a config without them."""
    gen = torch.Generator().manual_seed(0)
    small = dict(model=ModelConfig(output_size=16, z_dim=8), batch_size=4)
    assert steps.draw_step(TrainConfig(**small), gen) == {}
    d = steps.draw_step(TrainConfig(loss="wgan-gp", n_critic=2,
                                    diffaug="translation", **small), gen)
    assert sorted(d) == sorted(
        [f"critic{i}/{k}" for i in range(2)
         for k in ("z", "eps", "real/0/ty", "real/0/tx", "fake/0/ty",
                   "fake/0/tx")] + ["g/0/ty", "g/0/tx"])
    assert d["critic1/z"].shape == (4, 8) and d["critic0/eps"].shape == (4,)
    assert float(d["critic0/z"].abs().max()) <= 1.0


def _cfg(tmp_path, **kw):
    return TrainConfig(
        model=ModelConfig(output_size=16, gf_dim=8, df_dim=8, z_dim=8,
                          compute_dtype="float32"),
        batch_size=4, checkpoint_dir=str(tmp_path / "run"),
        sample_dir=str(tmp_path / "samples"), sample_every_steps=0,
        tensorboard=False, activation_summary_steps=0, **kw)


@pytest.mark.parametrize("kw", [
    {"n_critic": 2, "grad_accum": 2, "diffaug": "color,cutout",
     "loss": "wgan-gp"},
    {"r1_gamma": 10.0, "r1_interval": 3, "diffaug": "translation"}])
def test_runner_equals_eager_steps(tmp_path, kw):
    """The trainer's runner path (static state, K = 2 slots of images, z
    and draws, one call per 2 steps; lazy R1 by the host's pattern rows)
    over 6 steps equals 6 eager steps on the trainer's inputs, bit for
    bit."""
    cfg = _cfg(tmp_path, steps_per_call=2, **kw)
    fns = steps.make_train_step(cfg)
    dev = torch.device("cpu")
    feed = trainer._synthetic_feed(cfg, dev)
    batches = [next(feed) for _ in range(6)]
    inputs = [trainer.step_inputs(cfg, s, dev) for s in range(6)]
    state = fns.init(seed=0, device="cpu")
    eager = []
    for s in range(6):
        state, m = fns.train_step(state, batches[s], *inputs[s])
        eager.append([float(m[k]) for k in metric_keys(cfg)])
    runner = StepRunner(fns, fns.init(seed=0, device="cpu"), cfg, dev)
    got = runner.step(batches[:1], [inputs[0][0]], [inputs[0][1]],
                      start=0).tolist()
    got += runner.step(batches[1:2], [inputs[1][0]], [inputs[1][1]],
                       start=1).tolist()
    for s in (2, 4):
        got += runner.step(batches[s:s + 2],
                           [inputs[s][0], inputs[s + 1][0]],
                           [inputs[s][1], inputs[s + 1][1]],
                           start=s).tolist()
    assert got == eager
    from dcgan_tpu_torch import convert

    for path, t in convert.flatten(state).items():
        assert torch.equal(convert.flatten(runner.state)[path], t), path
    if kw.get("r1_interval"):
        # steps 0 and 3 run R1
        assert [r[-1] > 0 for r in got] == [True, False, False, True,
                                             False, False]
        assert sorted(runner.programs) == [
            "multi_step@k2/r1=00", "multi_step@k2/r1=01", "train_step/r1=0"]


def test_lazy_r1_plan_rows():
    """One program per pattern of penalty and plain steps a run meets;
    the JAX plan's names otherwise."""
    cfg = TrainConfig(r1_gamma=1.0, r1_interval=4, steps_per_call=2,
                      activation_summary_steps=0)
    assert r1_patterns(cfg, 2) == [(False, False), (True, False)]
    assert build_warmup_plan(cfg, sample=True) == [
        "train_step/r1=0", "train_step/r1=1", "multi_step@k2/r1=00",
        "multi_step@k2/r1=10", "sampler"]
    cfg = TrainConfig(r1_gamma=1.0, r1_interval=2, steps_per_call=4,
                      activation_summary_steps=0)
    assert r1_patterns(cfg, 4) == [(True, False, True, False)]
    # without lazy R1 the rows keep the JAX plan's names
    # (tests/test_torch_warmup.py pins them against the JAX plan)
    plain = TrainConfig(loss="wgan-gp", n_critic=2, steps_per_call=2,
                        activation_summary_steps=0)
    assert build_warmup_plan(plain, sample=True) == [
        "train_step", "multi_step@k2", "sampler"]


def test_cli_trains_the_new_step_bodies(tmp_path):
    """`python -m dcgan_tpu_torch.train`'s entry point on the CPU with the
    new flags, on the fused route: the steps' losses in events.jsonl."""
    run = str(tmp_path / "run")
    state = cli.main([
        "--preset", "celeba64", "--synthetic", "--max_steps", "2",
        "--device", "cpu", "--output_size", "16", "--gf_dim", "8",
        "--df_dim", "8", "--z_dim", "8", "--batch_size", "4",
        "--use_pallas", "--pallas_fused", "--n_critic", "2",
        "--grad_accum", "2", "--diffaug", "color,translation,cutout",
        "--precision", "bf16", "--activation_summary_steps", "0",
        "--checkpoint_dir", run])
    assert int(state["step"]) == 2
    assert int(state["opt"]["disc"]["count"]) == 4
    assert state["params"]["gen"]["proj"]["w"].dtype == torch.bfloat16
    with open(os.path.join(run, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    scalars = [e for e in events if e["kind"] == "scalars"]
    assert all(np.isfinite(e["values"]["d_loss"]) for e in scalars
               if "d_loss" in e["values"])
    logged = {k: v for e in scalars for k, v in e["values"].items()}
    n_params = sum(len(steps.tree_leaves(state["params"][net]))
                   for net in ("gen", "disc"))
    assert logged["perf/precision/policy"] == 1.0
    assert logged["perf/precision/master_f32_leaves"] == n_params
