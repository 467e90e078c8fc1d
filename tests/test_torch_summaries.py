"""The loss probe (`eval_losses`) and the activation summaries
(`summarize`, `activation_stats`, `MetricWriter.write_activations`) of the
port against `dcgan_tpu`'s on the CPU, and both through the trainer.

Both packages read the same state (the JAX init, carried over), images
and z (the JAX functions draw theirs from a key; the test recomputes them):
- eval_losses: the losses and the penalty metric within 1e-5 (f32),
  WGAN-GP's interpolation on JAX's fixed key(0) weights, R1 unscaled by
  the interval;
- summarize: the same layer names, counts exact; min, max, mean and std
  within 1e-5 of the layer's range; zero fractions within one element;
  the 30 bin edges within 1e-5 of the range and the counts' sum exact,
  each count within 1 (a value within f32 noise of an edge may fall on
  either side);
- the event JSON: the port's writer and the JAX writer turn the same stats
  into the same "activations" event.
"""

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
from dcgan_tpu.train import steps as jsteps
from dcgan_tpu.utils.metrics import MetricWriter as JMetricWriter
from dcgan_tpu_torch import convert
from dcgan_tpu_torch.config import ModelConfig, TrainConfig
from dcgan_tpu_torch.train import cli, steps
from dcgan_tpu_torch.utils.metrics import MetricWriter, activation_stats
from torch_jax_draws import one_torch_thread  # noqa: F401

MODEL = dict(output_size=16, gf_dim=8, df_dim=8, z_dim=8,
             compute_dtype="float32")
BATCH = 4


def _both(kw, route):
    mk = dict(MODEL, **D.ROUTES[route])
    jcfg = JTrainConfig(model=JModelConfig(**mk), batch_size=BATCH, **kw)
    tcfg = TrainConfig(model=ModelConfig(**mk), batch_size=BATCH, **kw)
    jfns = jsteps.make_train_step(jcfg)
    jstate = jax.jit(jfns.init)(jax.random.key(0))
    tstate = convert.train_state_from_jax(jax.device_get(jstate),
                                          device="cpu")
    images = np.tanh(np.random.default_rng(1).normal(
        size=(BATCH, 16, 16, 3))).astype(np.float32)
    return jfns, jstate, steps.make_train_step(tcfg), tstate, images


@pytest.mark.parametrize("kw,route", [
    ({}, "plain"), ({}, "fused"), ({"loss": "wgan-gp"}, "plain"),
    ({"r1_gamma": 10.0, "r1_interval": 4, "diffaug": "color"}, "plain")])
def test_eval_losses_match_jax(kw, route):
    jfns, jstate, tfns, tstate, images = _both(kw, route)
    z = D.uniform(jax.random.key(3), (BATCH, 8), -1.0, 1.0)
    want = jax.jit(jfns.eval_losses)(jstate, jnp.asarray(images),
                                     jnp.asarray(z))
    eps = D.uniform(jax.random.key(0), (BATCH, 1, 1, 1)).reshape(-1)
    got = tfns.eval_losses(tstate, torch.from_numpy(images),
                           torch.from_numpy(z.copy()),
                           torch.from_numpy(eps.copy()))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert abs(float(got[k]) - float(v)) <= 1e-5, (k, got[k], v)
    # the port's own fixed weights (a generator seeded 0): the same keys,
    # finite; no state changes
    again = tfns.eval_losses(tstate, torch.from_numpy(images),
                             torch.from_numpy(z.copy()))
    assert all(np.isfinite(float(v)) for v in again.values())
    if "r1_gamma" in kw:
        assert float(got["r1"]) > 0   # every call, whatever the step


def _compare_stats(got, want):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = {k: (v.numpy() if isinstance(v, torch.Tensor) else
                 np.asarray(v)) for k, v in got[name].items()}
        w = {k: np.asarray(v) for k, v in w.items()}
        span = float(w["max"] - w["min"]) or 1.0
        assert int(g["count"]) == int(w["count"]), name
        for k in ("min", "max", "mean", "std"):
            assert abs(float(g[k]) - float(w[k])) <= 1e-5 * max(
                span, abs(float(w[k]))), (name, k, g[k], w[k])
        assert abs(float(g["zero_fraction"]) - float(w["zero_fraction"])) \
            <= 1.0 / int(w["count"]) + 1e-7, name
        np.testing.assert_allclose(g["bin_edges"], w["bin_edges"],
                                   rtol=0, atol=1e-5 * span)
        assert g["bin_counts"].sum() == w["bin_counts"].sum(), name
        assert np.abs(g["bin_counts"] - w["bin_counts"]).max() <= 1, name


@pytest.mark.parametrize("route", ["plain", "fused"])
def test_summarize_matches_jax(route):
    jfns, jstate, tfns, tstate, images = _both({}, route)
    key = jax.random.key(4)
    want = jax.device_get(jax.jit(jfns.summarize)(
        jstate, jnp.asarray(images), key))
    z = D.uniform(key, (BATCH, 8), -1.0, 1.0)
    got = tfns.summarize(tstate, torch.from_numpy(images),
                         torch.from_numpy(z.copy()))
    assert "gen/h2" in got and "disc/logit" in got and "z" in got
    _compare_stats(got, want)


def test_activation_stats_edge_cases():
    """Exact zeros (a relu's output) and a constant tensor (JAX widens the
    range by 0.5 each way) against the JAX function. The constant sits on
    the middle edge itself, which XLA's CPU division rounds up one ulp:
    its 12 values fall in the bin on either side of that edge, so only
    the edges and the two middle bins' sum are held."""
    from dcgan_tpu.utils.metrics import activation_stats as j_stats

    acts = {"const": np.full((3, 4), 2.5, np.float32),
            "relu": np.maximum(np.random.default_rng(0).normal(
                size=(50,)), 0).astype(np.float32)}
    want = jax.device_get(j_stats({k: jnp.asarray(v)
                                   for k, v in acts.items()}))
    got = activation_stats({k: torch.from_numpy(v) for k, v in acts.items()})
    _compare_stats({"relu": got["relu"]}, {"relu": want["relu"]})
    g, w = got["const"], want["const"]
    np.testing.assert_allclose(g["bin_edges"].numpy(), w["bin_edges"],
                               rtol=0, atol=1e-6)
    assert float(g["bin_counts"][14:16].sum()) == 12.0
    assert float(np.asarray(w["bin_counts"])[14:16].sum()) == 12.0
    assert float(g["std"]) == 0.0 and float(g["zero_fraction"]) == 0.0


def test_write_activations_event_equals_jax(tmp_path):
    tfns = steps.make_train_step(TrainConfig(model=ModelConfig(**MODEL),
                                             batch_size=BATCH))
    state = tfns.init(seed=0, device="cpu")
    images = torch.rand((BATCH, 16, 16, 3)) * 2 - 1
    stats = tfns.summarize(state, images, torch.rand((BATCH, 8)) * 2 - 1)
    w = MetricWriter(str(tmp_path / "port"), tensorboard=True)
    w.write_activations(7, stats)
    w.close()
    jw = JMetricWriter(str(tmp_path / "jax"), tensorboard=False)
    jw.write_activations(7, {k: {f: (v.numpy() if isinstance(
        v, torch.Tensor) else v) for f, v in rec.items()}
        for k, rec in stats.items()})
    jw.close()
    ev = [json.loads(line) for line in
          (tmp_path / "port" / "events.jsonl").read_text().splitlines()]
    jev = [json.loads(line) for line in
           (tmp_path / "jax" / "events.jsonl").read_text().splitlines()]
    for e in ev + jev:
        e.pop("time")
    assert ev == jev and ev[0]["kind"] == "activations"
    assert any(p.name.startswith("events.out.tfevents.")
               and p.stat().st_size > 100
               for p in (tmp_path / "port").iterdir())


def test_trainer_writes_probe_and_summaries(tmp_path):
    """Two steps of the WGAN-GP preset through the CLI on the CPU with the
    probe and the summaries every step: sample/* scalars (the held-out
    synthetic stream) with the penalty's, and an activations event."""
    run = tmp_path / "run"
    cli.main(["--preset", "wgan-gp", "--synthetic", "--max_steps", "2",
              "--device", "cpu", "--output_size", "16", "--gf_dim", "8",
              "--df_dim", "8", "--z_dim", "8", "--batch_size", "4",
              "--n_critic", "2", "--sample_every_steps", "1",
              "--activation_summary_steps", "2",
              "--sample_dir", str(tmp_path / "samples"),
              "--checkpoint_dir", str(run)])
    with open(os.path.join(run, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    probes = [e for e in events if e["kind"] == "scalars"
              and "sample/d_loss" in e["values"]]
    assert [e["step"] for e in probes] == [1, 2]
    assert set(probes[0]["values"]) == {f"sample/{k}" for k in (
        "d_loss", "d_loss_real", "d_loss_fake", "g_loss", "gp")}
    acts = [e for e in events if e["kind"] == "activations"]
    assert [e["step"] for e in acts] == [2]
    assert "disc/logit" in acts[0]["values"]
    train_rows = [e for e in events if e["kind"] == "scalars"
                  and "d_loss" in e["values"]]
    assert all("gp" in e["values"] for e in train_rows)
