"""The conditional model's probe and summaries against `dcgan_tpu`'s on
the CPU, and the captured runner's label slots, the labelled feed and the
trainer (K = 4 classes, or cifar10-cond's 10, at 16-32 px, gf = df = 8,
batch 4).

Both packages start from one state in the JAX init's tree, its weights
numpy draws from a seed (`torch_jax_draws.numpy_init`, carried over), on
the same numpy images and labels; JAX jitted. Tolerances: the probe's losses 1e-5 (f32,
summation order only); the summaries tests/test_torch_summaries.py's
rule; the runner against eager steps bit for bit.
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_jax_draws as D

from dcgan_tpu_torch import convert
from dcgan_tpu_torch.config import ModelConfig, TrainConfig
from dcgan_tpu_torch.train import cli, steps, trainer
from dcgan_tpu_torch.train.warmup import StepRunner, metric_keys

K = 4
COND = dict(num_classes=K)
CBN = dict(num_classes=K, conditional_bn=True)


def _both(kw, model_kw):
    from dcgan_tpu.config import ModelConfig as JModelConfig
    from dcgan_tpu.config import TrainConfig as JTrainConfig
    from dcgan_tpu.train import steps as jsteps

    mk = dict(output_size=16, gf_dim=8, df_dim=8, z_dim=8,
              compute_dtype="float32", **model_kw)
    jfns = jsteps.make_train_step(JTrainConfig(model=JModelConfig(**mk),
                                               batch_size=4, **kw))
    jstate = D.numpy_init(jfns.init)
    tfns = steps.make_train_step(TrainConfig(model=ModelConfig(**mk),
                                             batch_size=4, **kw))
    tstate = convert.train_state_from_jax(jax.device_get(jstate),
                                          device="cpu")
    rng = np.random.default_rng(2)
    images = np.tanh(rng.normal(size=(4, 16, 16, 3))).astype(np.float32)
    labels = rng.permutation(np.arange(4) % K).astype(np.int32)
    return jfns, jstate, tfns, tstate, images, labels


@pytest.mark.parametrize("kw", [{}, {"loss": "wgan-gp"}])
def test_eval_losses_match_jax(kw):
    jfns, jstate, tfns, tstate, images, labels = _both(kw, CBN)
    z = D.uniform(jax.random.key(3), (4, 8), -1.0, 1.0)
    want = jax.jit(jfns.eval_losses)(jstate, jnp.asarray(images),
                                     jnp.asarray(z), jnp.asarray(labels))
    eps = D.uniform(jax.random.key(0), (4, 1, 1, 1)).reshape(-1)
    got = tfns.eval_losses(tstate, torch.from_numpy(images),
                           torch.from_numpy(z.copy()),
                           torch.from_numpy(eps.copy()),
                           labels=torch.from_numpy(labels))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert abs(float(got[k]) - float(v)) <= 1e-5, (k, got[k], v)


def test_summarize_matches_jax():
    """The summaries with labels: the layer names and counts exact, the
    statistics tests/test_torch_summaries.py's rule."""
    from test_torch_summaries import _compare_stats

    jfns, jstate, tfns, tstate, images, labels = _both({}, COND)
    key = jax.random.key(4)
    want = jax.device_get(jax.jit(jfns.summarize)(
        jstate, jnp.asarray(images), key, jnp.asarray(labels)))
    z = D.uniform(key, (4, 8), -1.0, 1.0)
    got = tfns.summarize(tstate, torch.from_numpy(images),
                         torch.from_numpy(z.copy()),
                         torch.from_numpy(labels))
    _compare_stats(got, want)


def _cfg(tmp_path, **kw):
    return TrainConfig(
        model=ModelConfig(output_size=16, gf_dim=8, df_dim=8, z_dim=8,
                          compute_dtype="float32", **CBN),
        batch_size=4, checkpoint_dir=str(tmp_path / "run"),
        sample_dir=str(tmp_path / "samples"), sample_every_steps=0,
        tensorboard=False, activation_summary_steps=0, **kw)


def test_runner_label_slots_equal_eager(tmp_path):
    """The runner's path (K = 2 slots of images, z, draws and labels, one
    call per 2 steps) over 4 steps equals 4 eager steps on the trainer's
    labelled synthetic feed, bit for bit; its sampler row reads the grid's
    labels; a conditional runner refuses a call without labels."""
    cfg = _cfg(tmp_path, steps_per_call=2, n_critic=2, diffaug="color")
    fns = steps.make_train_step(cfg)
    dev = torch.device("cpu")
    feed = trainer._synthetic_feed(cfg, dev)
    batches = [trainer.split_batch(cfg, next(feed)) for _ in range(4)]
    assert batches[0][1].dtype == torch.int32
    inputs = [trainer.step_inputs(cfg, s, dev) for s in range(4)]
    state = fns.init(seed=0, device="cpu")
    eager = []
    for s in range(4):
        state, m = fns.train_step(state, batches[s][0], *inputs[s],
                                  batches[s][1])
        eager.append([float(m[k]) for k in metric_keys(cfg)])
    z = torch.rand(8, 8) * 2 - 1
    grid = trainer.grid_labels(8, K, dev)
    assert grid.tolist() == [0, 1, 2, 3, 0, 1, 2, 3]
    runner = StepRunner(fns, fns.init(seed=0, device="cpu"), cfg, dev,
                        sample_z=z, sample_labels=grid)
    with pytest.raises(ValueError, match="label batch per step"):
        runner.step([batches[0][0]], [inputs[0][0]], [inputs[0][1]])
    got = runner.step([batches[0][0]], [inputs[0][0]], [inputs[0][1]],
                      start=0, labels=[batches[0][1]]).tolist()
    got += runner.step([batches[1][0]], [inputs[1][0]], [inputs[1][1]],
                       start=1, labels=[batches[1][1]]).tolist()
    got += runner.step([b[0] for b in batches[2:]],
                       [i[0] for i in inputs[2:]],
                       [i[1] for i in inputs[2:]], start=2,
                       labels=[b[1] for b in batches[2:]]).tolist()
    assert got == eager
    for path, t in convert.flatten(state).items():
        assert torch.equal(convert.flatten(runner.state)[path], t), path
    assert torch.equal(runner.sample(),
                       fns.sample(runner.state, z, grid))


def _cifar(root, n=8):
    rng = np.random.default_rng(1)
    os.makedirs(root, exist_ok=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)]:
        with open(os.path.join(root, name), "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072),
                                               dtype=np.uint8),
                         b"labels": list(rng.integers(0, 10, n))}, f)
    return str(root)


def test_trainer_on_prepared_cifar_shards(tmp_path):
    """`prepare --cifar10` shards through `python -m
    dcgan_tpu_torch.train --preset cifar10-cond` on the CPU (the native
    labelled loader, a sample grid, the probe on held-out shards and the
    summaries with labels), then a resume; the labels reach the step."""
    from dcgan_tpu_torch.data import prepare

    shards = str(tmp_path / "shards")
    prepare.main(["--cifar10", "--input_dir", _cifar(tmp_path / "c"),
                  "--output_dir", shards, "--num_shards", "2"])
    run = str(tmp_path / "run")
    argv = ["--preset", "cifar10-cond", "--data_dir", shards,
            "--sample_image_dir", shards, "--device", "cpu", "--gf_dim",
            "8", "--df_dim", "8", "--z_dim", "8", "--batch_size", "4",
            "--shuffle_buffer", "8", "--num_loader_threads", "2",
            "--sample_every_steps", "2", "--activation_summary_steps", "2",
            "--checkpoint_dir", run, "--sample_dir",
            str(tmp_path / "samples"), "--conditional_bn", "--use_pallas"]
    seen = []
    original = steps.make_train_step

    def spy(cfg):
        fns = original(cfg)

        def train_step(state, images, z, draws=None, labels=None, **kw):
            seen.append(labels)
            return fns.train_step(state, images, z, draws, labels, **kw)
        return steps.TrainStepFns(**{**fns.__dict__,
                                     "train_step": train_step})
    trainer.make_train_step = spy
    try:
        state = cli.main(argv + ["--max_steps", "2"])
    finally:
        trainer.make_train_step = original
    assert state["params"]["gen"]["bn1"]["scale"].shape == (10, 16)
    assert all(t is not None and t.dtype == torch.int32
               and 0 <= int(t.min()) and int(t.max()) < 10 for t in seen)
    with open(os.path.join(run, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    kinds = {e["kind"] for e in events}
    assert {"scalars", "image", "activations"} <= kinds
    assert any("sample/d_loss" in e["values"] for e in events
               if e["kind"] == "scalars")
    again = cli.main(argv + ["--max_steps", "3"])
    assert int(again["step"]) == 3
    with open(os.path.join(run, "config.json")) as f:
        saved = json.load(f)
    assert saved["model"]["num_classes"] == 10
    assert saved["label_feature"] == "label"


def test_feed_checks_label_range():
    """A labelled host batch with a label >= num_classes fails in the
    feed, with the JAX package's message, before it reaches the card."""
    from dcgan_tpu.data.pipeline import _check_labels as j_check
    from dcgan_tpu_torch.data.pipeline import DevicePrefetcher, \
        check_labels

    bad = (np.zeros((2, 4, 4, 3), np.float32), np.array([1, 5], np.int32))
    errors = []
    for fn in (j_check, check_labels):
        with pytest.raises(ValueError) as e:
            fn(bad, 5)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    pf = DevicePrefetcher(iter([bad]), "cpu", num_classes=5)
    with pytest.raises(ValueError, match="out of range"):
        next(pf)
    pf.close()
    ok = DevicePrefetcher(iter([bad]), "cpu", num_classes=6)
    images, labels = next(ok)
    ok.close()
    assert labels.tolist() == [1, 5]


def test_cli_flags():
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        ["--preset", "celeba64", "--num_classes", "5", "--conditional_bn",
         "--label_feature", "cls"]))
    assert cfg.model.num_classes == 5 and cfg.model.conditional_bn
    assert cfg.label_feature == "cls"
    preset = cli.config_from_args(cli.build_parser().parse_args(
        ["--preset", "cifar10-cond"]))
    assert preset.model.num_classes == 10 and not preset.model.conditional_bn
