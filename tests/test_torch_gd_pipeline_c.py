"""Continued from test_torch_gd_pipeline.py: Pipelined G/D dispatch
(`pipeline_gd`) in the port against `dcgan_tpu`'s on the CPU."""

import dataclasses
import os

import numpy as np
import torch

from dcgan_tpu.config import ModelConfig as JModelConfig
from dcgan_tpu.config import TrainConfig as JTrainConfig
from dcgan_tpu.config import save_config as j_save_config
from dcgan_tpu_torch.config import ModelConfig, load_config
from dcgan_tpu_torch.train import steps, trainer
from dcgan_tpu_torch.train.gd_pipeline import GDPipeline
from dcgan_tpu_torch.train.warmup import StepRunner
from dcgan_tpu_torch.utils.checkpoint import Checkpointer
from torch_jax_draws import one_torch_thread  # noqa: F401
from test_torch_gd_pipeline import (  # noqa: F401
    BATCH, SIZE, _scalar_rows, _train_cfg)


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
