"""The trainer's FID/KID probe and best-checkpoint retention on the CPU
(`dcgan_tpu_torch/train/fid_probe.py`, `train/trainer.py`, the runner's
`fid_sampler` row), and the config fields that drive it, against the JAX
package's (`dcgan_tpu/config.py`, `dcgan_tpu/train/trainer.py:620-693,
1817-1934`), at 16 px (gf = df = 8, z 8, batch 4, 64 samples a probe):

- a synthetic run probing every 2 steps writes `eval/fid` and `eval/kid`,
  keeps its best-scoring step in `<checkpoint_dir>/best` with config.json
  and score.json, and `generate --checkpoint_dir <dir>/best` loads it;
  the score is compute_fid's on that state against the first batches of
  the held-out stream, by hand;
- a resumed run reads the best score back: a worse probe does not replace
  the best step; the held-out stream is fast-forwarded past what the run
  before it consumed (`held_out_skip`, the JAX trainer's count);
- a conditional run's real side drops the held-out labels;
- the probe without a held-out stream fails with the JAX message, before
  anything is written;
- `fid_every_steps` and `fid_num_samples` round-trip through config.json,
  a JAX config.json with the probe on loads with it on, and their checks
  and the cadence rule give the JAX package's errors.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from dcgan_tpu import config as j_config
from dcgan_tpu_torch import config
from dcgan_tpu_torch import generate as gen
from dcgan_tpu_torch.config import ModelConfig, TrainConfig
from dcgan_tpu_torch.evals.features import make_random_feature_fn
from dcgan_tpu_torch.evals.job import compute_fid
from dcgan_tpu_torch.models.dcgan import sampler_apply
from dcgan_tpu_torch.train import cli, steps, trainer
from dcgan_tpu_torch.train.fid_probe import held_out_skip
from dcgan_tpu_torch.train.steps import init_train_state
from dcgan_tpu_torch.train.warmup import FID_ROW, StepRunner, \
    build_warmup_plan
from dcgan_tpu_torch.utils.checkpoint import Checkpointer
from torch_jax_draws import one_torch_thread  # noqa: F401


MODEL = dict(output_size=16, gf_dim=8, df_dim=8, z_dim=8,
             compute_dtype="float32")


def _cfg(root, **kw):
    model_kw = kw.pop("model_kw", {})
    kw = dict(dict(fid_every_steps=2, fid_num_samples=64), **kw)
    return TrainConfig(model=ModelConfig(**MODEL, **model_kw), batch_size=4,
                       checkpoint_dir=str(root), sample_every_steps=0,
                       sample_dir=str(root / "samples"),
                       save_summaries_secs=1e9, save_model_secs=1e9,
                       tensorboard=False, **kw)


def _fid_events(run):
    with open(os.path.join(run, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    return {e["step"]: e["values"] for e in events
            if e["kind"] == "scalars" and "eval/fid" in e["values"]}


def _best(run):
    with open(os.path.join(run, "best", "score.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def probed_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("probe") / "run"
    cfg = _cfg(root)
    trainer.train(cfg, synthetic_data=True, max_steps=4, device="cpu")
    return cfg


class TestProbe:
    def test_scalars_and_best_checkpoint(self, probed_run, tmp_path):
        run = probed_run.checkpoint_dir
        fids = _fid_events(run)
        assert sorted(fids) == [2, 4]
        assert all(np.isfinite(v["eval/fid"]) and np.isfinite(v["eval/kid"])
                   for v in fids.values())
        best = _best(run)
        step = min(fids, key=lambda s: fids[s]["eval/fid"])
        assert best == {"fid": fids[step]["eval/fid"], "step": step}
        best_dir = os.path.join(run, "best")
        assert Checkpointer(best_dir).latest_step() == step
        assert config.load_config(best_dir) == probed_run
        out = gen.main(["--checkpoint_dir", best_dir, "--num_images", "4",
                        "--grid", "0", "--npz", str(tmp_path / "b.npz"),
                        "--device", "cpu"])
        assert out["step"] == step

    def test_score_is_compute_fid_of_the_best_state(self, probed_run):
        """The probe's number by hand: the best state's sampler, the port's
        tower, the first 16 held-out batches as the real side, the probe's
        KID settings."""
        cfg = probed_run
        best_dir = os.path.join(cfg.checkpoint_dir, "best")
        state = Checkpointer(best_dir).restore_latest(
            init_train_state(cfg, device="cpu"))
        held_out = trainer.make_sample_data(cfg, torch.device("cpu"),
                                            synthetic_data=True)
        feature_fn, dim = make_random_feature_fn(16, 3, device="cpu")
        result = compute_fid(
            lambda z: sampler_apply(state["params"]["gen"],
                                    state["bn"]["gen"], z, cfg=cfg.model),
            held_out, image_size=16, z_dim=8, num_samples=64, batch_size=4,
            seed=cfg.seed, feature_fn=feature_fn, feature_dim=dim, kid=True,
            kid_subset_size=16, kid_subsets=20, kid_pool_size=64,
            device="cpu")
        assert result["fid"] == _best(cfg.checkpoint_dir)["fid"]

    def test_resume_keeps_a_better_best(self, probed_run, tmp_path):
        run = tmp_path / "run"
        shutil.copytree(probed_run.checkpoint_dir, run)
        kept = dict(_best(run), fid=1e-12)      # no probe can beat it
        (run / "best" / "score.json").write_text(json.dumps(kept))
        before = sorted(os.listdir(run / "best"))
        trainer.train(dataclasses.replace(probed_run,
                                          checkpoint_dir=str(run)),
                      synthetic_data=True, max_steps=6, device="cpu")
        assert sorted(_fid_events(run)) == [2, 4, 6]
        assert _best(run) == kept
        assert sorted(os.listdir(run / "best")) == before

    def test_conditional_real_side_drops_labels(self, tmp_path):
        cfg = _cfg(tmp_path / "run", model_kw={"num_classes": 3},
                   fid_every_steps=1)
        trainer.train(cfg, synthetic_data=True, max_steps=1, device="cpu")
        assert np.isfinite(_fid_events(cfg.checkpoint_dir)[1]["eval/fid"])
        assert _best(cfg.checkpoint_dir)["step"] == 1

    def test_needs_a_held_out_stream(self, tmp_path):
        cfg = _cfg(tmp_path / "run",
                   sample_image_dir=str(tmp_path / "absent"))
        with pytest.raises(ValueError, match="fid_every_steps needs a "
                           "held-out stream: provide sample_image_dir"):
            trainer.train(cfg, synthetic_data=False, device="cpu")
        assert not os.path.exists(cfg.checkpoint_dir)


class TestHeldOutStream:
    def test_skip_counts_the_jax_way(self):
        cfg = TrainConfig(batch_size=64, sample_every_steps=100,
                          fid_every_steps=500, fid_num_samples=2048)
        assert held_out_skip(cfg, 0) == 0
        assert held_out_skip(cfg, 499) == 4
        assert held_out_skip(cfg, 500) == 5 + 32
        assert held_out_skip(dataclasses.replace(
            cfg, fid_num_samples=2050), 1000) == 10 + 33
        assert held_out_skip(dataclasses.replace(
            cfg, fid_every_steps=0), 1000) == 10

    def test_skipped_stream_continues_where_it_stopped(self):
        cfg = TrainConfig(model=ModelConfig(**MODEL), batch_size=4)
        cpu = torch.device("cpu")
        whole = trainer.make_sample_data(cfg, cpu, synthetic_data=True)
        batches = [next(whole) for _ in range(4)]
        skipped = trainer.make_sample_data(cfg, cpu, synthetic_data=True,
                                           skip_batches=3)
        torch.testing.assert_close(next(skipped), batches[3], rtol=0,
                                   atol=0)


class TestRunnerRow:
    def test_fid_sampler_row(self):
        cfg = TrainConfig(model=ModelConfig(**MODEL), batch_size=4,
                          fid_every_steps=2)
        assert build_warmup_plan(cfg, sample=False)[-1] == FID_ROW
        assert FID_ROW not in build_warmup_plan(
            dataclasses.replace(cfg, fid_every_steps=0), sample=False)
        fns = steps.make_train_step(cfg)
        cpu = torch.device("cpu")
        runner = StepRunner(fns, fns.init(seed=0, device=cpu), cfg, cpu)
        images = torch.tanh(torch.randn(4, 16, 16, 3))
        runner.step([images], [torch.rand(4, 8) * 2 - 1])
        z = torch.rand(4, 8) * 2 - 1
        torch.testing.assert_close(runner.fid_sample(z),
                                   fns.sample(runner.state, z),
                                   rtol=0, atol=0)
        runner.close()


class TestConfig:
    def test_round_trip_and_jax_config(self, tmp_path, capsys):
        cfg = TrainConfig(fid_every_steps=5, fid_num_samples=128)
        config.save_config(cfg, str(tmp_path / "port"))
        assert config.load_config(str(tmp_path / "port")) == cfg
        jcfg = j_config.TrainConfig(fid_every_steps=7, fid_num_samples=96)
        j_config.save_config(jcfg, str(tmp_path / "jax"))
        loaded = config.load_config(str(tmp_path / "jax"))
        assert (loaded.fid_every_steps, loaded.fid_num_samples) == (7, 96)
        assert "fid_" not in capsys.readouterr().err

    @pytest.mark.parametrize("kw", [
        {"fid_every_steps": -1},
        {"fid_every_steps": 10, "fid_num_samples": 32},
        {"fid_every_steps": 6, "steps_per_call": 4},
    ], ids=["negative", "few_samples", "cadence"])
    def test_checks_match_jax(self, kw):
        msgs = []
        for cls in (j_config.TrainConfig, TrainConfig):
            with pytest.raises(ValueError) as e:
                cls(**kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
        # a cadence that divides steps_per_call or is a multiple passes
        TrainConfig(fid_every_steps=8, steps_per_call=4)

    def test_progressive_with_the_probe_refused(self):
        d = config.config_to_dict(TrainConfig(fid_every_steps=5))
        with pytest.raises(ValueError, match="does not compose with "
                           "fid_every_steps"):
            config.config_from_dict(dict(d, progressive="64:100,128:100"))

    def test_cli_flags(self):
        cfg = cli.config_from_args(cli.build_parser().parse_args(
            ["--fid_every_steps", "3", "--fid_num_samples", "96"]))
        assert (cfg.fid_every_steps, cfg.fid_num_samples) == (3, 96)
        default = cli.config_from_args(cli.build_parser().parse_args([]))
        assert (default.fid_every_steps, default.fid_num_samples) == \
            (0, 2048)
