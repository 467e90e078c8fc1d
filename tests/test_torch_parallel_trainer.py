"""The port's trainer in a data-parallel world on the CPU (gf = df = 8,
16 px, global batch 8): 2 ranks over gloo, each spawned by
`dcgan_tpu_torch/testing/multihost.py::run_world` and running the
trainer CLI (tests/torch_dp_worker.py::cli_train) on the synthetic feed.

- Only the chief writes: one events.jsonl row per step, one TensorBoard
  file, one sample grid per cadence step, the checkpoints; both ranks end
  on the same state, bit for bit.
- The world-2 checkpoint resumes at world 1 (the port's trainer in this
  process) and loads in the JAX package
  (`tools/export_torch_checkpoint.py::port_to_jax_state`), equal leaf for
  leaf.
- `--pipeline_gd` at world 2, on the shard_map draws.
- The refusals by name: at world size > 1 `--fid_every_steps` (Queue A
  item 7) and `--nan_policy rollback` (item 9b); the live-elastic flags
  (item 10); the mesh settings the port does not run (item 7).
"""

import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from dcgan_tpu_torch import convert
from dcgan_tpu_torch.config import ModelConfig, TrainConfig
from dcgan_tpu_torch.parallel.distributed import World
from dcgan_tpu_torch.testing.multihost import run_world
from dcgan_tpu_torch.train import cli, trainer
from torch_jax_draws import export_tool, one_torch_thread  # noqa: F401

TESTS = os.path.dirname(os.path.abspath(__file__))
SMALL = ["--device", "cpu", "--output_size", "16", "--gf_dim", "8",
         "--df_dim", "8", "--z_dim", "8", "--batch_size", "8",
         "--synthetic", "--num_loader_threads", "1", "--no_tensorboard"]
WORLD_TIMEOUT = 240.0


def _argv(tmp_path, steps, *extra):
    return [*SMALL, "--checkpoint_dir", str(tmp_path / "run"),
            "--sample_dir", str(tmp_path / "samples"), "--max_steps",
            str(steps), "--save_model_secs", "0", "--sample_every_steps",
            "2", "--activation_summary_steps", "2", "--mesh_data", "2",
            *extra]


def _events(run):
    with open(os.path.join(run, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def _ranks_equal(outs):
    for path, v in outs[0]["state"].items():
        assert np.array_equal(outs[1]["state"][path], v), path


@pytest.fixture(scope="module")
def world_run(tmp_path_factory):
    """A 2-rank run of 2 steps (checkpoint after every step, a grid and
    the activation summary at step 2)."""
    tmp = tmp_path_factory.mktemp("dp_trainer")
    argv = _argv(tmp, 2, "--tensorboard")
    argv.remove("--no_tensorboard")
    argv.remove("--tensorboard")
    outs = run_world("torch_dp_worker:cli_train", 2,
                     kwargs={"argv": argv}, paths=[TESTS],
                     timeout=WORLD_TIMEOUT)
    return tmp, outs


def test_only_the_chief_writes(world_run):
    tmp, outs = world_run
    _ranks_equal(outs)
    run = str(tmp / "run")
    rows = [e for e in _events(run) if e["kind"] == "scalars"
            and "d_loss" in e.get("values", {})]
    assert [e["step"] for e in rows] == [1, 2]
    acts = [e for e in _events(run) if e["kind"] == "activations"]
    assert [e["step"] for e in acts] == [2]
    assert len(glob.glob(os.path.join(run, "events.out.tfevents.*"))) == 1
    assert sorted(os.listdir(tmp / "samples")) == ["train_00000002.png"]
    assert not glob.glob(os.path.join(run, "flight_recorder*"))
    from dcgan_tpu_torch.utils.checkpoint import Checkpointer
    assert Checkpointer(run).latest_step() == 2
    # the chief's config.json: the mesh the run was given
    with open(os.path.join(run, "config.json")) as f:
        assert json.load(f)["mesh"]["data"] == 2


def test_world_checkpoint_resumes_at_world_one_and_in_jax(world_run):
    from dcgan_tpu.config import ModelConfig as JModelConfig
    from dcgan_tpu.config import TrainConfig as JTrainConfig
    from dcgan_tpu.train import steps as jsteps
    from dcgan_tpu_torch.train.steps import init_train_state
    from dcgan_tpu_torch.utils.checkpoint import Checkpointer

    tmp, outs = world_run
    run = str(tmp / "run")
    mk = dict(output_size=16, gf_dim=8, df_dim=8, z_dim=8)
    restored = Checkpointer(run).restore_latest(init_train_state(
        TrainConfig(model=ModelConfig(**mk), batch_size=8), device="cpu"))
    flat = {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
            for k, v in convert.flatten(restored).items()}
    assert sorted(flat) == sorted(outs[0]["state"])
    for path, v in outs[0]["state"].items():
        assert np.array_equal(flat[path], v), path
    # in the JAX package: the same leaves, bit for bit
    jcfg = JTrainConfig(model=JModelConfig(**mk), batch_size=8)
    template = jax.device_get(jax.jit(jsteps.make_train_step(jcfg).init)(
        jax.random.key(0)))
    jstate = export_tool().port_to_jax_state(run, template)
    back = convert.flatten(convert.train_state_from_jax(jstate,
                                                        device="cpu"))
    for path, v in convert.flatten(restored).items():
        assert torch.equal(back[path], v), path
    # and the port resumes it at world size 1: steps 3 and 4 appended
    state = cli.main(_argv(tmp, 4)[:-2] + ["--mesh_data", "-1"])
    assert int(state["step"]) == 4
    rows = [e["step"] for e in _events(run) if e["kind"] == "scalars"
            and "d_loss" in e.get("values", {})]
    assert rows == [1, 2, 3, 4]


def test_pipeline_gd_at_world_two(tmp_path):
    outs = run_world("torch_dp_worker:cli_train", 2, kwargs={
        "argv": _argv(tmp_path, 3, "--pipeline_gd", "--backend",
                      "shard_map")}, paths=[TESTS], timeout=WORLD_TIMEOUT)
    _ranks_equal(outs)
    assert int(outs[0]["state"]["step"]) == 3
    assert all(np.isfinite(v).all() for v in outs[0]["state"].values())
    rows = [e for e in _events(str(tmp_path / "run"))
            if e["kind"] == "scalars" and "d_loss" in e.get("values", {})]
    assert [e["step"] for e in rows] == [1, 2, 3]


@pytest.mark.parametrize("kw,item", [
    ({"fid_every_steps": 10}, "Queue A item 7"),
    ({"nan_policy": "rollback"}, "Queue A item 9b")])
def test_world_refusals_name_their_item(kw, item):
    two = World(rank=0, size=2, local_rank=0, device=torch.device("cpu"))
    cfg = TrainConfig(model=ModelConfig(output_size=16), batch_size=8, **kw)
    trainer.check_world(cfg, dataclasses_replace(two, size=1))
    with pytest.raises(NotImplementedError, match=item):
        trainer.check_world(cfg, two)


def dataclasses_replace(world, **kw):
    import dataclasses

    return dataclasses.replace(world, **kw)


@pytest.mark.parametrize("flags,item", [
    (["--elastic_target_devices", "4"], "Queue A item 10"),
    (["--elastic_notice_file", "notice"], "Queue A item 10"),
    (["--zero_stage", "2"], "Queue A item 7"),
    (["--mesh_shard_opt"], "Queue A item 7"),
    (["--mesh_model", "2"], "Queue A item 7"),
    (["--comm_overlap", "bucket"], "Queue A item 7")])
def test_cli_refusals_name_their_item(flags, item):
    with pytest.raises(NotImplementedError, match=item):
        cli.config_from_args(cli.build_parser().parse_args(flags))


def test_mesh_flags_equal_the_jax_cli():
    """--mesh_data, --backend and --comm_bucket_mb give the JAX CLI's
    TrainConfig values."""
    from dcgan_tpu.train import cli as jcli
    from dcgan_tpu import presets as jpresets

    argv = ["--preset", "celeba64", "--mesh_data", "4", "--backend",
            "shard_map", "--comm_bucket_mb", "8"]
    want = jcli.apply_overrides(jpresets.get_preset("celeba64"),
                                jcli.explicit_flags(argv))
    got = cli.config_from_args(cli.build_parser().parse_args(argv))
    assert got.mesh == want.mesh and want.mesh == got.mesh
    assert (got.backend, got.comm_bucket_mb) == (want.backend,
                                                 want.comm_bucket_mb)
