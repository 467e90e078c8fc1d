"""Units of the port's data parallelism (dcgan_tpu_torch/parallel/) on the
CPU: the world's discovery from the JAX function's arguments and from
torchrun's environment; every collective helper as the identity at world
size 1, bit for bit, with no group and with a gloo group of one; the
chief-only Checkpointer; the per-process flight-recorder names; the live
world in the progressive schedule's mesh check. The units that compare
with the JAX package (MeshConfig, the refusals, the layout checks) are in
tests/test_torch_parallel_dp.py."""

import dataclasses
import os
import socket

import numpy as np
import pytest
import torch

from dcgan_tpu_torch.config import ModelConfig, TrainConfig
from dcgan_tpu_torch.parallel import collectives, distributed
from dcgan_tpu_torch.parallel.api import rank_rows
from dcgan_tpu_torch.parallel.distributed import World, initialize_multihost
from torch_dp_worker import collectives_identity
from torch_jax_draws import one_torch_thread  # noqa: F401

TINY = dict(output_size=16, gf_dim=8, df_dim=8, z_dim=8,
            compute_dtype="float32")
WORLD_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
             "MASTER_PORT", "JAX_COORDINATOR_ADDRESS")


@pytest.fixture
def no_world_env(monkeypatch):
    for name in WORLD_ENV:
        monkeypatch.delenv(name, raising=False)
    yield
    distributed.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------

def test_no_world_named_is_one_process(no_world_env):
    w = initialize_multihost(device="cpu")
    assert (w.rank, w.size, w.group, w.backend, w.is_chief) == \
        (0, 1, None, "", True)
    assert w.device == torch.device("cpu")
    assert (distributed.process_index(), distributed.process_count(),
            distributed.is_chief()) == (0, 1, True)
    with pytest.raises(ValueError, match="process count"):
        initialize_multihost("localhost:1", device="cpu")


def test_world_from_the_jax_arguments(no_world_env, tmp_path):
    w = initialize_multihost(f"file://{tmp_path / 'store'}", 1, 0,
                             device="cpu")
    assert (w.rank, w.size, w.backend) == (0, 1, "gloo")
    assert w.group is not None and distributed.process_count() == 1
    # an initialized world is reused
    assert initialize_multihost(device="cpu").group is w.group
    out = collectives_identity(w)
    assert all(v for k, v in out.items() if k != "world"), out


def test_world_from_torchrun_env(no_world_env, monkeypatch):
    for name, value in (("RANK", "0"), ("WORLD_SIZE", "1"),
                        ("LOCAL_RANK", "0"), ("MASTER_ADDR", "127.0.0.1"),
                        ("MASTER_PORT", str(_free_port()))):
        monkeypatch.setenv(name, value)
    w = initialize_multihost(device="cpu")
    assert (w.rank, w.size, w.local_rank, w.backend) == (0, 1, 0, "gloo")
    assert distributed.is_chief()


def test_collectives_are_the_identity_without_a_group():
    w = World(rank=0, size=1, local_rank=0, device=torch.device("cpu"))
    out = collectives_identity(w)
    assert all(v for k, v in out.items() if k != "world"), out
    assert collectives.capturable(None)
    assert collectives.world_size(None) == 1


# ---------------------------------------------------------------------------
# the chief, the shards, the flight recorder, the live world
# ---------------------------------------------------------------------------

def test_only_the_chief_writes_checkpoints(tmp_path):
    from dcgan_tpu_torch.train.steps import init_train_state
    from dcgan_tpu_torch.utils.checkpoint import Checkpointer

    cfg = TrainConfig(model=ModelConfig(**TINY), batch_size=4)
    state = init_train_state(cfg, device="cpu")
    peer = World(rank=1, size=2, local_rank=1, device=torch.device("cpu"))
    ckpt = Checkpointer(str(tmp_path), save_interval_secs=0.0, world=peer)
    ckpt.save(1, state)
    assert not ckpt.maybe_save(2, state)
    ckpt.wait()
    assert ckpt.latest_step() is None and ckpt.copy_event is None
    assert not os.listdir(tmp_path)
    chief = Checkpointer(str(tmp_path), world=dataclasses.replace(peer,
                                                                  rank=0))
    chief.save(1, state)
    chief.wait()
    assert chief.latest_step() == 1 == ckpt.latest_step()


def test_flight_recorder_names_per_rank(tmp_path):
    from dcgan_tpu_torch.train.flight_recorder import recorder_path

    assert os.path.basename(recorder_path(str(tmp_path))) == \
        "flight_recorder.jsonl"
    assert os.path.basename(recorder_path(str(tmp_path), 3)) == \
        "flight_recorder.p3.jsonl"


def test_progressive_checks_the_live_world():
    """validate_mesh gets the live world's data axis: a phase batch that
    does not divide over it fails with the JAX message."""
    from dcgan_tpu_torch.progressive import PhaseRuntime, parse_schedule

    cfg = TrainConfig(model=ModelConfig(**TINY), batch_size=8,
                      max_steps=8, progressive="8:2:6,16:*")
    sched = parse_schedule(cfg.progressive, model=cfg.model, batch_size=8,
                           max_steps=8)
    four = World(rank=0, size=4, local_rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError) as t:
        PhaseRuntime(cfg, sched, 8, world=four)
    with pytest.raises(ValueError) as j:
        sched.validate_mesh({"data": 4, "model": 1}, spatial=False)
    assert str(t.value) == str(j.value) and "4-way" in str(t.value)
    assert PhaseRuntime(cfg, sched, 8).world.size == 1
    np.testing.assert_equal(rank_rows(6, 1, 2).numpy(), [3, 4, 5])
