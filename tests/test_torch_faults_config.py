"""The port's counter snapshot, its new TrainConfig fields and the
rollback LR backoff's rate cells, against the JAX package's, on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

from dcgan_tpu import config as j_config
from dcgan_tpu.utils import metrics as j_metrics
from dcgan_tpu_torch import config
from dcgan_tpu_torch.train import steps
from dcgan_tpu_torch.utils import metrics
from torch_jax_draws import one_torch_thread  # noqa: F401


def test_counter_snapshot_fields_equal_jax():
    jf = [f.name for f in dataclasses.fields(j_metrics.CounterSnapshot)]
    assert [f.name for f in dataclasses.fields(
        metrics.CounterSnapshot)] == jf
    for mod in (metrics, j_metrics):
        reg = mod.CounterRegistry()
        reg.provide("rollbacks", lambda: 2)
        reg.provide_group(("compile_cache_hits", "services_queue"),
                          lambda: {"compile_cache_hits": 5,
                                   "services_queue": 1, "extra": 9})
        with pytest.raises(ValueError, match="unknown counter"):
            reg.provide("nope", lambda: 0)
        snap = reg.snapshot().as_dict()
        assert list(snap) == jf
        assert (snap["rollbacks"], snap["compile_cache_hits"],
                snap["services_queue"]) == (2, 5, 1)


NEW_FIELDS = ("rollback_snapshot_steps", "max_rollbacks",
              "rollback_lr_backoff", "async_services",
              "flight_recorder_steps", "collective_timeout_secs",
              "nan_policy")


@pytest.mark.parametrize("kw", [
    {"rollback_snapshot_steps": 0}, {"max_rollbacks": 0},
    {"rollback_lr_backoff": 0.0}, {"rollback_lr_backoff": 1.5},
    {"collective_timeout_secs": -1.0}, {"flight_recorder_steps": -1},
    {"nan_policy": "rollback", "steps_per_call": 4,
     "rollback_snapshot_steps": 6},
    {"nan_policy": "rollback", "rollback_lr_backoff": 0.5,
     "progressive": "32:2,64:*"}])
def test_new_config_fields_validate_as_jax(kw):
    for f in NEW_FIELDS:
        assert getattr(config.TrainConfig(), f) == \
            getattr(j_config.TrainConfig(), f), f
    with pytest.raises(ValueError) as je:
        j_config.TrainConfig(**kw)
    with pytest.raises(ValueError) as te:
        config.TrainConfig(**kw)
    assert str(te.value) == str(je.value)
    if kw.get("nan_policy") == "rollback":
        # the same values are fine without rollback armed
        calm = dict(kw, nan_policy="abort")
        assert config.TrainConfig(**calm).nan_policy == "abort"
        j_config.TrainConfig(**calm)


@pytest.mark.parametrize("schedule,warmup", [
    ("constant", 0), ("linear", 2), ("cosine", 3)])
def test_lr_backoff_cells_equal_the_rebuilt_schedule(schedule, warmup):
    """The backoff's rate cell at scale s gives the bits of the port's
    schedule built on the base rate times s (the JAX package rebuilds its
    step on `backoff_config`), and at scale 1 the bits of the plain
    schedule; against optax the schedule's own tolerance (1e-6 of the
    rate, tests/test_torch_train.py)."""
    from dcgan_tpu.train import steps as jsteps
    from dcgan_tpu.train.warmup import backoff_config

    kw = dict(lr_schedule=schedule, warmup_steps=warmup, max_steps=10)
    cfg = config.TrainConfig(nan_policy="rollback", rollback_lr_backoff=0.5,
                             **kw)
    cells = steps.make_lr_backoff(cfg)
    fn = steps.make_lr_schedule(cfg, 2e-4,
                                base_rate=lambda d: cells.cell("gen", d))
    counts = [torch.tensor(c, dtype=torch.int32) for c in (0, 1, 2, 5, 9)]
    plain = steps.make_lr_schedule(cfg, 2e-4)
    assert [fn(c).item() for c in counts] == [plain(c).item()
                                              for c in counts]
    cells.set_scale(0.25)
    rebuilt = steps.make_lr_schedule(cfg, 2e-4 * 0.25)
    assert [fn(c).item() for c in counts] == [rebuilt(c).item()
                                              for c in counts]
    jcfg = backoff_config(j_config.TrainConfig(**kw), 0.25)
    jfn = jsteps.make_lr_schedule(jcfg, jcfg.learning_rate)
    for c in counts:
        assert abs(fn(c).item() - float(jfn(np.int32(c.item())))) \
            <= 1e-6 * 2e-4
    default = steps.make_lr_backoff(config.TrainConfig(g_learning_rate=1e-4))
    assert default.cell("gen", torch.device("cpu")).item() == \
        torch.tensor(1e-4, dtype=torch.float32).item()
    assert default.cell("disc", torch.device("cpu")).item() == \
        torch.tensor(2e-4, dtype=torch.float32).item()
