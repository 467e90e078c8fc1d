"""Continued from test_torch_gd_pipeline.py: Pipelined G/D dispatch
(`pipeline_gd`) in the port against `dcgan_tpu`'s on the CPU."""

import numpy as np
import pytest

import torch_jax_draws as D
from dcgan_tpu_torch.train.warmup import metric_keys
from torch_jax_draws import one_torch_thread  # noqa: F401
from test_torch_gd_pipeline import _metrics_close, two_steps  # noqa: F401


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
