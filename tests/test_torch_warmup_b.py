"""Continued from test_torch_warmup.py: The port's captured-program slice on
the CPU, at a tiny config (16 px, gf = df = 8, z 8, batch 4)."""

import dataclasses

import numpy as np
import pytest
import torch

from dcgan_tpu_torch.config import ModelConfig
from dcgan_tpu_torch.train import steps, trainer, warmup
from test_torch_warmup import (  # noqa: F401
    BATCH, MODEL, _assert_same, _cfg, _one_torch_thread, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("model", [
    dict(use_pallas=True, pallas_fused=True, compute_dtype="bfloat16"),
    dict(compute_dtype="bfloat16"),
    dict(attn_res=8, spectral_norm="gd", use_pallas=True, bn_pallas=False,
         compute_dtype="bfloat16"),
])
def test_captured_steps_equal_eager(cuda, k, model):
    from dcgan_tpu_torch import graphs

    cfg = dataclasses.replace(_cfg(steps_per_call=k), model=ModelConfig(
        **dict(MODEL, gf_dim=16, df_dim=16, **model)))
    fns = steps.make_train_step(cfg)
    gen = torch.Generator(device=cuda).manual_seed(0)
    images = [torch.rand((BATCH, 16, 16, 3), generator=gen, device=cuda)
              * 2 - 1 for _ in range(8)]
    zs = [torch.rand((BATCH, 8), generator=gen, device=cuda) * 2 - 1
          for _ in range(8)]
    eager = fns.init(seed=0, device=cuda)
    losses = []
    for i in range(8):
        eager, m = fns.train_step(eager, images[i], zs[i])
        losses.append([float(m[key]) for key in warmup.METRIC_KEYS])
    runner = warmup.StepRunner(fns, fns.init(seed=0, device=cuda), cfg,
                               cuda)
    got, s = [], 0
    while s < 8:
        n = warmup.call_size(s, 8, k, runner.warm)
        got += runner.step(images[s:s + n], zs[s:s + n]).tolist()
        s += n
    assert got == losses
    _assert_same(runner.state, eager)
    before = graphs.launch_counts()
    runner.programs[runner.row(k)].run()
    torch.cuda.synchronize()
    delta = graphs.counts_delta(graphs.launch_counts(), before)
    assert delta == runner.programs[runner.row(k)].launches


@pytest.mark.cuda
def test_closed_runner_frees_its_graph_pool(cuda):
    import gc

    cfg = _cfg(steps_per_call=2)
    fns = steps.make_train_step(cfg)
    images = [torch.zeros((BATCH, 16, 16, 3), device=cuda)] * 3
    zs = [torch.zeros((BATCH, 8), device=cuda)] * 3
    def pools():
        return {tuple(seg["segment_pool_id"])
                for seg in torch.cuda.memory_snapshot()} - {(0, 0)}

    # without the collector, only close() breaks the programs' cycles; the
    # pools of other tests' graphs, if any are alive, are left out
    gc.collect()
    torch.cuda.empty_cache()
    others = pools()
    gc.disable()
    try:
        runner = warmup.StepRunner(fns, fns.init(seed=0, device=cuda), cfg,
                                   cuda)
        runner.step(images[:1], zs[:1])
        runner.step(images[1:3], zs[1:3])
        assert runner.programs["multi_step@k2"].pool_bytes > 0
        assert pools() - others
        runner.close()
        del runner
        torch.cuda.empty_cache()
        left = pools() - others
    finally:
        gc.enable()
    assert left == set()


@pytest.mark.cuda
def test_captured_rungs_equal_eager(cuda):
    from dcgan_tpu_torch.models.dcgan import generator_init, sampler_apply
    from dcgan_tpu_torch.serve.sources import StateSource

    mcfg = ModelConfig(**dict(MODEL, use_pallas=True, pallas_fused=True,
                              compute_dtype="bfloat16"))
    params, bn = generator_init(mcfg, seed=0, device=cuda)
    src = StateSource(mcfg, params, bn, device=cuda)
    src.bind((1, 4))
    assert src.captures == 2 and sorted(src.compile_ms) == [
        "sampler@b1", "sampler@b4"]
    for b in (1, 4):
        z = np.random.default_rng(b).uniform(-1, 1, (b, 8)).astype(
            np.float32)
        want = sampler_apply(params, bn, torch.from_numpy(z).to(cuda),
                             cfg=mcfg).float().cpu().numpy()
        np.testing.assert_array_equal(src.sample(b, z), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n_critic", [1, 2])
@pytest.mark.parametrize("model", [
    dict(use_pallas=True, pallas_fused=True, compute_dtype="bfloat16"),
    dict(compute_dtype="bfloat16")], ids=["kernel", "cudnn"])
def test_captured_stage_rows_equal_eager(cuda, n_critic, model):
    """pipeline_gd: the runner's three stage rows, captured, against a
    GDPipeline over the eager stage programs, bit for bit over a fill,
    steady steps, a drain and a refill; each replay adds its capture's
    launches to the kernels' counters."""
    from dcgan_tpu_torch import graphs
    from dcgan_tpu_torch.train.gd_pipeline import GDPipeline

    cfg = dataclasses.replace(
        _cfg(pipeline_gd=True, n_critic=n_critic), model=ModelConfig(
            **dict(MODEL, gf_dim=16, df_dim=16, **model)))
    fns = steps.make_train_step(cfg)
    gen = torch.Generator(device=cuda).manual_seed(0)
    images = [torch.rand((BATCH, 16, 16, 3), generator=gen, device=cuda)
              * 2 - 1 for _ in range(6)]
    draws = [trainer.stage_inputs(cfg, s, cuda) for s in range(6)]
    eager, pipe, losses = fns.init(seed=0, device=cuda), GDPipeline(), []
    runner = warmup.StepRunner(fns, fns.init(seed=0, device=cuda), cfg,
                               cuda)
    got = []
    for s in range(6):
        if s == 3:
            pipe.drain("restore")
            runner.pipeline.drain("restore")
        eager, m = pipe.step(fns, eager, images[s], draws[s])
        losses.append([float(m[k]) for k in runner.keys])
        got += runner.pipelined_step(images[s], draws[s], start=s).tolist()
    assert got == losses
    _assert_same(runner.state, eager)
    assert sorted(runner.programs) == sorted(warmup.STAGE_ROWS)
    before = graphs.launch_counts()
    runner.programs["d_update"].run()
    torch.cuda.synchronize()
    delta = graphs.counts_delta(graphs.launch_counts(), before)
    assert delta == runner.programs["d_update"].launches
    runner.close()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "uint8"])
def test_native_feed_equals_python_feed_on_the_card(cuda, tmp_path, dtype):
    """The trainer's feed on the card from the same shards, one pass on
    the raw pixel scale: the native loader's examples are the Python
    loader's, as a multiset, bit for bit."""
    from dcgan_tpu_torch.data import pipeline
    from dcgan_tpu_torch.data.synthetic import write_image_tfrecords

    write_image_tfrecords(str(tmp_path), num_examples=48, image_size=16,
                          num_shards=3, record_dtype=dtype)
    rows = []
    for native in (True, False):
        cfg = pipeline.DataConfig(
            data_dir=str(tmp_path), image_size=16, batch_size=6,
            record_dtype=dtype, min_after_dequeue=8, n_threads=3,
            loop=False, normalize=False, use_native=native)
        ds = pipeline.make_dataset(cfg, cuda)
        try:
            got = [b for b in ds]
        finally:
            ds.close()
        assert all(b.device.type == "cuda" for b in got)
        rows.append(sorted(r.cpu().numpy().tobytes()
                           for b in got for r in b))
    assert len(rows[0]) == 48 and rows[0] == rows[1]
