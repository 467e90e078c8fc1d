"""The serving fleet on the card: promotions into captured rungs, the
artifact on captured rungs, launch counts under concurrent replicas, and
graph pools released at stop. Every test here needs a CUDA device and
skips without one; the module imports nothing of JAX, so the card's
machine runs it with:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_fleet_cuda.py

The same paths run eagerly on the CPU in tests/test_torch_fleet.py and
tests/test_torch_export.py.
"""

import gc
import threading
import time

import numpy as np
import pytest
import torch

from dcgan_tpu_torch.config import ModelConfig, TrainConfig, save_config
from dcgan_tpu_torch.convert import flatten
from dcgan_tpu_torch.train.steps import init_train_state, tree_map
from dcgan_tpu_torch.utils.checkpoint import Checkpointer

MODEL = dict(output_size=32, gf_dim=16, df_dim=16, z_dim=16,
             compute_dtype="bfloat16", use_pallas=True, pallas_fused=True)
TIMEOUT = 120.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs exist only on the card")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    # cuDNN's deterministic algorithms, so that a fresh source's replays
    # and the promoted source's see the same convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = saved


def _save_step(directory, step, scale):
    cfg = TrainConfig(model=ModelConfig(**MODEL), batch_size=4)
    state = init_train_state(cfg, device="cpu")
    state["params"]["gen"] = tree_map(lambda w: w * scale,
                                      state["params"]["gen"])
    state["step"] = torch.tensor(step, dtype=torch.int32)
    save_config(cfg, directory)
    ckpt = Checkpointer(directory)
    ckpt.save(step, state)
    ckpt.wait()


def _z(n, seed):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, MODEL["z_dim"])).astype(np.float32)


def _pooled():
    """Segments of CUDA graph private pools still reserved."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return [seg for seg in torch.cuda.memory_snapshot()
            if tuple(seg["segment_pool_id"]) != (0, 0)]


@pytest.mark.cuda
def test_promotion_under_load(cuda, tmp_path):
    """A client thread keeps submitting while the fleet promotes step 2:
    no request fails, no capture, every leaf keeps its address, and the
    images after it equal a fresh source's on step 2 bit for bit."""
    from dcgan_tpu_torch.serve.fleet import ServeFleet
    from dcgan_tpu_torch.serve.sources import CheckpointSource

    ckpt = str(tmp_path / "ckpt")
    _save_step(ckpt, 1, 2.0)
    srcs = [CheckpointSource(ckpt, device=cuda) for _ in range(2)]
    fleet = ServeFleet(srcs, max_batch=8, max_wait_ms=1.0)
    fleet.start(timeout=TIMEOUT)
    try:
        ptrs = [{k: v.data_ptr() for k, v in flatten(s._params).items()}
                for s in srcs]
        stop = threading.Event()
        resps = []

        def client():
            i = 0
            while not stop.is_set():
                resps.append(fleet.submit(1 + i % 8, client_id=i % 3))
                i += 1
                time.sleep(0.002)
        t = threading.Thread(target=client)
        t.start()
        time.sleep(0.2)
        _save_step(ckpt, 2, 3.0)
        results = fleet.promote()
        time.sleep(0.2)
        stop.set()
        t.join(TIMEOUT)
        z = _z(5, 1)
        after = fleet.submit(z=z).result(TIMEOUT)
    finally:
        fleet.stop()
    assert [(r["step"], r["compile_requests_delta"]) for r in results] == \
        [(2, 0), (2, 0)]
    assert all(r.result(TIMEOUT) is not None for r in resps)
    assert fleet.report()["serve/dropped"] == 0.0
    assert [{k: v.data_ptr() for k, v in flatten(s._params).items()}
            for s in srcs] == ptrs
    fresh = CheckpointSource(ckpt, device=cuda)
    fresh.prepare()
    fresh.bind((8,))
    rows = np.zeros((8, MODEL["z_dim"]), np.float32)
    rows[:5] = z
    want = fresh.sample(8, rows)[:5]
    fresh.close()
    np.testing.assert_array_equal(after, want)


@pytest.mark.cuda
def test_artifact_on_captured_rungs(cuda, tmp_path):
    """An artifact exported on the card serves through captured rungs, bit
    for bit its program called eagerly, within 2e-2 of the checkpoint's
    plain-route sampler."""
    import dataclasses

    from dcgan_tpu_torch.export import export_sampler, load_sampler
    from dcgan_tpu_torch.models.dcgan import sampler_apply
    from dcgan_tpu_torch.serve.server import SamplerServer
    from dcgan_tpu_torch.serve.sources import ArtifactSource, \
        CheckpointSource

    ckpt = str(tmp_path / "ckpt")
    _save_step(ckpt, 1, 2.0)
    out = str(tmp_path / "s.pt2")
    meta = export_sampler(ckpt, out, device="cuda", max_serve_batch=8)
    assert meta["platforms"] == ["cuda"]
    src = ArtifactSource(out, device=cuda)
    server = SamplerServer(src, max_wait_ms=1.0)
    server.start(timeout=TIMEOUT)
    try:
        assert all(prog.graph is not None
                   for *_, prog in src._rungs.values())
        z = _z(8, 2)
        got = server.submit(z=z).result(TIMEOUT)
    finally:
        server.stop()
    eager = load_sampler(out)(torch.from_numpy(z).to(cuda)).float()
    np.testing.assert_array_equal(got, eager.cpu().numpy())
    ref = CheckpointSource(ckpt, device=cuda)
    ref.prepare()
    plain = dataclasses.replace(ref.cfg, use_pallas=False,
                                pallas_fused=False)
    want = sampler_apply(ref._params, ref._state,
                         torch.from_numpy(z).to(cuda), cfg=plain)
    assert float((want.float().cpu() - torch.from_numpy(got)).abs()
                 .max()) <= 2e-2


@pytest.mark.cuda
def test_launch_counts_under_two_replicas(cuda, tmp_path):
    """Two replicas replaying at once from their dispatch threads: each
    kernel's count rises by exactly its replays' recorded launches.

    Each client sticks to the replica of its first request, which the
    router picks by queue depth: both dispatch loops are held until the
    two first requests are queued, so the clients land on both replicas
    whatever the timing."""
    from dcgan_tpu_torch import graphs
    from dcgan_tpu_torch.serve.fleet import ServeFleet
    from dcgan_tpu_torch.serve.sources import CheckpointSource

    ckpt = str(tmp_path / "ckpt")
    _save_step(ckpt, 1, 2.0)
    srcs = [CheckpointSource(ckpt, device=cuda) for _ in range(2)]
    fleet = ServeFleet(srcs, max_batch=8, max_wait_ms=0.5)
    gate = threading.Event()
    for server in fleet.servers:
        def held(orig=server._next_batch):
            gate.wait(TIMEOUT)
            return orig()
        server._next_batch = held
    fleet.start(timeout=TIMEOUT)
    runs = []
    real_run = graphs.CapturedProgram.run

    def run(self):
        runs.append(self)
        return real_run(self)
    before = graphs.launch_counts()
    graphs.CapturedProgram.run = run
    try:
        first = [fleet.submit(1 + seed % 8, client_id=seed)
                 for seed in range(2)]
        gate.set()

        def client(seed):
            first[seed].result(TIMEOUT)
            for i in range(1, 60):
                fleet.submit(1 + (seed + i) % 8,
                             client_id=seed).result(TIMEOUT)
        threads = [threading.Thread(target=client, args=(s,))
                   for s in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
            assert not t.is_alive()
    finally:
        graphs.CapturedProgram.run = real_run
        fleet.stop()
    got = graphs.counts_delta(graphs.launch_counts(), before)
    for name in ("scale_shift_act", "gemm_bias_scale_act"):
        want = sum(prog.launches[name][0] for prog in runs)
        assert want > 0 and got[name][0] == want, name
    assert {s.replica_index for s in fleet.servers
            if s.batches} == {0, 1}


@pytest.mark.cuda
def test_fleet_stop_releases_graph_pools(cuda, tmp_path):
    """After ServeFleet.stop() no segment of a graph pool is reserved,
    before any garbage collection."""
    from dcgan_tpu_torch.serve.fleet import ServeFleet
    from dcgan_tpu_torch.serve.sources import CheckpointSource

    ckpt = str(tmp_path / "ckpt")
    _save_step(ckpt, 1, 2.0)
    gc.collect()
    assert _pooled() == []
    collecting = gc.isenabled()
    gc.disable()
    try:
        fleet = ServeFleet([CheckpointSource(ckpt, device=cuda)
                            for _ in range(2)], max_batch=8)
        fleet.start(timeout=TIMEOUT)
        assert _pooled()
        fleet.submit(3).result(TIMEOUT)
        fleet.stop()
        assert _pooled() == []
    finally:
        if collecting:
            gc.enable()
