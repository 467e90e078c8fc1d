"""The spatial mesh of the port on the CPU (parallel/spatial.py): gloo
worlds spawned by `dcgan_tpu_torch/testing/multihost.py::run_world` (the
ranks in tests/torch_spatial_worker.py, which imports no JAX), four in
all, and the units of its configuration and routing.

- Halo-exchanged conv and deconv over worlds of 2 and 4 ranks (every rank
  a block of rows of one map, the model axis the whole world) against the
  unsharded op on the whole map: each rank's output rows and its rows of
  x's gradient, and the sum over the ranks of the weight and bias
  gradients, within 1e-5 x the largest value (f32, summation order).
  Kernel 5 at stride 2 both ways, and kernel 7, whose conv needs 3 rows
  below a block: at 4 ranks a block of 2 rows, so that stage is gathered.
  In the same worlds ring, Ulysses (4 heads) and ring x flash over the
  world's GroupRing (P2P and all_to_all over gloo) against attention over
  the whole sequence, output and gradients, within the same rule.
- One step of the port's spatial `sagan`-tiny (gf = df = 8, 16 px,
  attention at 8 px on the flash kernels' plain versions, spectral norm,
  hinge) on a data 2 x model 2 world with the ring against JAX's
  `make_parallel_train(MeshConfig(data=2, model=2, spatial=True))` on 4
  of conftest's 8 virtual devices, from JAX's init with JAX's draws: the
  losses within 1e-4 relative, every rank's state bit for bit the same,
  the step's gradients and parameters by `_hold_step`, and the sampler's
  gathered images on the stepped state within 1e-5 of JAX's. One Ulysses
  step (gf = df = 16, 2 heads) at data 2 x model 2 against the port's own
  world-1 step, by the same rules (the JAX gspmd Ulysses step at this
  mesh disagrees with its own single-device step by far more: ROADMAP
  Queue C), and `summarize` on the stepped states: the same tensors with
  the same element counts (z and D's outputs counted once, not once a
  model rank), their min, max, mean and std within 1e-3 of their scale
  (the states differ by Adam's 2 * lr where a near-0 gradient's sign
  differs).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from dcgan_tpu.config import MeshConfig as JMeshConfig
from dcgan_tpu.config import ModelConfig as JModelConfig
from dcgan_tpu.config import TrainConfig as JTrainConfig
from dcgan_tpu.parallel import make_parallel_train as j_make_parallel_train
from dcgan_tpu.parallel.mesh import make_mesh as j_make_mesh
from dcgan_tpu.train import cli as jcli
from dcgan_tpu_torch import config as tconfig
from dcgan_tpu_torch.config import MeshConfig, ModelConfig, TrainConfig
from dcgan_tpu_torch.ops import attention as tattn
from dcgan_tpu_torch.ops import flash_attention as tflash
from dcgan_tpu_torch.ops.layers import conv2d_apply, deconv2d_apply
from dcgan_tpu_torch.parallel import collectives
from dcgan_tpu_torch.parallel.api import check_spatial, data_shard, \
    spatial_route
from dcgan_tpu_torch.parallel.distributed import World
from dcgan_tpu_torch.parallel.mesh import make_mesh
from dcgan_tpu_torch.testing.multihost import run_world
from dcgan_tpu_torch.train import cli as tcli
from dcgan_tpu_torch.train.steps import make_train_step
from dcgan_tpu_torch.train.warmup import EagerProgram
from torch_jax_draws import one_torch_thread, step_draws  # noqa: F401

TESTS = str(__import__("pathlib").Path(__file__).resolve().parent)
WORLD_TIMEOUT = 240.0
BATCH, SIZE = 8, 16
SAGAN = dict(output_size=SIZE, z_dim=8, compute_dtype="float32",
             attn_res=8, spectral_norm="gd", use_pallas=True,
             bn_pallas=False)
TRAIN = dict(batch_size=BATCH, loss="hinge", beta1=0.0, g_ema_decay=0.999)
SPATIAL_2X2 = dict(data=2, model=2, spatial=True)


# the step's gradients, read from Adam's first moment (beta1 = 0: after
# one step mu is the gradient): each leaf within MU_RTOL of its largest
# value plus MU_ATOL of its net's largest (f32, the order of the sums over
# ranks and halo rows)
MU_RTOL, MU_ATOL = 1e-4, 1e-5
# an element whose two gradients agree in sign and are both above
# CLEAR_OF_EPS takes Adam's first step -lr * sign(g) on both sides, up to
# the rounding of p - lr (PARAM_ATOL)
CLEAR_OF_EPS, PARAM_ATOL = 1e-6, 1e-6


def _hold_step(got, want, lr):
    """Holds one step's flat state `got` against `want`, both from one
    state: the gradients (`opt/<net>/mu/...`) by MU_RTOL and MU_ATOL, and
    the parameters element by element, within PARAM_ATOL where the two
    gradients agree in sign clear of Adam's eps, and elsewhere within
    tests/test_attention.py:293-314's 2 * lr + 1e-5 (Adam's first step
    moves a parameter by at most lr whatever its gradient, so a gradient
    zero to rounding whose sign differs moves it 2 * lr apart). Returns the
    number of parameter elements that took the wider rule."""
    wide = 0
    for net in ("gen", "disc"):
        mus = {p: w.numpy() for p, w in want.items()
               if p.startswith(f"opt/{net}/mu/")}
        assert mus, net
        top = max(float(np.abs(w).max()) for w in mus.values())
        for path, w in mus.items():
            err = float(np.abs(got[path] - w).max())
            bound = MU_RTOL * float(np.abs(w).max()) + MU_ATOL * top
            assert err <= bound, (path, err, bound)
            param = f"params/{net}/" + path[len(f"opt/{net}/mu/"):]
            gap = np.abs(got[param] - want[param].numpy())
            g = got[path]
            agree = (np.sign(g) == np.sign(w)) & (np.abs(g) > CLEAR_OF_EPS) \
                & (np.abs(w) > CLEAR_OF_EPS)
            assert float(gap[agree].max(initial=0.0)) <= PARAM_ATOL, param
            assert float(gap.max()) <= 2 * lr[net] + 1e-5, param
            wide += int((~agree).sum())
    return wide


def _close(name, got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.abs(got - want).max(initial=0.0))
    bound = rtol * float(np.abs(want).max(initial=0.0)) + 1e-6
    assert err <= bound, (name, err, bound)


# ---------------------------------------------------------------------------
# the worlds
# ---------------------------------------------------------------------------

def _halo_cases(rng):
    def case(op, k, h, cin=3, cout=4):
        x = rng.normal(size=(2, h, 6, cin)).astype(np.float32)
        out_h = h // 2 if op == "conv" else 2 * h
        return {"op": op,
                "x": x,
                "w": rng.normal(size=(k, k, cin, cout)).astype(np.float32),
                "b": rng.normal(size=(cout,)).astype(np.float32),
                "g": rng.normal(size=(2, out_h, 12 if op == "deconv" else 3,
                                      cout)).astype(np.float32)}
    return [case("conv", 5, 16), case("deconv", 5, 8), case("conv", 7, 8),
            case("deconv", 5, 4)]


def _attn_inputs(rng):
    return {k: rng.normal(size=(2, 16, d)).astype(np.float32)
            for k, d in (("q", 8), ("k", 8), ("v", 16), ("g", 16))}


@pytest.mark.parametrize("n", [2, 4])
def test_halo_ops_and_group_rings_match_the_whole_map(n):
    rng = np.random.default_rng(n)
    cases = _halo_cases(rng)
    attn = dict(_attn_inputs(rng), heads=4, scale=0.5)
    outs = run_world("torch_spatial_worker:halo_and_ring", n,
                     kwargs={"cases": cases, "attn": attn}, paths=[TESTS],
                     timeout=WORLD_TIMEOUT)
    for i, c in enumerate(cases):
        fn = conv2d_apply if c["op"] == "conv" else deconv2d_apply
        x = torch.from_numpy(c["x"]).requires_grad_(True)
        p = {"w": torch.from_numpy(c["w"]).requires_grad_(True),
             "b": torch.from_numpy(c["b"]).requires_grad_(True)}
        y = fn(p, x)
        (y * torch.from_numpy(c["g"])).sum().backward()
        tag = f"{c['op']} k{c['w'].shape[0]} on {c['x'].shape[1]} rows"
        _close(f"{tag} y", np.concatenate([o["halo"][i]["y"] for o in outs],
                                          1), y.detach())
        _close(f"{tag} dx", np.concatenate([o["halo"][i]["gx"]
                                            for o in outs], 1), x.grad)
        _close(f"{tag} dw", sum(o["halo"][i]["gw"] for o in outs), p["w"].grad)
        _close(f"{tag} db", sum(o["halo"][i]["gb"] for o in outs), p["b"].grad)
        assert all(o["halo"][i]["collectives"] >= 2 for o in outs), tag
    t = {k: torch.from_numpy(v).requires_grad_(True) for k, v in
         attn.items() if k in "qkv"}
    for name in ("ring", "ulysses", "ring_flash"):
        for v in t.values():
            v.grad = None
        if name == "ulysses":
            q, k, v = (tattn._split_heads(t[c], 4) for c in "qkv")
            out = tattn._merge_heads(tattn.full_attention(q, k, v,
                                                          scale=0.5), 4)
        elif name == "ring":
            out = tattn.full_attention(t["q"], t["k"], t["v"], scale=0.5)
        else:
            out = tflash.flash_attention(t["q"], t["k"], t["v"], 0.5)
        (out * torch.from_numpy(attn["g"])).sum().backward()
        for j, want in enumerate((out.detach(), t["q"].grad, t["k"].grad,
                                  t["v"].grad)):
            _close(f"{name} {j}", np.concatenate(
                [o["ring"][name][j] for o in outs], 1), want)


def test_spatial_ring_step_matches_jax():
    jcfg = JTrainConfig(model=JModelConfig(gf_dim=8, df_dim=8, **SAGAN),
                        mesh=JMeshConfig(**SPATIAL_2X2), **TRAIN)
    pt = j_make_parallel_train(jcfg, j_make_mesh(jcfg.mesh,
                                                 jax.devices()[:4]))
    state = pt.init(jax.random.key(0))
    init = jax.device_get(state)
    images = np.tanh(np.random.default_rng(1).normal(
        size=(BATCH, SIZE, SIZE, 3))).astype(np.float32)
    key = jax.random.key(5)
    z, draws = step_draws(jcfg, key, BATCH)
    state, metrics = pt.step(state, jax.numpy.asarray(images), key)
    sample_z = np.asarray(jax.random.uniform(jax.random.key(7), (BATCH, 8),
                                             minval=-1.0, maxval=1.0))
    j_sample = np.asarray(pt.sample(state, sample_z))
    outs = run_world("torch_spatial_worker:spatial_train", 4, kwargs=dict(
        model_kw=dict(gf_dim=8, df_dim=8, **SAGAN), train_kw=TRAIN,
        mesh_kw=SPATIAL_2X2, state=init,
        steps=[{"images": images, "z": z, "draws": draws}],
        sample_z=sample_z), paths=[TESTS], timeout=WORLD_TIMEOUT)
    for o in outs[1:]:
        assert o["metrics"] == outs[0]["metrics"]
        for path, v in outs[0]["state"].items():
            assert np.array_equal(o["state"][path], v), path
        assert np.array_equal(o["sample"], outs[0]["sample"])
    got = outs[0]["metrics"][0]
    for k, v in metrics.items():
        np.testing.assert_allclose(got[k], float(v), rtol=1e-4)
    from dcgan_tpu_torch import convert

    want = convert.flatten(convert.train_state_from_jax(
        jax.device_get(state), device="cpu"))
    _hold_step(outs[0]["state"], want, {"gen": jcfg.learning_rate,
                                        "disc": jcfg.learning_rate})
    _close("sample", outs[0]["sample"], j_sample)
    assert outs[0]["collectives"]["p2p"] > 0


def test_spatial_ulysses_step_matches_world_one():
    model_kw = dict(gf_dim=16, df_dim=16, attn_heads=2,
                    attn_seq_strategy="ulysses", **SAGAN)
    cfg = TrainConfig(model=ModelConfig(**model_kw), **TRAIN)
    fns = make_train_step(cfg)
    state = fns.init(seed=0, device="cpu")
    images = np.tanh(np.random.default_rng(2).normal(
        size=(BATCH, SIZE, SIZE, 3))).astype(np.float32)
    g = torch.Generator().manual_seed(3)
    z = torch.rand((BATCH, 8), generator=g) * 2 - 1
    state, metrics = fns.train_step(state, torch.from_numpy(images), z, {})
    sz = torch.rand((BATCH, 8), generator=g) * 2 - 1
    summary = fns.summarize(state, torch.from_numpy(images), sz)
    outs = run_world("torch_spatial_worker:spatial_train", 4, kwargs=dict(
        model_kw=model_kw, train_kw=TRAIN, mesh_kw=SPATIAL_2X2, state=None,
        steps=[{"images": images, "z": z.numpy(), "draws": {}}],
        summary={"images": images, "z": sz.numpy()}),
        paths=[TESTS], timeout=WORLD_TIMEOUT)
    for o in outs[1:]:
        assert o["metrics"] == outs[0]["metrics"]
    for k, v in metrics.items():
        np.testing.assert_allclose(outs[0]["metrics"][0][k], float(v),
                                   rtol=1e-4)
    from dcgan_tpu_torch import convert

    _hold_step(outs[0]["state"], convert.flatten(state),
               {"gen": cfg.learning_rate, "disc": cfg.learning_rate})
    assert outs[0]["collectives"]["all_to_all"] > 0
    # summarize: the maps' statistics over the world, z's and D's outputs
    # over the data axis, as the whole batch's (the parameters stepped
    # apart by up to 2 * lr: the statistics within 1e-3 of their scale)
    got = outs[0]["summary"]
    assert sorted(got) == sorted(summary)
    for name, want in summary.items():
        assert got[name]["count"] == want["count"], name
        assert np.array_equal(got[name]["bin_counts"].sum(),
                              want["bin_counts"].sum().numpy()), name
        for k in ("min", "max", "mean", "std"):
            w = float(want[k])
            assert abs(float(got[name][k]) - w) <= 1e-3 * max(1.0, abs(w)), \
                (name, k)


# ---------------------------------------------------------------------------
# configuration and routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", [
    {"model": 2}, {"model": 2, "spatial": True, "shard_opt": True},
    {"shard_opt": True}, {"zero_stage": 3}])
def test_unported_mesh_settings_name_queue_a_item_7(mesh):
    """Tensor parallelism (model > 1 without spatial) and the ZeRO
    stages stay refused by name; the spatial mesh itself is accepted."""
    JMeshConfig(**mesh)
    with pytest.raises(NotImplementedError, match="Queue A item 7") as e:
        MeshConfig(**mesh)
    if "spatial" not in mesh and "model" in mesh:
        assert "model=2 without spatial" in str(e.value)
    assert MeshConfig(model=2, spatial=True) == \
        JMeshConfig(model=2, spatial=True)


@pytest.mark.parametrize("kw,name", [
    ({"model": {"arch": "resnet"}}, "arch"),
    ({"model": {"arch": "stylegan"}}, "arch"),
    ({"model": {"num_classes": 10}}, "class conditioning"),
    ({"diffaug": "color"}, "DiffAugment"),
    ({"loss": "wgan-gp"}, "gradient penalties"),
    ({"r1_gamma": 10.0}, "gradient penalties"),
    ({"pipeline_gd": True}, "pipelined"),
    ({"precision": "fp8"}, "fp8"),
    ({"progressive": "8:2,16:*", "max_steps": 10}, "progressive")])
def test_spatial_refuses_what_it_does_not_run_by_name(kw, name):
    model = dict(output_size=16, **kw.get("model", {}))
    train = {k: v for k, v in kw.items() if k != "model"}
    cfg = dict(model=ModelConfig(**model), **train)
    TrainConfig(**cfg)   # accepted without the spatial mesh
    with pytest.raises(NotImplementedError, match="Queue A item 7") as e:
        TrainConfig(mesh=MeshConfig(model=2, spatial=True), **cfg)
    assert name in str(e.value)


def test_shard_map_backend_refuses_the_model_axis_as_jax_does():
    with pytest.raises(ValueError) as j:
        JTrainConfig(mesh=JMeshConfig(model=2, spatial=True),
                     backend="shard_map")
    with pytest.raises(ValueError) as t:
        TrainConfig(mesh=MeshConfig(model=2, spatial=True),
                    backend="shard_map")
    assert str(t.value) == str(j.value)


def test_use_pallas_without_attention_refused_as_jax_does():
    kw = dict(output_size=16, gf_dim=8, df_dim=8, use_pallas=True)
    jcfg = JTrainConfig(model=JModelConfig(**kw), batch_size=4,
                        mesh=JMeshConfig(data=1, model=2, spatial=True))
    with pytest.raises(ValueError) as j:
        j_make_parallel_train(jcfg, j_make_mesh(jcfg.mesh,
                                                jax.devices()[:2]))
    cfg = TrainConfig(model=ModelConfig(**kw), batch_size=4,
                      mesh=MeshConfig(data=1, model=2, spatial=True))
    with pytest.raises(ValueError) as t:
        spatial_route(cfg, make_mesh(cfg.mesh, 2))
    assert str(t.value) == str(j.value)


def test_attention_narrows_the_bn_and_fused_kernels_off():
    cfg = TrainConfig(model=ModelConfig(output_size=16, attn_res=8,
                                        use_pallas=True, pallas_fused=True),
                      mesh=MeshConfig(model=2, spatial=True))
    routed = spatial_route(cfg, make_mesh(cfg.mesh, 2))
    assert routed.model.use_pallas and not routed.model.bn_use_pallas
    assert not routed.model.pallas_fused
    # a data-parallel mesh keeps the kernels
    dp = dataclasses.replace(cfg, mesh=MeshConfig())
    assert spatial_route(dp, make_mesh(dp.mesh, 2)) is dp


@pytest.mark.parametrize("model,ok", [(2, True), (4, True), (8, False)])
def test_every_map_splits_into_even_blocks(model, ok):
    cfg = TrainConfig(model=ModelConfig(output_size=32))
    if ok:
        check_spatial(cfg, model)
    else:
        with pytest.raises(ValueError, match="do not split"):
            check_spatial(cfg, model)


def test_model_groups_read_one_data_shard():
    """Rank r sits at data index r // model (JAX's reshape(data, model)),
    and the ranks of a model group read that index's share."""
    cfg = TrainConfig(mesh=MeshConfig(data=2, model=2, spatial=True))
    dev = torch.device("cpu")
    got = [data_shard(cfg, World(rank=r, size=4, local_rank=0, device=dev))
           for r in range(4)]
    assert got == [(0, 2), (0, 2), (1, 2), (1, 2)]
    assert data_shard(TrainConfig(), World(rank=3, size=4, local_rank=0,
                                           device=dev)) == (3, 4)


def test_cli_mesh_and_seq_strategy_flags_equal_the_jax_cli():
    argv = ["--preset", "sagan64", "--mesh_data", "2", "--mesh_model", "2",
            "--mesh_spatial", "--seq_strategy", "ulysses", "--attn_heads",
            "2"]
    from dcgan_tpu import presets as jpresets

    want = jcli.apply_overrides(jpresets.get_preset("sagan64"),
                                jcli.explicit_flags(argv))
    got = tcli.config_from_args(tcli.build_parser().parse_args(argv))
    assert got.mesh == want.mesh and got.mesh.spatial
    assert dataclasses.asdict(got.model) == dataclasses.asdict(want.model)
    assert got.model.attn_seq_strategy == "ulysses"
    assert tconfig.config_from_dict(dataclasses.asdict(got)).mesh == got.mesh


def test_bf16_gradients_of_f32_operands_are_refused():
    q, k = torch.randn(1, 8, 4), torch.randn(1, 8, 4)
    v = do = torch.randn(1, 8, 8)
    args = (q, k, v, do, torch.zeros(1, 8), torch.zeros(1, 8), 0.5)
    for fn in (tflash.flash_dq, tflash.flash_dkv):
        with pytest.raises(ValueError, match="operands' dtype"):
            fn(*args, out_dtype=torch.bfloat16)


def test_one_block_ring_is_flash_and_full_attention():
    """ring.n == 1 runs flash_attention / full_attention themselves (JAX:
    n_shards == 1)."""
    q, k, v = (torch.randn(2, 8, d) for d in (4, 4, 8))
    ring = collectives.LocalRing(1)
    assert torch.equal(tflash.ring_flash_attention(q, k, v, scale=0.5,
                                                   ring=ring),
                       tflash.flash_attention(q, k, v, 0.5))
    assert torch.equal(tattn.ring_attention(q, k, v, ring=ring, scale=0.5),
                       tattn.full_attention(q, k, v, scale=0.5))


def test_local_all_to_all_is_the_tiled_exchange():
    """Shard j of the result holds, along concat_dim, chunk j of every
    shard's split_dim in shard order (lax.all_to_all(tiled=True))."""
    n, b = 4, 2
    x = torch.arange(n * b * 8 * 4 * 3, dtype=torch.float32).reshape(
        n * b, 8, 4, 3)
    got = collectives.local_all_to_all(x, n, 2, 1)
    shards = x.chunk(n, 0)
    for j in range(n):
        want = torch.cat([s.chunk(n, 2)[j] for s in shards], 1)
        assert torch.equal(got.chunk(n, 0)[j], want)


def test_gloo_p2p_is_staged_without_a_probe():
    """gloo's send and recv have no CUDA path: a CUDA tensor is sent
    through host memory, decided without any collective."""
    group = object()
    try:
        assert not collectives._gloo_takes_cuda(group, torch.zeros(1),
                                                "p2p")
    finally:
        collectives._GLOO_CUDA.pop((group, "p2p"), None)


def test_an_eager_program_runs_its_function_on_every_call():
    """The programs of a runner whose collectives run over gloo on CUDA
    ranks (StepRunner.eager): nothing is recorded, every run calls the
    function, and a second capture is refused as a captured program's."""
    calls = []
    prog = EagerProgram("x", lambda: calls.append(1) or len(calls),
                        torch.device("cuda"))
    assert prog.capture() == 0.0 and prog.captured
    assert prog.run() == 1 and prog.run() == 2 and prog.graph is None
    with pytest.raises(RuntimeError, match="captured already"):
        prog.capture()
