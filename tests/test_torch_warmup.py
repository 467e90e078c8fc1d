"""The port's captured-program slice on the CPU, at a tiny config (16 px,
gf = df = 8, z 8, batch 4):

- the multi-tensor Adam (`train/steps.py::Adam.step`, torch._foreach_*)
  and the G EMA equal their per-leaf versions (kept here as the plain
  versions) bit for bit, over 3 updates, with and without grad_clip;
- `steps_per_call`'s cadence validation raises the JAX package's
  messages;
- `StepRunner` (train/warmup.py) through the trainer, K = 4 over 8 steps:
  the final state equals 8 eager `train_step`s bit for bit, and so does a
  run resumed at step 5 (unaligned, so single steps realign); a resume
  copies into the static state;
- `build_warmup_plan`'s rows equal the JAX plan's for the same config
  (without the JAX `state_copy`, which the port has no program for), and
  --aot_warmup writes one `perf/compile_ms/<row>` per row;
- `StepTimer.tick(steps=K)` gives the JAX StepTimer's stats;
- the served rungs report `serve/compile_ms/sampler@b<rung>` and
  `serve/recompiles_after_warmup` 0.

On the card also: pipeline_gd's three captured stage rows against the
eager stage programs, and the native feed against the Python feed.

On the CPU the runner and the rungs run eagerly over their static buffers.
The captures themselves are the `cuda` tests at the end, which skip
without a card; the module imports JAX only inside the tests that
compare with it, so the card's machine (no JAX) runs them with:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_warmup.py
"""

import json
import os

import numpy as np
import pytest
import torch

from dcgan_tpu_torch import convert
from dcgan_tpu_torch.config import ModelConfig, TrainConfig
from dcgan_tpu_torch.train import steps, trainer, warmup
from dcgan_tpu_torch.utils.profiling import StepTimer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's intra-op pool held to one thread on the CPU, as
    tests/torch_jax_draws.py::one_torch_thread does for the JAX-importing
    port tests (this file also runs on the card, without JAX)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


MODEL = dict(output_size=16, gf_dim=8, df_dim=8, z_dim=8,
             compute_dtype="float32")
BATCH = 4


def _cfg(root=None, **kw):
    base = dict(model=ModelConfig(**MODEL), batch_size=BATCH,
                sample_every_steps=0, save_summaries_secs=1e9,
                save_model_secs=1e9, tensorboard=False)
    if root is not None:
        base.update(checkpoint_dir=str(root / "ckpt"),
                    sample_dir=str(root / "samples"))
    base.update(kw)
    return TrainConfig(**base)


def _assert_same(a, b):
    fa, fb = convert.flatten(a), convert.flatten(b)
    assert sorted(fa) == sorted(fb)
    bad = [k for k in fa if fa[k].dtype != fb[k].dtype
           or not torch.equal(fa[k], fb[k])]
    assert not bad, bad


# ---------------------------------------------------------------------------
# the multi-tensor Adam and EMA against their per-leaf versions
# ---------------------------------------------------------------------------

def per_leaf_adam_step(opt, params, grads, state):
    """The per-leaf Adam the multi-tensor one replaced: one set of
    elementwise ops per leaf, in optax's order."""
    tree_map, tree_leaves = steps.tree_map, steps.tree_leaves
    if opt.grad_clip > 0:
        g_norm = torch.sqrt(sum(torch.sum(g * g)
                                for g in tree_leaves(grads)))
        keep = g_norm < opt.grad_clip
        grads = tree_map(lambda g: torch.where(
            keep, g, (g / g_norm.to(g.dtype)) * opt.grad_clip), grads)
    b1, b2 = opt.b1, opt.b2
    mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
    nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads,
                  state["nu"])
    count = state["count"]
    count_inc = count + 1
    t = count_inc.to(torch.float32)
    bc1 = 1 - torch.full((), b1, dtype=torch.float32, device=t.device) ** t
    bc2 = 1 - torch.full((), b2, dtype=torch.float32, device=t.device) ** t
    step_size = -opt.lr(count)
    eps = opt.eps

    def update(p, m, v):
        u = (m / bc1.to(m.dtype)) / (torch.sqrt(v / bc2.to(v.dtype)) + eps)
        return (p + step_size.to(u.dtype) * u).to(p.dtype)

    return tree_map(update, params, mu, nu), {"mu": mu, "nu": nu,
                                              "count": count_inc}


def per_leaf_ema(ema, new_gen, d):
    return steps.tree_map(lambda e, p: d * e + (1.0 - d) * p, ema, new_gen)


class TestMultiTensorAdam:
    @pytest.mark.parametrize("grad_clip,schedule", [
        (0.0, "constant"), (0.0, "cosine"), (0.5, "linear"), (1e4, "cosine")])
    def test_equals_per_leaf_bit_for_bit(self, grad_clip, schedule):
        cfg = _cfg(grad_clip=grad_clip, lr_schedule=schedule,
                   warmup_steps=1, max_steps=10)
        opt = steps.make_optimizer(cfg)
        params = steps.init_train_state(cfg, device="cpu")["params"]["gen"]
        state_a = state_b = opt.init(params)
        pa = pb = params
        gen = torch.Generator().manual_seed(0)
        for _ in range(3):
            grads = steps.tree_map(lambda p: torch.randn(
                p.shape, generator=gen) * 0.3, params)
            pa, state_a = opt.step(pa, grads, state_a)
            pb, state_b = per_leaf_adam_step(opt, pb, grads, state_b)
        _assert_same({"p": pa, "s": state_a}, {"p": pb, "s": state_b})
        assert int(state_a["count"]) == 3
        # the updates moved every leaf
        for a, p in zip(steps.tree_leaves(pa), steps.tree_leaves(params)):
            assert not torch.equal(a, p)

    @pytest.mark.parametrize("decay", [0.0, 0.9])
    def test_ema_equals_per_leaf(self, decay):
        cfg = _cfg(g_ema_decay=decay)
        fns = steps.make_train_step(cfg)
        state = fns.init(seed=1, device="cpu")
        gen = torch.Generator().manual_seed(1)
        for i in range(2):
            images = torch.rand((BATCH, 16, 16, 3), generator=gen) * 2 - 1
            z = torch.rand((BATCH, 8), generator=gen) * 2 - 1
            new, _ = fns.train_step(state, images, z)
            _assert_same(new["ema_gen"], per_leaf_ema(
                state["ema_gen"], new["params"]["gen"], decay))
            state = new


# ---------------------------------------------------------------------------
# steps_per_call: validation, the runner through the trainer, the plan
# ---------------------------------------------------------------------------

# the JAX cadences the port does not have, off
JAX_ONLY_CADENCES = dict(nan_check_steps=0)


@pytest.mark.parametrize("kw,valid", [
    (dict(steps_per_call=0), False),
    (dict(steps_per_call=-2), False),
    (dict(steps_per_call=3), False),              # save_model_steps 1000
    (dict(steps_per_call=4, log_every_steps=3), False),
    (dict(steps_per_call=4, sample_every_steps=6, save_model_steps=0),
     False),
    (dict(steps_per_call=8, log_every_steps=3, sample_every_steps=12,
          save_model_steps=0), False),
    (dict(steps_per_call=4, log_every_steps=2, sample_every_steps=8), True),
    (dict(steps_per_call=5, save_model_steps=0, sample_every_steps=0,
          log_every_steps=1), True),
])
def test_steps_per_call_validation_matches_jax(kw, valid):
    def outcome(make):
        try:
            make()
        except ValueError as e:
            return str(e)
        return None

    from dcgan_tpu.config import TrainConfig as JTrainConfig

    port = outcome(lambda: TrainConfig(**kw))
    assert port == outcome(lambda: JTrainConfig(**kw, **JAX_ONLY_CADENCES))
    assert (port is None) == valid


def _eager_states(cfg, batches_of_step):
    """The eager train_steps from the seeded init, step s on the feed's
    batch batches_of_step[s] and the trainer's z of step s."""
    fns = steps.make_train_step(cfg)
    state = fns.init(seed=cfg.seed, device="cpu")
    feed = trainer._synthetic_feed(cfg, torch.device("cpu"))
    batches = [next(feed) for _ in range(max(batches_of_step) + 1)]
    for s, b in enumerate(batches_of_step):
        state, _ = fns.train_step(state, batches[b],
                                  trainer.step_inputs(
                                      cfg, s, torch.device("cpu"))[0])
    return state


def _events(directory):
    with open(os.path.join(directory, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


class TestRunner:
    def test_k4_over_8_steps_equals_eager(self, tmp_path):
        cfg = _cfg(tmp_path, steps_per_call=4, sample_every_steps=4)
        state = trainer.train(cfg, synthetic_data=True, max_steps=8,
                              device="cpu")
        _assert_same(state, _eager_states(cfg, list(range(8))))
        # the warm-up step, single steps to the K boundary, one call of 4;
        # the held-out loss probe with each sample grid
        scalars = [e for e in _events(cfg.checkpoint_dir)
                   if e["kind"] == "scalars"]
        assert [e["step"] for e in scalars
                if "d_loss" in e["values"]] == [1, 2, 3, 4, 8]
        assert [e["step"] for e in scalars
                if "sample/d_loss" in e["values"]] == [4, 8]
        assert sorted(os.listdir(cfg.sample_dir)) == [
            "train_00000004.png", "train_00000008.png"]

    def test_resume_at_5_realigns_and_equals_eager(self, tmp_path):
        cfg = _cfg(tmp_path, steps_per_call=4)
        trainer.train(cfg, synthetic_data=True, max_steps=5, device="cpu")
        state = trainer.train(cfg, synthetic_data=True, max_steps=12,
                              device="cpu")
        # the synthetic stream restarts at batch 0 on a resume
        _assert_same(state, _eager_states(
            cfg, [0, 1, 2, 3, 4] + list(range(7))))
        assert [e["step"] for e in _events(cfg.checkpoint_dir)
                if e["kind"] == "scalars"] == [1, 2, 3, 4, 5, 6, 7, 8, 12]

    def test_load_copies_into_the_static_state(self):
        cfg = _cfg(steps_per_call=2)
        fns = steps.make_train_step(cfg)
        state = fns.init(seed=0, device="cpu")
        ptrs = [t.data_ptr() for t in steps.tree_leaves(state)]
        runner = warmup.StepRunner(fns, state, cfg, torch.device("cpu"))
        other = fns.init(seed=7, device="cpu")
        runner.load(other)
        assert runner.state is state
        assert [t.data_ptr() for t in steps.tree_leaves(state)] == ptrs
        _assert_same(state, other)
        with pytest.raises(RuntimeError, match="warm-up"):
            runner.capture("train_step")
        with pytest.raises(ValueError, match="warm-up is one step"):
            runner.step([torch.zeros(BATCH, 16, 16, 3)] * 2,
                        [torch.zeros(BATCH, 8)] * 2)

    def test_close_releases_programs_and_recaptures(self):
        cfg = _cfg()
        fns = steps.make_train_step(cfg)
        runner = warmup.StepRunner(fns, fns.init(seed=0, device="cpu"),
                                   cfg, torch.device("cpu"))
        feed = trainer._synthetic_feed(cfg, torch.device("cpu"))
        batches = [next(feed) for _ in range(3)]
        zs = [trainer.step_inputs(cfg, s, torch.device("cpu"))[0]
              for s in range(3)]
        runner.step(batches[:1], zs[:1])
        runner.step(batches[1:2], zs[1:2])
        prog = runner.programs["train_step"]
        runner.close()
        assert runner.programs == {}
        assert prog.fn is None and prog.outputs is None
        with pytest.raises(RuntimeError, match="not captured"):
            prog.run()
        # the next call captures its row again and the steps go on
        runner.step(batches[2:3], zs[2:3])
        assert sorted(runner.programs) == ["train_step"]
        _assert_same(runner.state, _eager_states(cfg, [0, 1, 2]))

    def test_train_closes_its_runner(self, tmp_path, monkeypatch):
        closed = []
        close = warmup.StepRunner.close

        def recording_close(runner):
            closed.append(sorted(runner.programs))
            close(runner)
        monkeypatch.setattr(warmup.StepRunner, "close", recording_close)
        cfg = _cfg(tmp_path)
        trainer.train(cfg, synthetic_data=True, max_steps=2, device="cpu")
        assert closed == [["train_step"]]

    @pytest.mark.parametrize("spc,sample_every", [(1, 0), (1, 4), (2, 0),
                                                  (4, 8)])
    def test_plan_rows_equal_jax(self, tmp_path, spc, sample_every):
        import jax

        from dcgan_tpu.config import ModelConfig as JModelConfig
        from dcgan_tpu.config import TrainConfig as JTrainConfig
        from dcgan_tpu.parallel import make_mesh, make_parallel_train
        from dcgan_tpu.train import warmup as jwarmup
        from torch_jax_draws import numpy_init

        kw = dict(steps_per_call=spc, sample_every_steps=sample_every,
                  log_every_steps=1, save_model_steps=0)
        jcfg = JTrainConfig(model=JModelConfig(**MODEL), batch_size=8,
                            activation_summary_steps=0, **kw,
                            **{k: v for k, v in JAX_ONLY_CADENCES.items()
                               if k != "activation_summary_steps"})
        pt = make_parallel_train(jcfg, make_mesh(jcfg.mesh))
        z = jax.random.uniform(jax.random.key(1), (8, MODEL["z_dim"]))
        # the plan only passes the state along: numpy_init's tree, not
        # JAX's compiled init
        plan, _ = jwarmup.build_warmup_plan(
            jcfg, pt, numpy_init(lambda key: pt.init(key)),
            sample_z=z if jcfg.sample_every_steps else None)
        jax_rows = [n for n, _, _ in plan if n != "state_copy"]
        cfg = _cfg(**kw)
        assert warmup.build_warmup_plan(
            cfg, sample=bool(cfg.sample_every_steps)) == jax_rows

    def test_aot_warmup_writes_compile_rows(self, tmp_path):
        cfg = _cfg(tmp_path, steps_per_call=2, aot_warmup=True,
                   sample_every_steps=2)
        trainer.train(cfg, synthetic_data=True, max_steps=3, device="cpu")
        events = _events(cfg.checkpoint_dir)
        compile_rows = [e for e in events if any(
            k.startswith("perf/compile_ms/") for k in e.get("values", {}))]
        assert len(compile_rows) == 1 and compile_rows[0]["step"] == 1
        assert sorted(compile_rows[0]["values"]) == sorted(
            f"perf/compile_ms/{r}" for r in
            ("train_step", "multi_step@k2", "sampler"))


def test_step_timer_spreads_calls_as_jax():
    from dcgan_tpu.utils.profiling import StepTimer as JStepTimer

    port, ref = StepTimer(images_per_step=4), JStepTimer(images_per_step=4)
    for now, k, host in ((0.0, 1, 0.0), (0.5, 1, 0.01), (2.5, 4, 0.2),
                         (4.0, 4, 0.0), (4.3, 1, 0.05)):
        for t in (port, ref):
            t.note_host(host)
            t.tick(now, steps=k)
    assert port.summary() == pytest.approx(ref.summary())
    assert port.summary()["perf/step_ms_mean"] == pytest.approx(
        (0.5 + 2.0 + 1.5 + 0.3) / 10 * 1e3)


def test_served_rungs_report_captures(tmp_path):
    from dcgan_tpu_torch.models.dcgan import generator_init
    from dcgan_tpu_torch.serve import __main__ as serve_main

    mcfg = ModelConfig(**MODEL)
    params, bn = generator_init(mcfg, seed=0, device="cpu")
    path = convert.save_weights(str(tmp_path / "g.npz"), mcfg, params, bn)
    row, responses = serve_main.run([
        "--weights", path, "--device", "cpu", "--max_batch", "4",
        "--demo_requests", "3", "--demo_rps", "500",
        "--demo_max_images", "3"])
    assert row["completed"] == 3
    assert sorted(k for k in row if k.startswith("serve/compile_ms/")) == [
        f"serve/compile_ms/sampler@b{b}" for b in (1, 2, 4)]
    assert row["serve/recompiles_after_warmup"] == 0
    for r in responses:
        assert np.isfinite(r.result(timeout=30)).all()


# ---------------------------------------------------------------------------
# the captures, on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs exist only on the card")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    # f32 without TF32, and cuDNN's deterministic algorithms, so that two
    # eager runs agree and the comparison sees the capture alone
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = saved
