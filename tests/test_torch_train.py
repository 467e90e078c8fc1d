"""The port's training step against `dcgan_tpu`'s on the CPU.

Both packages start from the same state (the JAX package's
`init_train_state`, carried over with `convert.train_state_from_jax`) and
take 4 steps on the same numpy images. The JAX step draws z from its key;
the test recomputes that z with JAX (`split(key)` then `uniform(z_key)`) and
hands it to the port's `train_step`. JAX runs jitted, its Pallas kernels in
interpret mode; the port runs its kernels' plain versions.

Tolerances (f32):
- losses at every step: 1e-5 (summation order only; they agree to ~1e-7);
- every leaf of params, bn, opt (mu, nu, count) and ema_gen after step 4:
  1e-5 abs + 1e-5 rel, except the biases that feed a BatchNorm and the
  running means they shift: their true gradient is 0 (BN subtracts the
  batch mean), so Adam's normalized step follows the sign of f32 rounding
  noise, and those leaves are held to Adam's own bound, 2 * lr * steps.
bf16 (fused routing): losses 3e-3 at every step; each weight's 4-step
update (p4 - p0) within 15 % of JAX's in norm; BN running variances within
1e-4 of their largest value.
"""

import dataclasses
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcgan_tpu.config import ModelConfig as JModelConfig
from dcgan_tpu.config import TrainConfig as JTrainConfig
from dcgan_tpu.data.synthetic import synthetic_batches as j_synthetic
from dcgan_tpu.presets import celeba64 as j_celeba64
from dcgan_tpu.train import steps as jsteps
from dcgan_tpu.utils.profiling import StepTimer as JStepTimer
from dcgan_tpu_torch import convert
from dcgan_tpu_torch.config import ModelConfig, TrainConfig
from dcgan_tpu_torch.data.synthetic import synthetic_batches
from dcgan_tpu_torch.presets import celeba64
from dcgan_tpu_torch.train import cli, steps
from dcgan_tpu_torch.train.trainer import METRIC_KEYS

ROUTES = {"plain": {},
          "use_pallas": {"use_pallas": True},
          "fused": {"use_pallas": True, "pallas_fused": True}}
STEPS = 4
BATCH = 4
LR = 2e-4
# leaves whose gradient is 0 in exact arithmetic (see the module docstring)
PRE_BN = re.compile(r"(proj|deconv[1-9]|conv[1-9])/b$|bn[0-9]+/mean$")
TRAIN_FIELDS = [f.name for f in dataclasses.fields(TrainConfig)]


def _model_kw(route, dtype):
    return dict(output_size=16, gf_dim=8, df_dim=8, z_dim=8,
                compute_dtype=dtype, **ROUTES[route])


def _run_both(route, dtype="float32", update_mode="sequential"):
    """(per-step JAX losses, per-step port losses, JAX state, port state,
    JAX initial params) after STEPS steps from one state."""
    mk = _model_kw(route, dtype)
    jcfg = JTrainConfig(model=JModelConfig(**mk), batch_size=BATCH,
                        update_mode=update_mode)
    tcfg = TrainConfig(model=ModelConfig(**mk), batch_size=BATCH,
                       update_mode=update_mode)
    jfns = jsteps.make_train_step(jcfg)
    jstate = jfns.init(jax.random.key(0))
    init_params = jax.device_get(jstate["params"])
    tstate = convert.train_state_from_jax(jax.device_get(jstate),
                                          device="cpu")
    jstep = jax.jit(jfns.train_step)
    tstep = steps.make_train_step(tcfg).train_step
    rng = np.random.default_rng(1)
    jl, tl = [], []
    for i in range(STEPS):
        images = np.tanh(rng.normal(size=(BATCH, 16, 16, 3))).astype(
            np.float32)
        key = jax.random.fold_in(jax.random.key(5), i)
        z_key, _ = jax.random.split(key)
        z = np.array(jax.random.uniform(z_key, (BATCH, 8), minval=-1.0,
                                        maxval=1.0, dtype=jnp.float32))
        jstate, jm = jstep(jstate, jnp.asarray(images), key)
        tstate, tm = tstep(tstate, torch.from_numpy(images),
                           torch.from_numpy(z))
        jl.append({k: float(jm[k]) for k in METRIC_KEYS})
        tl.append({k: float(tm[k]) for k in METRIC_KEYS})
    return jl, tl, jax.device_get(jstate), tstate, init_params


def _flat_state(state_t):
    """{path: numpy} over params, bn, opt and ema_gen of a port state."""
    out = {}
    for group in ("params", "bn", "ema_gen"):
        for k, v in convert.flatten(state_t[group]).items():
            out[f"{group}/{k}"] = v.numpy()
    for net in ("gen", "disc"):
        for m in ("mu", "nu"):
            for k, v in convert.flatten(state_t["opt"][net][m]).items():
                out[f"opt/{net}/{m}/{k}"] = v.numpy()
        out[f"opt/{net}/count"] = state_t["opt"][net]["count"].numpy()
    out["step"] = state_t["step"].numpy()
    return out


def _assert_f32_trajectory(jl, tl, jstate, tstate):
    for j, t in zip(jl, tl):
        for k in METRIC_KEYS:
            assert abs(j[k] - t[k]) <= 1e-5, (k, j[k], t[k])
    want = _flat_state(convert.train_state_from_jax(jstate, device="cpu"))
    got = _flat_state(tstate)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if PRE_BN.search(path):
            bound = 2 * LR * STEPS
        else:
            bound = 1e-5 + 1e-5 * np.abs(w).max()
        err = float(np.abs(g.astype(np.float64) - w).max())
        assert err <= bound, (path, err, bound)


class TestTrajectory:
    @pytest.mark.parametrize("route", sorted(ROUTES))
    def test_matches_jax_f32(self, route):
        _assert_f32_trajectory(*_run_both(route)[:4])

    def test_fused_update_mode_matches_jax(self):
        """update_mode="fused": both nets' gradients at the pre-update
        params, on the kernel routing."""
        _assert_f32_trajectory(*_run_both("fused",
                                          update_mode="fused")[:4])

    def test_grads_are_the_fused_update_modes(self):
        """`grads` returns the gradients that the "fused" update mode
        applies (pinned against JAX above): Adam over them gives that
        step's params bit for bit, and the losses are the step's."""
        cfg = TrainConfig(model=ModelConfig(**_model_kw("fused", "float32")),
                          batch_size=BATCH, update_mode="fused")
        fns = steps.make_train_step(cfg)
        state = fns.init(seed=0, device="cpu")
        rng = np.random.default_rng(2)
        images = torch.from_numpy(np.tanh(rng.normal(
            size=(BATCH, 16, 16, 3))).astype(np.float32))
        z = torch.from_numpy(rng.uniform(-1.0, 1.0, size=(BATCH, 8)).astype(
            np.float32))
        grads, g_metrics = fns.grads(state, images, z)
        new_state, s_metrics = fns.train_step(state, images, z)
        for net, lr in (("gen", cfg.g_learning_rate),
                        ("disc", cfg.d_learning_rate)):
            want, _ = steps.make_optimizer(cfg, lr).step(
                state["params"][net], grads[net], state["opt"][net])
            got = convert.flatten(new_state["params"][net])
            for path, w in convert.flatten(want).items():
                assert torch.equal(got[path], w), (net, path)
        assert {k: float(v) for k, v in g_metrics.items()} == \
            {k: float(v) for k, v in s_metrics.items()}

    def test_bf16_matches_jax(self):
        jl, tl, jstate, tstate, p0 = _run_both("fused", "bfloat16")
        for j, t in zip(jl, tl):
            for k in METRIC_KEYS:
                assert abs(j[k] - t[k]) <= 3e-3, (k, j[k], t[k])
        f0 = convert.flatten(p0)
        fj = convert.flatten(jstate["params"])
        ft = {k: v.numpy() for k, v in
              convert.flatten(tstate["params"]).items()}
        for path in f0:
            if path.endswith("/w"):
                a, b = fj[path] - f0[path], ft[path] - f0[path]
                rel = np.linalg.norm(a - b) / np.linalg.norm(a)
                assert rel <= 0.15, (path, rel)
        for net in ("gen", "disc"):
            for name, s in tstate["bn"][net].items():
                w = np.asarray(jstate["bn"][net][name]["var"])
                err = np.abs(s["var"].numpy() - w).max()
                assert err <= 1e-4 * np.abs(w).max(), (net, name, err)


class TestOptimizer:
    @pytest.mark.parametrize("schedule,warmup", [
        ("constant", 0), ("linear", 0), ("cosine", 0), ("cosine", 3),
        ("linear", 2)])
    def test_lr_schedule_matches_optax(self, schedule, warmup):
        kw = dict(lr_schedule=schedule, warmup_steps=warmup, max_steps=10)
        jfn = jsteps.make_lr_schedule(JTrainConfig(**kw), 2e-4)
        tfn = steps.make_lr_schedule(TrainConfig(**kw), 2e-4)
        for count in (0, 1, 2, 5, 9, 10, 12):
            got = float(tfn(torch.tensor(count, dtype=torch.int32)))
            want = float(jfn(jnp.int32(count)))
            assert abs(got - want) <= 1e-6 * 2e-4, (count, got, want)

    @pytest.mark.parametrize("grad_clip", [0.0, 0.5])
    def test_adam_matches_optax(self, grad_clip):
        """Three updates of a small tree, f32: params and moments 1e-6 of
        their scale (the same arithmetic in the same order)."""
        rng = np.random.default_rng(3)
        params = {"a": {"w": rng.normal(size=(4, 3)).astype(np.float32)},
                  "b": rng.normal(size=(5,)).astype(np.float32)}
        jcfg = JTrainConfig(grad_clip=grad_clip)
        opt = jsteps.make_optimizer(jcfg)
        adam = steps.make_optimizer(TrainConfig(grad_clip=grad_clip))
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        jstate = opt.init(jp)
        tp = convert._to_torch(params, torch.device("cpu"))
        tstate = adam.init(tp)
        for i in range(3):
            g = jax.tree_util.tree_map(
                lambda x: (rng.normal(size=x.shape) * (i + 1)).astype(
                    np.float32), params)
            updates, jstate = opt.update(
                jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
            jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, updates)
            tp, tstate = adam.step(tp, convert._to_torch(
                g, torch.device("cpu")), tstate)
        adam_j = jstate[1][0]
        for got, want in ((tp, jp), (tstate["mu"], adam_j.mu),
                          (tstate["nu"], adam_j.nu)):
            for (k, a), b in zip(convert.flatten(got).items(),
                                 convert.flatten(
                                     jax.device_get(want)).values()):
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                           atol=1e-9)
        assert int(tstate["count"]) == int(adam_j.count) == 3

    def test_train_state_from_jax(self):
        cfg = JTrainConfig(model=JModelConfig(output_size=16, gf_dim=8,
                                              df_dim=8, z_dim=8))
        js = jax.device_get(jsteps.init_train_state(jax.random.key(0), cfg))
        ts = convert.train_state_from_jax(js, device="cpu")
        port = steps.init_train_state(TrainConfig(model=ModelConfig(
            output_size=16, gf_dim=8, df_dim=8, z_dim=8)), device="cpu")
        flat = _flat_state(ts)
        assert sorted(flat) == sorted(_flat_state(port))
        np.testing.assert_array_equal(
            flat["params/gen/deconv1/w"],
            np.asarray(js["params"]["gen"]["deconv1"]["w"]))
        assert int(ts["step"]) == 0 and ts["step"].dtype == torch.int32
        assert int(ts["opt"]["disc"]["count"]) == 0


class TestConfig:
    def test_fields_and_defaults_equal_jax(self):
        jt = JTrainConfig()
        for name in TRAIN_FIELDS:
            if name != "model":
                assert getattr(TrainConfig(), name) == getattr(jt, name), \
                    name
        assert dataclasses.asdict(TrainConfig().model) == \
            dataclasses.asdict(jt.model)

    def test_celeba64_preset_equals_jax(self):
        jt = j_celeba64()
        t = celeba64()
        for name in TRAIN_FIELDS:
            if name != "model":
                assert getattr(t, name) == getattr(jt, name), name
        assert dataclasses.asdict(t.model) == dataclasses.asdict(jt.model)

    @pytest.mark.parametrize("make,match", [
        (lambda: TrainConfig(loss="wgan-gp",
                             model=ModelConfig(use_pallas=True)),
         "second derivative"),
        (lambda: TrainConfig(r1_gamma=10.0, model=ModelConfig(
            use_pallas=True, pallas_fused=True)), "second derivative"),
        (lambda: TrainConfig(r1_gamma=1.0, model=ModelConfig(
            use_pallas=True, bn_pallas=False, attn_res=32)),
         "second derivative"),
        (lambda: ModelConfig(arch="resnet"), "not ported"),
        (lambda: ModelConfig(arch="stylegan", num_classes=10),
         "not ported")])
    def test_unserved_fields_raise(self, make, match):
        """What the port does not train: a penalty on a kernel route (the
        JAX package cannot differentiate a Pallas kernel twice), another
        arch (with or without class conditioning, which the DCGAN stacks
        have)."""
        with pytest.raises(NotImplementedError, match=match):
            make()

    @pytest.mark.parametrize("kw", [
        {"loss": "wgan-gp"}, {"n_critic": 5}, {"grad_accum": 2},
        {"precision": "bf16"}, {"diffaug": "color"},
        {"precision": "fp8"}, {"r1_gamma": 10.0, "r1_interval": 4},
        {"loss": "hinge", "n_critic": 2, "grad_accum": 4,
         "diffaug": "color,translation,cutout", "precision": "bf16",
         "model": "fused"}])
    def test_served_fields_equal_jax(self, tmp_path, kw):
        """The settings of the penalty slice construct in the port, equal
        to the JAX package's normalized config, and each package's
        config.json loads in the other."""
        if kw.get("model") == "fused":
            kw = dict(kw)
            del kw["model"]
            jt = JTrainConfig(model=JModelConfig(
                use_pallas=True, pallas_fused=True), **kw)
            t = TrainConfig(model=ModelConfig(
                use_pallas=True, pallas_fused=True), **kw)
        else:
            jt, t = JTrainConfig(**kw), TrainConfig(**kw)
        for name in TRAIN_FIELDS:
            if name != "model":
                assert getattr(t, name) == getattr(jt, name), name
        assert dataclasses.asdict(t.model) == dataclasses.asdict(jt.model)
        from dcgan_tpu import config as j_config
        from dcgan_tpu_torch import config as t_config

        t_config.save_config(t, str(tmp_path / "port"))
        assert j_config.load_config(str(tmp_path / "port")) == jt
        j_config.save_config(jt, str(tmp_path / "jax"))
        assert t_config.load_config(str(tmp_path / "jax")) == t

    @pytest.mark.parametrize("kw", [
        {"loss": "l2"}, {"update_mode": "both"}, {"grad_clip": -1.0},
        {"label_smoothing": 0.5}, {"g_ema_decay": 1.0},
        {"lr_schedule": "step"}, {"warmup_steps": 10, "max_steps": 10},
        {"precision": "fp16"}, {"batch_size": 6, "grad_accum": 4},
        {"r1_gamma": -1.0}, {"r1_gamma": 1.0, "loss": "wgan-gp"},
        {"r1_interval": 0}, {"r1_interval": 4}, {"diffaug": "flip"},
        {"n_critic": 2, "update_mode": "fused"},
        {"model": "quant"}])
    def test_jax_validation_kept(self, kw):
        if kw.get("model") == "quant":
            # model.quant set without the precision policy
            with pytest.raises(ValueError, match="precision policy"):
                JTrainConfig(model=JModelConfig(quant="fp8"))
            with pytest.raises(ValueError, match="precision policy"):
                TrainConfig(model=ModelConfig(quant="fp8"))
            return
        with pytest.raises(ValueError):
            JTrainConfig(**kw)
        with pytest.raises(ValueError):
            TrainConfig(**kw)

    def test_precision_f32_forces_the_model_dtypes(self):
        assert TrainConfig(precision="f32").model.compute_dtype == "float32"
        assert JTrainConfig(precision="f32").model.compute_dtype == \
            "float32"


class TestDataAndTrainer:
    def test_synthetic_batches_equal_jax(self):
        a, b = synthetic_batches(4, 8, seed=7), j_synthetic(4, 8, seed=7)
        for _ in range(3):
            np.testing.assert_array_equal(next(a), next(b))

    def test_cli_writes_jax_event_format(self, tmp_path):
        """Two steps through `python -m dcgan_tpu_torch.train`'s entry
        point on the CPU: events.jsonl has one scalars event per step in
        the JAX package's format, with its loss keys and, once the timer
        has two ticks, exactly the JAX StepTimer's perf/* keys."""
        state = cli.main([
            "--preset", "celeba64", "--synthetic", "--max_steps", "2",
            "--device", "cpu", "--output_size", "16", "--gf_dim", "8",
            "--df_dim", "8", "--z_dim", "8", "--batch_size", "4",
            "--use_pallas", "--pallas_fused",
            "--checkpoint_dir", str(tmp_path)])
        assert int(state["step"]) == 2
        events = [json.loads(line) for line in
                  (tmp_path / "events.jsonl").read_text().splitlines()]
        assert [e["step"] for e in events] == [1, 2]
        timer = JStepTimer(images_per_step=4)
        for t in (0.0, 1.0):
            timer.tick(t)
        perf_keys = set(timer.summary())
        for e in events:
            assert set(e) == {"kind", "step", "time", "values"}
            assert e["kind"] == "scalars" and isinstance(e["time"], float)
            assert all(np.isfinite(v) for v in e["values"].values())
        assert set(events[0]["values"]) == set(METRIC_KEYS)
        assert set(events[1]["values"]) == set(METRIC_KEYS) | perf_keys

    def test_cli_needs_synthetic(self, tmp_path):
        """Without --synthetic the trainer reads --data_dir's TFRecord
        shards (the default data_dir, "train", when none is given): an
        empty directory fails and names it."""
        with pytest.raises(FileNotFoundError,
                           match=f"no TFRecord shards in {tmp_path}"):
            cli.main(["--max_steps", "1", "--device", "cpu", "--data_dir",
                      str(tmp_path), "--checkpoint_dir",
                      str(tmp_path / "run")])

    def test_flags_override_the_preset(self):
        args = cli.build_parser().parse_args(
            ["--batch_size", "8", "--use_pallas", "--update_mode", "fused",
             "--synthetic"])
        cfg = cli.config_from_args(args)
        assert cfg.batch_size == 8 and cfg.update_mode == "fused"
        assert cfg.model.use_pallas and not cfg.model.pallas_fused
        assert cfg.max_steps == celeba64().max_steps
