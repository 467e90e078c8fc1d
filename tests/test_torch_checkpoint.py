"""The port's checkpoints on the CPU: the Checkpointer's integrity contract
(round trip, quarantine and fallback, retention, asynchronous saves), resume
through `train(..., device="cpu")`, the command-line run from TFRecords and
its serving, and checkpoints that load in both packages:

- port -> JAX: the port's trainer checkpoint grafted into the JAX state
  (`tools/export_torch_checkpoint.py::port_to_jax_state`), then one JAX
  `train_step` and one port step on the same images and z, and both
  samplers on the grafted state, within the tolerances of
  tests/test_torch_train.py (losses
  1e-5; every leaf 1e-5 + 1e-5 of its scale, the biases that feed a
  BatchNorm and the running means they shift 2 * lr per step) and
  tests/test_torch_models.py (f32 images 1e-4);
- JAX -> port: an Orbax checkpoint of the JAX Checkpointer, exported by the
  tool, restores in the port bit for bit equal to
  `convert.train_state_from_jax` of the JAX state.

The tiny SAGAN's port -> JAX case is tests/test_torch_checkpoint_sagan.py
(one JAX train_step compile per file).
"""

import dataclasses
import importlib.util
import json
import os
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dcgan_tpu import config as j_config
from dcgan_tpu.config import ModelConfig as JModelConfig
from dcgan_tpu.config import TrainConfig as JTrainConfig
from dcgan_tpu.train import steps as jsteps
from dcgan_tpu.utils.checkpoint import Checkpointer as JCheckpointer
from dcgan_tpu_torch import config, convert
from dcgan_tpu_torch.config import ModelConfig, TrainConfig
from dcgan_tpu_torch.data.synthetic import write_image_tfrecords
from dcgan_tpu_torch.models.dcgan import sampler_apply
from dcgan_tpu_torch.serve import __main__ as serve_main
from dcgan_tpu_torch.train import cli, steps, trainer
from dcgan_tpu_torch.utils.checkpoint import Checkpointer

ROOT = pathlib.Path(__file__).resolve().parent.parent
MODEL = dict(output_size=16, gf_dim=8, df_dim=8, z_dim=8,
             compute_dtype="float32")
BATCH = 4
LR = 2e-4
PRE_BN = re.compile(r"(proj|deconv[1-9]|conv[1-9])/b$|bn[0-9]+/mean$")
CLI_SMALL = ["--device", "cpu", "--output_size", "16", "--gf_dim", "8",
             "--df_dim", "8", "--z_dim", "8", "--batch_size", "4"]


def _tool():
    spec = importlib.util.spec_from_file_location(
        "export_torch_checkpoint",
        ROOT / "tools" / "export_torch_checkpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cfg(tmp_path, **kw):
    return TrainConfig(model=ModelConfig(**MODEL), batch_size=BATCH,
                       checkpoint_dir=str(tmp_path / "run"),
                       sample_dir=str(tmp_path / "samples"), **kw)


def _state(seed=0):
    """A tiny training state whose every leaf differs from its init."""
    state = steps.init_train_state(TrainConfig(model=ModelConfig(**MODEL)),
                                   seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    flat = convert.flatten(state)
    for k, v in flat.items():
        if v.dtype == torch.float32:
            flat[k] = v + torch.randn(v.shape, generator=gen)
    flat["opt/gen/count"] = torch.tensor(7, dtype=torch.int32)
    flat["step"] = torch.tensor(7, dtype=torch.int32)
    return convert.unflatten(flat)


def _template():
    return steps.init_train_state(TrainConfig(model=ModelConfig(**MODEL)),
                                  device="cpu")


def _assert_same(a, b):
    fa, fb = convert.flatten(a), convert.flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


# ---------------------------------------------------------------------------
# the Checkpointer
# ---------------------------------------------------------------------------

class TestCheckpointer:
    def test_round_trip_bit_for_bit(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        state = _state()
        ck.save(7, state)
        ck.wait()
        assert sorted(os.listdir(tmp_path)) == ["7", "integrity"]
        manifest = json.loads((tmp_path / "integrity" / "7.json").read_text())
        assert manifest["step"] == 7 and set(manifest["files"]) == \
            {"state.npz"}
        stats = ck.last_save_stats
        assert stats["bytes"] == manifest["files"]["state.npz"]["size"]
        assert stats["save_ms"] >= stats["host_copy_ms"]
        restored = Checkpointer(str(tmp_path)).restore_latest(_template())
        _assert_same(restored, state)
        keys = set(np.load(tmp_path / "7" / "state.npz").files)
        assert {"params/gen/proj/w", "opt/disc/count", "step",
                "ema_gen/deconv1/w"} <= keys

    def test_no_checkpoint_restores_none(self, tmp_path):
        ck = Checkpointer(str(tmp_path / "empty"))
        assert ck.latest_step() is None
        assert ck.restore_latest(_template()) is None

    @pytest.mark.parametrize("damage", ["truncate", "flip_byte"])
    def test_damaged_newest_step_falls_back(self, tmp_path, damage):
        """A truncated file fails the stat pre-check, a flipped byte the
        CRC pass: the step becomes <step>.corrupt (its manifest kept) and
        the step before it is restored."""
        ck = Checkpointer(str(tmp_path))
        older, newer = _state(1), _state(2)
        ck.save(3, older)
        ck.save(5, newer)
        ck.wait()
        path = tmp_path / "5" / "state.npz"
        raw = bytearray(path.read_bytes())
        if damage == "truncate":
            raw = raw[:len(raw) // 2]
        else:
            raw[len(raw) // 2] ^= 0x01
        path.write_bytes(bytes(raw))
        restored = ck.restore_latest(_template())
        _assert_same(restored, older)
        assert sorted(os.listdir(tmp_path)) == ["3", "5.corrupt",
                                                "integrity"]
        assert (tmp_path / "integrity" / "5.json").exists()
        assert ck.latest_step() == 3

    def test_step_without_manifest_is_trusted(self, tmp_path):
        ck = Checkpointer(str(tmp_path), async_save=False)
        state = _state()
        ck.save(2, state)
        os.remove(tmp_path / "integrity" / "2.json")
        _assert_same(ck.restore_latest(_template()), state)
        assert ck.last_restore_stats["verify_ms"] == 0.0

    def test_shape_mismatch_raises_and_keeps_the_step(self, tmp_path):
        ck = Checkpointer(str(tmp_path), async_save=False)
        ck.save(4, _state())
        wide = steps.init_train_state(TrainConfig(model=ModelConfig(
            **dict(MODEL, gf_dim=16))), device="cpu")
        with pytest.raises(ValueError, match="the state wants"):
            ck.restore_latest(wide)
        assert sorted(os.listdir(tmp_path)) == ["4", "integrity"]

    def test_max_to_keep(self, tmp_path):
        ck = Checkpointer(str(tmp_path), max_to_keep=2)
        for s in (1, 2, 3, 4):
            ck.save(s, _state(s))
        ck.wait()
        assert sorted(os.listdir(tmp_path)) == ["3", "4", "integrity"]
        assert sorted(os.listdir(tmp_path / "integrity")) == ["3.json",
                                                              "4.json"]

    def test_async_save_then_wait(self, tmp_path):
        """save() returns before the file is written; the bytes are those
        of the state passed in, whatever the caller does next; wait()
        leaves the step on disk with its manifest."""
        ck = Checkpointer(str(tmp_path))
        state = _state(3)
        ck.save(9, state)
        assert ck._writer is not None
        expected = convert.unflatten({k: v.clone() for k, v in
                                      convert.flatten(state).items()})
        state["params"]["gen"]["proj"]["w"] = torch.zeros(1)
        ck.wait()
        assert ck._writer is None
        assert (tmp_path / "integrity" / "9.json").exists()
        _assert_same(ck.restore_latest(_template()), expected)
        with pytest.raises(FileExistsError):
            ck.save(9, expected)

    def test_maybe_save_is_throttled(self, tmp_path):
        ck = Checkpointer(str(tmp_path), save_interval_secs=3600.0)
        assert not ck.maybe_save(1, _state())
        ck = Checkpointer(str(tmp_path), save_interval_secs=0.0)
        assert ck.maybe_save(2, _state()) and ck.maybe_save(3, _state())
        ck.wait()
        assert ck.latest_step() == 3

    def test_resave_after_corrupt_gets_a_fresh_manifest(self, tmp_path):
        ck = Checkpointer(str(tmp_path), async_save=False)
        ck.save(1, _state(1))
        ck.save(2, _state(2))
        (tmp_path / "2" / "state.npz").write_bytes(b"short")
        ck.restore_latest(_template())
        assert (tmp_path / "2.corrupt").is_dir()
        state = _state(4)
        ck.save(2, state)
        _assert_same(ck.restore_latest(_template()), state)


# ---------------------------------------------------------------------------
# resume through the trainer
# ---------------------------------------------------------------------------

def _events(directory):
    return [json.loads(x) for x in
            (pathlib.Path(directory) / "events.jsonl").read_text()
            .splitlines()]


class TestResume:
    def test_second_run_continues_with_the_steps_z(self, tmp_path,
                                                   monkeypatch):
        """Two steps, then a second call to step 4: it restores step 2,
        its first step is step 3, and that step's z is the (seed, 2) rule's
        (the z of the step from state step 2 to 3), as in an unbroken
        run."""
        cfg = _cfg(tmp_path, seed=3)
        first = trainer.train(cfg, synthetic_data=True, max_steps=2,
                              device="cpu")
        restored = Checkpointer(cfg.checkpoint_dir).restore_latest(
            steps.init_train_state(cfg, device="cpu"))
        _assert_same(restored, first)
        drawn = []
        real = trainer.step_inputs

        def recording(c, step, device):
            z, draws = real(c, step, device)
            drawn.append((step, z))
            return z, draws

        monkeypatch.setattr(trainer, "step_inputs", recording)
        second = trainer.train(cfg, synthetic_data=True, max_steps=4,
                               device="cpu")
        assert int(second["step"]) == 4
        assert [s for s, _ in drawn] == [2, 3]
        assert torch.equal(drawn[0][1],
                           real(cfg, 2, torch.device("cpu"))[0])
        assert not torch.equal(drawn[0][1],
                               real(cfg, 3, torch.device("cpu"))[0])
        assert [e["step"] for e in _events(cfg.checkpoint_dir)] == \
            [1, 2, 3, 4]
        assert Checkpointer(cfg.checkpoint_dir).latest_step() == 4
        # one more call at the same target trains nothing
        again = trainer.train(cfg, synthetic_data=True, max_steps=4,
                              device="cpu")
        _assert_same(again, second)

    def test_other_architecture_raises(self, tmp_path):
        cfg = _cfg(tmp_path)
        trainer.train(cfg, synthetic_data=True, max_steps=1, device="cpu")
        wide = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, gf_dim=16))
        with pytest.raises(ValueError, match="different architecture"):
            trainer.train(wide, synthetic_data=True, max_steps=2,
                          device="cpu")

    def test_tfrecords_grid_and_events(self, tmp_path):
        """From TFRecord shards: a sample grid every 2 steps that decodes
        to [rows x 16, cols x 16, 3], an image event beside the scalars,
        a TensorBoard file, and the config.json the JAX package loads."""
        data = tmp_path / "data"
        write_image_tfrecords(str(data), num_examples=32, image_size=16,
                              num_shards=2)
        cfg = _cfg(tmp_path, data_dir=str(data), shuffle_buffer=8,
                   num_loader_threads=2, sample_every_steps=2,
                   sample_grid=(2, 3))
        state = trainer.train(cfg, max_steps=2, device="cpu")
        grid = np.asarray(Image.open(tmp_path / "samples" /
                                     "train_00000002.png"))
        # the sampler's images of the fixed z (64 rows from seed + 1)
        sample_z = torch.rand((64, 8), generator=torch.Generator()
                              .manual_seed(cfg.seed + 1)) * 2.0 - 1.0
        imgs = sampler_apply(state["params"]["gen"], state["bn"]["gen"],
                             sample_z, cfg=cfg.model).numpy()[:6]
        want = np.clip((imgs + 1.0) / 2.0 * 255.0, 0, 255).astype(np.uint8)
        want = want.reshape(2, 3, 16, 16, 3).transpose(0, 2, 1, 3, 4)
        np.testing.assert_array_equal(grid, want.reshape(32, 48, 3))
        kinds = [(e["kind"], e["step"]) for e in _events(cfg.checkpoint_dir)]
        assert kinds == [("scalars", 1), ("scalars", 2), ("image", 2)]
        assert any(p.name.startswith("events.out.tfevents.")
                   for p in pathlib.Path(cfg.checkpoint_dir).iterdir())
        jcfg = j_config.load_config(cfg.checkpoint_dir)
        assert jcfg.sample_grid == (2, 3) and jcfg.data_dir == str(data)
        assert dataclasses.asdict(jcfg.model) == dataclasses.asdict(
            cfg.model)


class TestConfigFiles:
    def test_jax_config_loads_in_the_port(self, tmp_path):
        jcfg = JTrainConfig(model=JModelConfig(**MODEL), batch_size=BATCH,
                            sample_grid=(4, 2), save_model_secs=30.0,
                            nan_check_steps=7)
        j_config.save_config(jcfg, str(tmp_path))
        cfg = config.load_config(str(tmp_path))
        for f in dataclasses.fields(TrainConfig):
            if f.name != "model":
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        assert dataclasses.asdict(cfg.model) == dataclasses.asdict(
            jcfg.model)

    @pytest.mark.parametrize("kw", [
        {"progressive": "32:2,64:*"},
        {"model": JModelConfig(arch="resnet")},
        # pipeline_gd is ported; the rollback NaN policy is not
        {"nan_policy": "rollback"}])
    def test_unported_jax_settings_raise(self, tmp_path, kw):
        j_config.save_config(JTrainConfig(**kw), str(tmp_path))
        with pytest.raises(NotImplementedError, match="not ported"):
            config.load_config(str(tmp_path))

    @pytest.mark.parametrize("kw", [
        {"r1_gamma": 1.0}, {"loss": "wgan-gp"},
        {"r1_gamma": 10.0, "r1_interval": 4, "n_critic": 2,
         "grad_accum": 2, "diffaug": "color,cutout", "precision": "bf16"}])
    def test_jax_penalty_settings_load(self, tmp_path, kw):
        """Settings the port trains since it has the penalties, n_critic,
        accumulation, DiffAugment and the precision policies: the JAX
        config.json loads in the port with every field equal, and the
        port's loads back in JAX equal to the JAX config."""
        jcfg = JTrainConfig(**kw)
        j_config.save_config(jcfg, str(tmp_path / "jax"))
        cfg = config.load_config(str(tmp_path / "jax"))
        for f in dataclasses.fields(TrainConfig):
            if f.name != "model":
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        assert dataclasses.asdict(cfg.model) == dataclasses.asdict(
            jcfg.model)
        config.save_config(cfg, str(tmp_path / "port"))
        back = j_config.load_config(str(tmp_path / "port"))
        assert back == jcfg

    def test_unported_defaults_are_jax_defaults(self):
        for name, default in config.UNPORTED_TRAIN_FIELDS.items():
            assert getattr(JTrainConfig(), name) == default, name


# ---------------------------------------------------------------------------
# the command line: train from TFRecords, resume, serve the checkpoint
# ---------------------------------------------------------------------------

class TestCommandLine:
    def test_train_resume_and_serve(self, tmp_path):
        data = tmp_path / "data"
        write_image_tfrecords(str(data), num_examples=32, image_size=16,
                              num_shards=2)
        run = str(tmp_path / "run")
        argv = ["--preset", "celeba64", "--use_pallas", "--pallas_fused",
                "--data_dir", str(data), "--checkpoint_dir", run,
                "--shuffle_buffer", "8", "--num_loader_threads", "2",
                "--sample_dir", str(tmp_path / "samples"), *CLI_SMALL]
        assert int(cli.main(argv + ["--max_steps", "2"])["step"]) == 2
        state = cli.main(argv + ["--max_steps", "3"])
        assert int(state["step"]) == 3
        assert [e["step"] for e in _events(run)] == [1, 2, 3]
        row, responses = serve_main.run(
            ["--checkpoint_dir", run, "--device", "cpu",
             "--demo_requests", "2", "--demo_rps", "200",
             "--demo_max_images", "3"])
        assert row["meta"]["source"] == "checkpoint"
        assert row["meta"]["step"] == 3 and row["completed"] == 2
        for r in responses:
            img = r.result(timeout=30)
            assert img.shape[1:] == (16, 16, 3) and np.isfinite(img).all()


# ---------------------------------------------------------------------------
# checkpoints that load in both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_step():
    """The tiny config's JAX functions and its jitted train_step (the one
    JAX train_step compile of this file)."""
    jcfg = JTrainConfig(model=JModelConfig(**MODEL), batch_size=BATCH)
    fns = jsteps.make_train_step(jcfg)
    return jcfg, fns, jax.jit(fns.train_step)


def _step_inputs(seed):
    images = np.tanh(np.random.default_rng(seed).normal(
        size=(BATCH, 16, 16, 3))).astype(np.float32)
    key = jax.random.fold_in(jax.random.key(11), seed)
    z_key, _ = jax.random.split(key)
    z = np.array(jax.random.uniform(z_key, (BATCH, MODEL["z_dim"]),
                                    minval=-1.0, maxval=1.0,
                                    dtype=jnp.float32))
    return images, key, z


class TestCrossLoad:
    def test_port_checkpoint_steps_and_samples_in_jax(self, tmp_path,
                                                      jax_step):
        jcfg, jfns, jstep = jax_step
        cfg = _cfg(tmp_path)
        port_state = trainer.train(cfg, synthetic_data=True, max_steps=2,
                                   device="cpu")
        template = jax.device_get(jax.jit(jfns.init)(jax.random.key(0)))
        jstate = _tool().port_to_jax_state(cfg.checkpoint_dir, template)
        assert jax.tree_util.tree_structure(jstate) == \
            jax.tree_util.tree_structure(template)
        # the graft is exact: back through train_state_from_jax, bit equal
        _assert_same(convert.train_state_from_jax(jstate, device="cpu"),
                     port_state)
        images, key, z = _step_inputs(1)
        jnew, jm = jstep(jax.tree_util.tree_map(jnp.asarray, jstate),
                         jnp.asarray(images), key)
        tnew, tm = steps.make_train_step(cfg).train_step(
            port_state, torch.from_numpy(images), torch.from_numpy(z))
        for k in trainer.METRIC_KEYS:
            assert abs(float(jm[k]) - float(tm[k])) <= 1e-5, k
        want = convert.flatten(convert.train_state_from_jax(
            jax.device_get(jnew), device="cpu"))
        got = convert.flatten(tnew)
        assert sorted(got) == sorted(want)
        for path, w in want.items():
            bound = 2 * LR if PRE_BN.search(path) else \
                1e-5 + 1e-5 * float(w.abs().max())
            err = float((got[path].double() - w.double()).abs().max())
            assert err <= bound, (path, err, bound)
        # the samplers on the grafted state: f32 images within
        # test_torch_models' 1e-4
        zs = np.random.default_rng(2).uniform(-1, 1, (6, 8)).astype(
            np.float32)
        jimg = np.asarray(jax.jit(jfns.sample)(
            jax.tree_util.tree_map(jnp.asarray, jstate), jnp.asarray(zs)))
        timg = sampler_apply(port_state["params"]["gen"],
                             port_state["bn"]["gen"], torch.from_numpy(zs),
                             cfg=cfg.model).numpy()
        assert jimg.shape == timg.shape == (6, 16, 16, 3)
        assert np.abs(jimg - timg).max() <= 1e-4

    def test_orbax_checkpoint_exports_bit_for_bit(self, tmp_path):
        """An Orbax checkpoint written by the JAX Checkpointer, exported by
        the tool, restores in the port equal to train_state_from_jax of
        the saved state; the JAX run's config.json loads in the port."""
        jcfg = JTrainConfig(model=JModelConfig(**MODEL), batch_size=BATCH,
                            checkpoint_dir=str(tmp_path / "jax"))
        # a state of the init's tree, shapes and dtypes, every f32 leaf
        # random and every count 6
        rng = np.random.default_rng(5)
        state = jax.tree_util.tree_map(
            lambda s: jax.device_put(
                rng.normal(size=s.shape).astype(s.dtype)
                if s.dtype == jnp.float32 else np.full(s.shape, 6, s.dtype)),
            jax.eval_shape(lambda k: jsteps.init_train_state(k, jcfg),
                           jax.random.key(4)))
        j_config.save_config(jcfg, jcfg.checkpoint_dir)
        jck = JCheckpointer(jcfg.checkpoint_dir)
        jck.save(6, state, force=True)
        jck.close()
        out = str(tmp_path / "port")
        assert _tool().export(jcfg.checkpoint_dir, out) == 6
        port_cfg = config.load_config(out)
        assert port_cfg == config.load_config(jcfg.checkpoint_dir)
        restored = Checkpointer(out).restore_latest(
            steps.init_train_state(port_cfg, device="cpu"))
        _assert_same(restored, convert.train_state_from_jax(
            jax.device_get(state), device="cpu"))
        assert int(restored["step"]) == 6


COND = dict(MODEL, num_classes=4)


class TestConditionalCrossLoad:
    @pytest.mark.parametrize("cbn", [False, True])
    def test_port_checkpoint_samples_in_jax(self, tmp_path, cbn):
        """A conditional run of the port's trainer (K = 4, with and
        without conditional BN): its checkpoint grafts into the JAX state
        exactly (back to the port bit for bit), both samplers on it with
        labels agree within 1e-4 (f32), and its config.json loads in the
        JAX package with the conditioning."""
        mk = dict(COND, conditional_bn=cbn)
        cfg = TrainConfig(model=ModelConfig(**mk), batch_size=BATCH,
                          checkpoint_dir=str(tmp_path / "run"),
                          sample_dir=str(tmp_path / "samples"))
        port_state = trainer.train(cfg, synthetic_data=True, max_steps=2,
                                   device="cpu")
        jcfg = j_config.load_config(cfg.checkpoint_dir)
        assert jcfg.model.num_classes == 4 and \
            jcfg.model.conditional_bn == cbn
        jfns = jsteps.make_train_step(jcfg)
        template = jax.device_get(jax.jit(jfns.init)(jax.random.key(0)))
        jstate = _tool().port_to_jax_state(cfg.checkpoint_dir, template)
        _assert_same(convert.train_state_from_jax(jstate, device="cpu"),
                     port_state)
        zs = np.random.default_rng(3).uniform(-1, 1, (6, 8)).astype(
            np.float32)
        labels = np.array([0, 1, 2, 3, 1, 2], np.int32)
        jimg = np.asarray(jax.jit(jfns.sample)(
            jax.tree_util.tree_map(jnp.asarray, jstate), jnp.asarray(zs),
            jnp.asarray(labels)))
        timg = sampler_apply(port_state["params"]["gen"],
                             port_state["bn"]["gen"], torch.from_numpy(zs),
                             cfg=cfg.model,
                             labels=torch.from_numpy(labels)).numpy()
        assert np.abs(jimg - timg).max() <= 1e-4

    def test_orbax_checkpoint_exports_bit_for_bit(self, tmp_path):
        """A conditional-BN Orbax checkpoint of the JAX Checkpointer,
        exported by the tool, restores in the port equal to
        train_state_from_jax of the saved state: the [K, C] tables, the
        widened proj and conv0."""
        jcfg = JTrainConfig(model=JModelConfig(**COND, conditional_bn=True),
                            batch_size=BATCH,
                            checkpoint_dir=str(tmp_path / "jax"))
        rng = np.random.default_rng(6)
        state = jax.tree_util.tree_map(
            lambda s: jax.device_put(
                rng.normal(size=s.shape).astype(s.dtype)
                if s.dtype == jnp.float32 else np.full(s.shape, 3, s.dtype)),
            jax.eval_shape(lambda k: jsteps.init_train_state(k, jcfg),
                           jax.random.key(4)))
        j_config.save_config(jcfg, jcfg.checkpoint_dir)
        jck = JCheckpointer(jcfg.checkpoint_dir)
        jck.save(3, state, force=True)
        jck.close()
        out = str(tmp_path / "port")
        assert _tool().export(jcfg.checkpoint_dir, out) == 3
        port_cfg = config.load_config(out)
        assert port_cfg.model.conditional_bn and \
            port_cfg.model.num_classes == 4
        restored = Checkpointer(out).restore_latest(
            steps.init_train_state(port_cfg, device="cpu"))
        _assert_same(restored, convert.train_state_from_jax(
            jax.device_get(state), device="cpu"))
        gen = restored["params"]["gen"]
        assert gen["bn0"]["scale"].shape[0] == 4
        assert gen["proj"]["w"].shape[0] == 8 + 4
        assert restored["params"]["disc"]["conv0"]["w"].shape[2] == 3 + 4
