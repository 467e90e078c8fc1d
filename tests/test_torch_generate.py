"""The port's generate CLI (`dcgan_tpu_torch/generate.py`) on the CPU, at a
tiny config (16 px, gf = df = 8, z 8):

- its npz images equal the JAX package's sampler on the same checkpoint
  (grafted into the JAX state by `tools/export_torch_checkpoint.py::
  port_to_jax_state`) at the z rows rebuilt from the port's documented
  draw (`generate_z`), within the f32 sampler tolerance of
  tests/test_torch_models.py (1e-4), and the tail snaps to a ladder rung;
- the JAX package's tests/test_generate.py cases: grids from the pool,
  --use_ema, interpolation endpoints, truncation validated and applied,
  --interpolate needing a grid, no checkpoint, --class_id, bad arguments,
  and the preset + override precedence equal to the JAX
  `resolve_model_config` on the same config.json.

The captured rungs themselves run only on the card (chip_smoke.py and the
`cuda` tests of tests/test_torch_warmup.py); here the rungs run eagerly.
"""

import dataclasses
import glob
import importlib.util
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcgan_tpu import config as j_config
from dcgan_tpu.config import ModelConfig as JModelConfig
from dcgan_tpu.config import TrainConfig as JTrainConfig
from dcgan_tpu.train import steps as jsteps
from dcgan_tpu_torch import config, generate as gen
from dcgan_tpu_torch.config import ModelConfig, TrainConfig
from dcgan_tpu_torch.models.dcgan import sampler_apply
from dcgan_tpu_torch.train import trainer
from dcgan_tpu_torch.utils.checkpoint import Checkpointer
from torch_jax_draws import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
MODEL = dict(output_size=16, gf_dim=8, df_dim=8, z_dim=8,
             compute_dtype="float32")
FLAGS = ["--output_size", "16", "--gf_dim", "8", "--df_dim", "8",
         "--z_dim", "8", "--device", "cpu"]


def _train(root, steps, **kw):
    cfg = TrainConfig(model=ModelConfig(**MODEL), batch_size=4,
                      checkpoint_dir=str(root / "ckpt"),
                      sample_dir=str(root / "samples"),
                      sample_every_steps=0, save_summaries_secs=1e9,
                      save_model_secs=1e9, tensorboard=False, **kw)
    trainer.train(cfg, synthetic_data=True, max_steps=steps, device="cpu")
    return str(root / "ckpt")


@pytest.fixture(scope="module")
def trained_ckpt(tmp_path_factory):
    return _train(tmp_path_factory.mktemp("gen"), 1)


def _run(argv):
    return gen.generate(gen.build_parser().parse_args(argv))


def _restored(ckpt_dir, use_ema=False):
    from dcgan_tpu_torch.train.steps import init_train_state

    template = init_train_state(TrainConfig(model=ModelConfig(**MODEL)),
                                device="cpu")
    state = Checkpointer(ckpt_dir).restore_latest(template)
    return (state["ema_gen"] if use_ema else state["params"]["gen"],
            state["bn"]["gen"])


@pytest.fixture(scope="module")
def wide_ckpt(tmp_path_factory):
    """A checkpoint (step 3) whose G weights are the init's times 30, so
    that the images span tanh's range instead of sitting near 0."""
    from dcgan_tpu_torch.config import save_config
    from dcgan_tpu_torch.train.steps import init_train_state, tree_map

    root = str(tmp_path_factory.mktemp("wide"))
    cfg = TrainConfig(model=ModelConfig(**MODEL), batch_size=4)
    state = init_train_state(cfg, device="cpu")
    state["params"]["gen"] = tree_map(lambda w: w * 30.0,
                                      state["params"]["gen"])
    state["step"] = torch.tensor(3, dtype=torch.int32)
    save_config(cfg, root)
    ckpt = Checkpointer(root)
    ckpt.save(3, state)
    ckpt.wait()
    return root


class TestAgainstJax:
    def test_npz_equals_jax_sampler_on_rebuilt_z(self, wide_ckpt, tmp_path):
        npz = str(tmp_path / "gen.npz")
        result = _run(["--checkpoint_dir", wide_ckpt,
                       "--out_dir", str(tmp_path / "out"),
                       "--num_images", "11", "--batch_size", "8",
                       "--grid", "0", "--npz", npz, "--seed", "5",
                       "--truncation", "0.7", *FLAGS])
        # 8 rows, then the tail of 3 on the rung of 4
        assert result["buckets"] == [8, 4] and result["num_images"] == 11
        got = np.load(npz)["images"]
        assert got.shape == (11, 16, 16, 3) and got.dtype == np.float32

        spec = importlib.util.spec_from_file_location(
            "export_torch_checkpoint",
            ROOT / "tools" / "export_torch_checkpoint.py")
        tool = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tool)
        jfns = jsteps.make_train_step(JTrainConfig(
            model=JModelConfig(**MODEL), batch_size=4))
        template = jax.device_get(jax.jit(jfns.init)(jax.random.key(0)))
        jstate = jax.tree_util.tree_map(
            jnp.asarray, tool.port_to_jax_state(wide_ckpt, template))
        want = []
        for i, (n, take) in enumerate(((8, 8), (4, 3))):
            z = gen.generate_z(5, i, n, 8, 0.7)
            want.append(np.asarray(jax.jit(jfns.sample)(
                jstate, jnp.asarray(z)))[:take])
        want = np.concatenate(want)
        assert want.std() > 0.2
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)

    @pytest.mark.parametrize("preset,overrides", [
        (None, {}),
        (None, {"gf_dim": 16}),
        ("celeba64", {"output_size": 16, "gf_dim": 8, "df_dim": 8}),
        ("sagan64", {}),
        ("sagan64", {"attn_res": 16, "spectral_norm": "d"}),
    ])
    def test_precedence_equals_jax_resolve(self, tmp_path, preset,
                                           overrides):
        j_config.save_config(JTrainConfig(model=JModelConfig(
            output_size=32, gf_dim=12, df_dim=10, z_dim=20)), str(tmp_path))
        given = dict.fromkeys(config.MODEL_OVERRIDE_FLAGS)
        given.update(overrides)
        port = config.resolve_model_config(str(tmp_path), preset=preset,
                                           overrides=given)
        jax_cfg = j_config.resolve_model_config(str(tmp_path), preset=preset,
                                                overrides=given)
        assert dataclasses.asdict(port) == dataclasses.asdict(jax_cfg)
        assert config.MODEL_OVERRIDE_FLAGS == j_config.MODEL_OVERRIDE_FLAGS

    def test_flags_resolve_as_jax(self):
        """An explicit flag equal to the global default still beats the
        preset, through the parser of each package."""
        from dcgan_tpu import generate as jgen

        argv = ["--checkpoint_dir", "x", "--preset", "sagan64",
                "--output_size", "64", "--attn_res", "16"]
        port = gen._model_config(gen.build_parser().parse_args(argv))
        jax_cfg = jgen._model_config(jgen.build_parser().parse_args(argv))
        assert dataclasses.asdict(port) == dataclasses.asdict(jax_cfg)
        assert port.attn_res == 16 and port.spectral_norm == "gd"


class TestGenerate:
    def test_grids_and_npz(self, trained_ckpt, tmp_path):
        result = _run(["--checkpoint_dir", trained_ckpt,
                       "--out_dir", str(tmp_path / "out"),
                       "--num_images", "10", "--batch_size", "8",
                       "--grid", "2x2", "--npz", str(tmp_path / "g.npz"),
                       *FLAGS])
        assert result["num_images"] == 10 and result["step"] == 1
        assert glob.glob(str(tmp_path / "out" / "gen_*.png"))
        data = np.load(tmp_path / "g.npz")
        assert data["images"].shape == (10, 16, 16, 3)
        assert np.abs(data["images"]).max() <= 1.0
        assert "labels" not in data

    def test_grid_larger_than_batch_written_from_pool(self, trained_ckpt,
                                                      tmp_path):
        result = _run(["--checkpoint_dir", trained_ckpt,
                       "--out_dir", str(tmp_path / "out"),
                       "--num_images", "32", "--batch_size", "8",
                       "--grid", "4x4", *FLAGS])
        pngs = glob.glob(str(tmp_path / "out" / "gen_*.png"))
        assert len(pngs) == 2   # 32 images / 16 cells
        assert set(result["paths"]) == set(pngs)
        assert result["buckets"] == [8, 8, 8, 8]

    def test_use_ema_selects_ema_weights(self, tmp_path):
        ckpt = _train(tmp_path, 2, g_ema_decay=0.5)
        outs = {}
        for flag in (False, True):
            npz = str(tmp_path / f"g{flag}.npz")
            _run(["--checkpoint_dir", ckpt, "--out_dir", str(tmp_path),
                  "--num_images", "4", "--batch_size", "4", "--grid", "0",
                  "--npz", npz, *FLAGS] + (["--use_ema"] if flag else []))
            outs[flag] = np.load(npz)["images"]
            params, bn = _restored(ckpt, use_ema=flag)
            want = sampler_apply(params, bn, torch.from_numpy(
                gen.generate_z(0, 0, 4, 8)), cfg=ModelConfig(**MODEL))
            np.testing.assert_allclose(outs[flag], want.numpy(), rtol=0,
                                       atol=1e-5)
        assert float(np.abs(outs[True] - outs[False]).max()) > 0

    def test_interpolate_endpoints(self, trained_ckpt, tmp_path):
        npz = str(tmp_path / "i.npz")
        result = _run(["--checkpoint_dir", trained_ckpt,
                       "--out_dir", str(tmp_path / "out"), "--grid", "3x5",
                       "--interpolate", "--batch_size", "8", "--npz", npz,
                       "--seed", "2", *FLAGS])
        assert result["num_images"] == 15
        assert "interp_" in os.path.basename(result["paths"][0])
        assert os.path.exists(result["paths"][0])
        assert result["buckets"] == [8, 8]   # 8 rows, then 7 on rung 8
        imgs = np.load(npz)["images"].reshape(3, 5, 16, 16, 3)
        ends = gen.generate_z(2, 0, 6, 8).reshape(2, 3, 8)
        params, bn = _restored(trained_ckpt)
        for side, col in ((0, 0), (1, 4)):
            want = sampler_apply(params, bn, torch.from_numpy(ends[side]),
                                 cfg=ModelConfig(**MODEL)).numpy()
            np.testing.assert_allclose(imgs[:, col], want, rtol=0,
                                       atol=1e-5)
        # the walk moves between them
        assert np.abs(imgs[:, 2] - imgs[:, 0]).max() > 1e-4

    def test_truncation_validated_and_applied(self, trained_ckpt, tmp_path):
        base = ["--checkpoint_dir", trained_ckpt,
                "--out_dir", str(tmp_path / "out"), "--grid", "0",
                "--num_images", "4", "--batch_size", "4",
                "--npz", str(tmp_path / "t.npz"), *FLAGS]
        _run(base + ["--truncation", "0.5"])
        half = np.load(tmp_path / "t.npz")["images"]
        _run(base)
        full = np.load(tmp_path / "t.npz")["images"]
        assert np.abs(half - full).max() > 1e-5
        np.testing.assert_array_equal(gen.generate_z(0, 0, 4, 8, 0.5),
                                      0.5 * gen.generate_z(0, 0, 4, 8))
        with pytest.raises(SystemExit, match="truncation"):
            _run(base + ["--truncation", "0"])

    def test_interpolate_requires_grid(self, trained_ckpt, tmp_path):
        with pytest.raises(SystemExit, match="grid"):
            _run(["--checkpoint_dir", trained_ckpt,
                  "--out_dir", str(tmp_path / "out"), "--grid", "0",
                  "--interpolate", *FLAGS])

    def test_no_checkpoint_errors(self, tmp_path):
        with pytest.raises(SystemExit, match="no checkpoint"):
            _run(["--checkpoint_dir", str(tmp_path / "nope"), *FLAGS])

    @pytest.mark.parametrize("argv,error,match", [
        (["--class_id", "0"], SystemExit, "conditional"),
        (["--num_classes", "4", "--class_id", "4"], SystemExit,
         "out of range"),
    ])
    def test_class_id(self, tmp_path, argv, error, match):
        with pytest.raises(error, match=match):
            _run(["--checkpoint_dir", str(tmp_path / "ckpt"), *argv])

    @pytest.mark.parametrize("argv,match", [
        (["--batch_size", "0"], "batch_size"),
        (["--num_images", "-3"], "num_images"),
        (["--grid", "0x0"], "grid"),
        (["--grid", "8"], "grid"),
    ])
    def test_bad_arguments_rejected(self, tmp_path, argv, match):
        with pytest.raises(SystemExit, match=match):
            _run(["--checkpoint_dir", str(tmp_path / "ckpt"), *argv])

    def test_preset_architecture_with_overrides(self, trained_ckpt,
                                                tmp_path):
        npz = str(tmp_path / "g.npz")
        result = _run(["--checkpoint_dir", trained_ckpt, "--preset",
                       "celeba64", "--out_dir", str(tmp_path / "out"),
                       "--num_images", "4", "--batch_size", "8",
                       "--grid", "0", "--npz", npz,
                       *FLAGS])
        assert result["num_images"] == 4 and result["buckets"] == [4]
        assert np.load(npz)["images"].shape == (4, 16, 16, 3)

    def test_main_prints_and_returns(self, trained_ckpt, tmp_path, capsys):
        result = gen.main(["--checkpoint_dir", trained_ckpt,
                           "--out_dir", str(tmp_path), "--num_images", "1",
                           "--grid", "1x1", *FLAGS])
        assert result["buckets"] == [1]
        assert "1 images from checkpoint step 1" in capsys.readouterr().out


COND = dict(MODEL, num_classes=4, conditional_bn=True)


@pytest.fixture(scope="module")
def cond_ckpt(tmp_path_factory):
    """A conditional-BN checkpoint (K = 4, step 2) whose G weights are the
    init's times 10 and whose cBN biases differ per class."""
    from dcgan_tpu_torch.config import save_config
    from dcgan_tpu_torch.train.steps import init_train_state, tree_map

    root = str(tmp_path_factory.mktemp("cond"))
    cfg = TrainConfig(model=ModelConfig(**COND), batch_size=4)
    state = init_train_state(cfg, device="cpu")
    gen_params = tree_map(lambda w: w * 10.0, state["params"]["gen"])
    g = torch.Generator().manual_seed(0)
    for name, p in gen_params.items():
        if name.startswith("bn"):
            p["bias"] = 0.5 * torch.randn(p["bias"].shape, generator=g)
    state["params"]["gen"] = gen_params
    state["step"] = torch.tensor(2, dtype=torch.int32)
    save_config(cfg, root)
    ckpt = Checkpointer(root)
    ckpt.save(2, state)
    ckpt.wait()
    return root


class TestConditional:
    @pytest.mark.parametrize("class_id", [None, 2])
    def test_npz_labels_and_jax_sampler(self, cond_ckpt, tmp_path,
                                        class_id):
        """Labels cycle through the classes across batches (the tail's
        rung included), or are all --class_id; the npz holds them, and
        its images equal the JAX sampler on the rebuilt z rows and those
        labels within 1e-4 (f32)."""
        npz = str(tmp_path / "gen.npz")
        extra = [] if class_id is None else ["--class_id", str(class_id)]
        result = _run(["--checkpoint_dir", cond_ckpt, "--out_dir",
                       str(tmp_path / "out"), "--num_images", "11",
                       "--batch_size", "8", "--grid", "0", "--npz", npz,
                       "--seed", "4", *extra, *FLAGS])
        assert result["buckets"] == [8, 4]
        data = np.load(npz)
        want_labels = np.arange(11) % 4 if class_id is None \
            else np.full(11, class_id)
        np.testing.assert_array_equal(data["labels"], want_labels)

        spec = importlib.util.spec_from_file_location(
            "export_torch_checkpoint",
            ROOT / "tools" / "export_torch_checkpoint.py")
        tool = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tool)
        jfns = jsteps.make_train_step(JTrainConfig(
            model=JModelConfig(**COND), batch_size=4))
        template = jax.device_get(jax.jit(jfns.init)(jax.random.key(0)))
        jstate = jax.tree_util.tree_map(
            jnp.asarray, tool.port_to_jax_state(cond_ckpt, template))
        want, made = [], 0
        for i, (n, take) in enumerate(((8, 8), (4, 3))):
            z = gen.generate_z(4, i, n, 8)
            lab = (np.arange(made, made + n) % 4 if class_id is None
                   else np.full(n, class_id)).astype(np.int32)
            want.append(np.asarray(jax.jit(jfns.sample)(
                jstate, jnp.asarray(z), jnp.asarray(lab)))[:take])
            made += take
        want = np.concatenate(want)
        assert want.std() > 0.2
        np.testing.assert_allclose(data["images"], want, rtol=0, atol=1e-4)

    def test_interpolation_holds_one_class_per_row(self, cond_ckpt,
                                                   tmp_path):
        npz = str(tmp_path / "i.npz")
        _run(["--checkpoint_dir", cond_ckpt, "--out_dir",
              str(tmp_path / "out"), "--interpolate", "--grid", "3x2",
              "--npz", npz, *FLAGS])
        np.testing.assert_array_equal(np.load(npz)["labels"],
                                      [0, 0, 1, 1, 2, 2])
        _run(["--checkpoint_dir", cond_ckpt, "--out_dir",
              str(tmp_path / "out"), "--interpolate", "--grid", "2x2",
              "--class_id", "3", "--npz", npz, *FLAGS])
        np.testing.assert_array_equal(np.load(npz)["labels"], [3] * 4)

    @pytest.mark.parametrize("class_id", ["-1", "4"])
    def test_class_id_range_checked_as_jax(self, cond_ckpt, class_id):
        from dcgan_tpu import generate as jgen

        argv = ["--checkpoint_dir", cond_ckpt, "--class_id", class_id,
                *FLAGS[:-2]]
        errors = []
        for mod, extra in ((gen, ["--device", "cpu"]), (jgen, [])):
            with pytest.raises(SystemExit) as e:
                mod.generate(mod.build_parser().parse_args(argv + extra))
            errors.append(str(e.value).replace("dcgan_tpu_torch",
                                               "dcgan_tpu"))
        assert errors[0] == errors[1] and "out of range" in errors[0]
