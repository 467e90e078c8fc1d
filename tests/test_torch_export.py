"""The port's serving artifact (`dcgan_tpu_torch/export.py`, `python -m
dcgan_tpu_torch.export`, `serve --artifact`) on the CPU, at a tiny config
(16 px, gf = df = 8, z 8):

- the artifact equals the port's plain sampler on the checkpoint within
  1e-6 in f32, and the JAX package's exporter run on the same weights
  (the port's checkpoint grafted into the JAX state by
  `tools/export_torch_checkpoint.py::port_to_jax_state`) at the sampler
  tolerances, f32 1e-4 and bf16 2e-2;
- its symbolic batch serves b = 1, 3 and 64; a pinned batch serves that
  one;
- its sidecar has the JAX sidecar's keys (and `torch`, the version that
  wrote it), the same calling convention and serving block, and under
  `--quantize int8` the JAX exporter's int8 report;
- `serve --artifact` serves it, through ArtifactSource's rungs;
- a process that imports only torch and numpy loads and runs it.
"""

import dataclasses
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcgan_tpu import export as j_export
from dcgan_tpu_torch import export as t_export
from dcgan_tpu_torch.config import MODEL_OVERRIDE_FLAGS, ModelConfig, \
    TrainConfig, save_config
from dcgan_tpu_torch.models.dcgan import sampler_apply
from dcgan_tpu_torch.serve import __main__ as serve_main
from dcgan_tpu_torch.serve.server import SamplerServer
from dcgan_tpu_torch.serve.sources import ArtifactSource
from dcgan_tpu_torch.train.steps import init_train_state, tree_map
from dcgan_tpu_torch.utils.checkpoint import Checkpointer

ROOT = pathlib.Path(__file__).resolve().parent.parent
MODEL = dict(output_size=16, gf_dim=8, df_dim=8, z_dim=8)
OVERRIDES = {"output_size": 16, "gf_dim": 8, "df_dim": 8, "z_dim": 8}
#: the sampler's tolerances against the JAX package (test_torch_models.py)
JAX_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: a served batch runs at its padded bucket, where the CPU's convolutions
#: may sum in another order than at the request's own batch
SERVED_TOL = 1e-4
TIMEOUT = 60.0


def _checkpoint(root, gamma=None, **model):
    """A port checkpoint (step 5) whose G weights are the seeded init's
    times 30, so that the images span tanh's range; its EMA copy differs.
    `gamma` sets G's attention gate (0 at init: the block is a no-op)."""
    cfg = TrainConfig(model=ModelConfig(**dict(MODEL, **model)),
                      batch_size=4)
    state = init_train_state(cfg, device="cpu")
    state["params"]["gen"] = tree_map(lambda w: w * 30.0,
                                      state["params"]["gen"])
    state["ema_gen"] = tree_map(lambda w: w * 20.0, state["ema_gen"])
    if gamma is not None:
        state["params"]["gen"]["attn"]["gamma"].fill_(gamma)
    state["step"] = torch.tensor(5, dtype=torch.int32)
    save_config(cfg, root)
    ckpt = Checkpointer(root)
    ckpt.save(5, state)
    ckpt.wait()
    return root, cfg, state


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return _checkpoint(str(tmp_path_factory.mktemp("export")),
                       compute_dtype="float32", use_pallas=True,
                       pallas_fused=True)


def _z(n, seed=0):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, MODEL["z_dim"])).astype(np.float32)


def _plain(cfg, state, z, use_ema=False):
    """The port's plain-route sampler on the checkpoint's weights."""
    mcfg = dataclasses.replace(cfg.model, use_pallas=False,
                               pallas_fused=False)
    params = state["ema_gen"] if use_ema else state["params"]["gen"]
    return sampler_apply(params, state["bn"]["gen"], torch.from_numpy(z),
                         cfg=mcfg).float().numpy()


def _export(ckpt_dir, out, **kw):
    return t_export.export_sampler(ckpt_dir, str(out), overrides=OVERRIDES,
                                   device="cpu", **kw)


def _jax_export(monkeypatch, ckpt_dir, out, **kw):
    """The JAX exporter on the port's checkpoint: its restore returns the
    port's state grafted into the JAX template."""
    from dcgan_tpu.utils import checkpoint as j_ckpt

    spec = importlib.util.spec_from_file_location(
        "export_torch_checkpoint",
        ROOT / "tools" / "export_torch_checkpoint.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)

    def restore(self, template):
        return jax.tree_util.tree_map(jnp.asarray, tool.port_to_jax_state(
            ckpt_dir, jax.device_get(template)))
    monkeypatch.setattr(j_ckpt.Checkpointer, "restore_latest", restore)
    meta = j_export.export_sampler(ckpt_dir, str(out), overrides=OVERRIDES,
                                   platforms=("cpu",), **kw)
    return meta, j_export.load_sampler(str(out))


class TestArtifact:
    def test_equals_the_plain_sampler(self, ckpt, tmp_path):
        root, cfg, state = ckpt
        out = tmp_path / "s.pt2"
        meta = _export(root, out)
        assert out.exists() and meta["bytes"] == out.stat().st_size
        program = t_export.load_sampler(str(out))
        z = _z(8)
        got = program(torch.from_numpy(z)).numpy()
        want = _plain(cfg, state, z)
        assert want.std() > 0.3
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_equals_the_jax_exporter(self, tmp_path, monkeypatch, dtype):
        root, cfg, state = _checkpoint(str(tmp_path / "ckpt"),
                                       compute_dtype=dtype)
        t_meta = _export(root, tmp_path / "t.pt2")
        j_meta, j_program = _jax_export(monkeypatch, root,
                                        tmp_path / "j.jaxexport")
        z = _z(6, seed=1)
        got = t_export.load_sampler(str(tmp_path / "t.pt2"))(
            torch.from_numpy(z)).float().numpy()
        want = np.asarray(j_program.call(z), np.float32)
        np.testing.assert_allclose(got, want, rtol=0, atol=JAX_TOL[dtype])
        assert want.std() > 0.3
        # the sidecar: the JAX keys, the version, the same convention
        assert set(t_meta) == set(j_meta) | {"torch"}
        assert t_meta["torch"] == torch.__version__
        assert t_meta["format"] == "torch.export ExportedProgram"
        assert t_meta["platforms"] == ["cpu"]
        for key in ("call", "z_dim", "num_classes", "image_shape", "batch",
                    "arch", "step", "weights", "serving"):
            assert t_meta[key] == j_meta[key], key
        saved = json.loads((tmp_path / "t.pt2.json").read_text())
        assert saved == t_meta

    def test_int8_report_equals_the_jax_exporter(self, tmp_path,
                                                 monkeypatch):
        # the plain route: the JAX exporter refuses a pallas_fused config
        # (its use_pallas=False replace fails ModelConfig's validation)
        root, cfg, state = _checkpoint(str(tmp_path / "ckpt"),
                                       compute_dtype="float32")
        t_meta = _export(root, tmp_path / "q.pt2", quantize="int8")
        j_meta, j_program = _jax_export(
            monkeypatch, root, tmp_path / "q.jaxexport", quantize="int8")
        tq, jq = t_meta["serving"]["quantize"], j_meta["serving"]["quantize"]
        assert {k: v for k, v in tq.items() if k != "max_rel_error"} == \
            {k: v for k, v in jq.items() if k != "max_rel_error"}
        assert round(tq["max_rel_error"], 6) == \
            round(jq["max_rel_error"], 6)
        z = _z(4, seed=2)
        got = t_export.load_sampler(str(tmp_path / "q.pt2"))(
            torch.from_numpy(z)).numpy()
        np.testing.assert_allclose(got, np.asarray(j_program.call(z)),
                                   rtol=0, atol=JAX_TOL["float32"])
        # quantized: not the f32 sampler's images
        assert not np.allclose(got, _plain(cfg, state, z), atol=1e-6)
        # the EMA copy, quantized, names its source in the sidecar
        e_meta = _export(root, tmp_path / "e.pt2", quantize="int8",
                         use_ema=True)
        assert e_meta["weights"] == e_meta["serving"]["source"] == "ema"
        assert e_meta["serving"]["quantize"]["quantized_leaves"] == \
            tq["quantized_leaves"]

    def test_symbolic_batch_serves_any_size(self, ckpt, tmp_path):
        root, cfg, state = ckpt
        out = tmp_path / "sym.pt2"
        meta = _export(root, out, max_serve_batch=16)
        assert meta["batch"] == "b (symbolic)"
        assert meta["serving"]["bucket_ladder"] == [1, 2, 4, 8, 16]
        program = t_export.load_sampler(str(out))
        for b in (1, 3, 64):
            z = _z(b, seed=b)
            np.testing.assert_allclose(
                program(torch.from_numpy(z)).numpy(), _plain(cfg, state, z),
                rtol=0, atol=1e-6)

    def test_pinned_batch(self, ckpt, tmp_path):
        root, cfg, state = ckpt
        out = tmp_path / "pinned.pt2"
        meta = _export(root, out, batch_size=3)
        assert meta["batch"] == 3
        assert meta["serving"]["bucket_ladder"] == [3]
        program = t_export.load_sampler(str(out))
        z = _z(3)
        np.testing.assert_allclose(program(torch.from_numpy(z)).numpy(),
                                   _plain(cfg, state, z), rtol=0, atol=1e-6)
        with pytest.raises(Exception):
            program(torch.from_numpy(_z(4)))

    def test_sagan_checkpoint_exports_dense(self, tmp_path):
        """A flash-route sagan checkpoint (attention on the kernels, SN)
        exports the dense attention, equal to the plain sampler; its gamma
        is 0.5, so the attention block counts."""
        root, cfg, state = _checkpoint(
            str(tmp_path / "sagan"), gamma=0.5, compute_dtype="float32",
            attn_res=8, spectral_norm="gd", use_pallas=True,
            bn_pallas=False)
        out = tmp_path / "sagan.pt2"
        t_export.export_sampler(root, str(out), device="cpu")
        z = _z(5)
        got = t_export.load_sampler(str(out))(torch.from_numpy(z)).numpy()
        assert got.shape == (5, 16, 16, 3)
        np.testing.assert_allclose(got, _plain(cfg, state, z), rtol=0,
                                   atol=1e-6)
        no_attn = dict(state, params=dict(state["params"], gen=dict(
            state["params"]["gen"], attn=dict(
                state["params"]["gen"]["attn"], gamma=torch.tensor(0.0)))))
        assert not np.allclose(got, _plain(cfg, no_attn, z), atol=1e-4)

    def test_cli_and_flag_coverage(self, ckpt, tmp_path, capsys):
        root, cfg, state = ckpt
        args = t_export.build_parser().parse_args(["--checkpoint_dir", root])
        for name in MODEL_OVERRIDE_FLAGS:
            assert hasattr(args, name), name
        assert args.device == "cuda"
        out = str(tmp_path / "cli.pt2")
        t_export.main(["--checkpoint_dir", root, "--out", out,
                       "--output_size", "16", "--gf_dim", "8", "--df_dim",
                       "8", "--z_dim", "8", "--device", "cpu",
                       "--batch_size", "2"])
        assert "step-5 live sampler" in capsys.readouterr().out
        sidecar = json.load(open(out + ".json"))
        assert sidecar["batch"] == 2 and sidecar["step"] == 5


class TestServeArtifact:
    def test_artifact_source_serves_1_3_64(self, ckpt, tmp_path):
        root, cfg, state = ckpt
        out = str(tmp_path / "a.pt2")
        _export(root, out)
        src = ArtifactSource(out, device="cpu")
        assert src.ladder_hint() == [1, 2, 4, 8, 16, 32, 64]
        server = SamplerServer(src, max_wait_ms=1.0)
        server.start(timeout=TIMEOUT)
        try:
            zs = {b: _z(b, seed=10 + b) for b in (1, 3, 64)}
            got = {b: server.submit(z=z).result(TIMEOUT)
                   for b, z in zs.items()}
        finally:
            server.stop()
        assert server.ladder.buckets == (1, 2, 4, 8, 16, 32, 64)
        for b, z in zs.items():
            np.testing.assert_allclose(got[b], _plain(cfg, state, z),
                                       rtol=0, atol=SERVED_TOL)
        # no promotion for an artifact: the ticket fails, nothing else
        assert not hasattr(src, "reload")
        assert src._rungs == {}   # released at stop

    def test_serve_cli_artifact(self, ckpt, tmp_path):
        root, cfg, state = ckpt
        out = str(tmp_path / "cli.pt2")
        _export(root, out, max_serve_batch=4)
        row, responses = serve_main.run([
            "--artifact", out, "--device", "cpu", "--demo_requests", "6",
            "--demo_rps", "500", "--demo_max_images", "3", "--seed", "3"])
        assert row["completed"] == 6 and row["failed"] == 0
        assert row["buckets"] == [1, 2, 4]          # the sidecar's hint
        assert row["meta"]["source"] == "artifact"
        assert row["meta"]["step"] == 5
        for serial, r in enumerate(responses):
            img = r.result(0)
            z = np.random.default_rng((3, serial)).uniform(
                -1.0, 1.0, (img.shape[0], 8)).astype(np.float32)
            np.testing.assert_allclose(img, _plain(cfg, state, z), rtol=0,
                                       atol=SERVED_TOL)

    def test_missing_sidecar_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError, match="sidecar"):
            ArtifactSource(str(tmp_path / "none.pt2"), device="cpu")


def test_runs_with_only_torch_and_numpy(ckpt, tmp_path):
    """Load and run the artifact in a process whose only imports are
    torch and numpy, outside the repository."""
    root, cfg, state = ckpt
    out = str(tmp_path / "alone.pt2")
    _export(root, out)
    z = _z(3, seed=4)
    np.save(tmp_path / "z.npy", z)
    code = (
        "import sys, numpy as np, torch\n"
        f"z = torch.from_numpy(np.load({str(tmp_path / 'z.npy')!r}))\n"
        f"img = torch.export.load({out!r}).module()(z)\n"
        f"np.save({str(tmp_path / 'img.npy')!r}, img.numpy())\n"
        "bad = sorted(n for n in sys.modules if n.startswith('dcgan'))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    done = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert done.returncode == 0, done.stderr
    np.testing.assert_allclose(np.load(tmp_path / "img.npy"),
                               _plain(cfg, state, z), rtol=0, atol=1e-6)
