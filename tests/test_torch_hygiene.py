"""Boundaries of the PyTorch port: it imports neither JAX nor the JAX
package (the package, chip_smoke.py, tools/chaos_drill_torch.py,
tools/trace_summary_torch.py, and the modules the ranks of the
multi-process tests run, tests/torch_dp_worker.py and
tests/torch_spatial_worker.py), and its entry points refuse to run
quietly on the CPU."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "dcgan_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "dcgan_tpu")


def _port_files():
    # the worker modules are what the spawned ranks of the multi-process
    # tests import: they run the port without JAX
    return sorted(PKG.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tools" / "chaos_drill_torch.py",
        ROOT / "tools" / "trace_summary_torch.py",
        ROOT / "tests" / "torch_dp_worker.py",
        ROOT / "tests" / "torch_spatial_worker.py"]


#: test_ast_imports' files, dealt round-robin over
#: test_torch_hygiene_{b,c,d,e}.py so that each file holds at most 30 tests
IMPORT_SHARDS = 4


def import_shard(i: int):
    return _port_files()[i::IMPORT_SHARDS]


def port_file_id(path) -> str:
    return str(path.relative_to(ROOT))


def check_imports(path) -> None:
    """`path` imports nothing of jax, jaxlib or dcgan_tpu."""
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


class TestNoJaxImports:
    # test_ast_imports (every port file, chip_smoke.py,
    # tools/chaos_drill_torch.py and tools/trace_summary_torch.py):
    # test_torch_hygiene_{b,c,d,e}.py

    def test_importing_every_module_loads_no_jax(self):
        """Import every module of the package in a fresh interpreter and
        check sys.modules: nothing of jax or dcgan_tpu came along."""
        code = (
            "import importlib, pkgutil, sys\n"
            "import dcgan_tpu_torch\n"
            "for m in pkgutil.walk_packages(dcgan_tpu_torch.__path__,\n"
            "                               'dcgan_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(n for n in sys.modules\n"
            f"             if n.split('.')[0] in {FORBIDDEN!r})\n"
            "print('LOADED', len([n for n in sys.modules\n"
            "      if n.startswith('dcgan_tpu_torch')]))\n"
            "assert not bad, bad\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             env=_clean_env(), capture_output=True,
                             text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        loaded = int(out.stdout.split("LOADED")[1])
        assert loaded >= 15

    def test_import_builds_nothing(self):
        """Importing the kernel modules, the native loader's bindings,
        the evals rig and the serving plane starts no compiler: a kernel is built inside the
        first call that launches it, the loader at the first
        NativeLoader."""
        code = ("import subprocess, sys\n"
                "calls = []\n"
                "subprocess.Popen = lambda *a, **k: calls.append(a)\n"
                "import dcgan_tpu_torch.data.native\n"
                "import dcgan_tpu_torch.data.prepare\n"
                "import dcgan_tpu_torch.evals.__main__\n"
                "import dcgan_tpu_torch.export\n"
                "import dcgan_tpu_torch.serve.__main__\n"
                "import dcgan_tpu_torch.serve.fleet\n"
                "import dcgan_tpu_torch.serve.quantize\n"
                "import dcgan_tpu_torch.ops.flash_attention\n"
                "import dcgan_tpu_torch.ops.fused\n"
                "import dcgan_tpu_torch.ops.kernels\n"
                "import dcgan_tpu_torch.train.steps\n"
                "assert not calls, calls\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             env=_clean_env(), capture_output=True,
                             text=True, timeout=120)
        assert out.returncode == 0, out.stderr


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a GPU")


class TestEntryPointsNeedTheCard:
    def test_default_device_raises_without_gpu(self, no_gpu, tmp_path):
        from dcgan_tpu_torch import convert
        from dcgan_tpu_torch.config import ModelConfig
        from dcgan_tpu_torch.device import resolve_device
        from dcgan_tpu_torch.models.dcgan import generator_init
        from dcgan_tpu_torch.serve.sources import WeightsSource

        cfg = ModelConfig(output_size=8, gf_dim=4)
        p, s = generator_init(cfg, device="cpu")
        path = convert.save_weights(str(tmp_path / "g.npz"), cfg, p, s)
        for call in (lambda: resolve_device(),
                     lambda: generator_init(cfg),
                     lambda: convert.load_weights(path),
                     lambda: convert.generator_from_jax({}, {}),
                     lambda: WeightsSource(path)):
            with pytest.raises(RuntimeError, match="cuda"):
                call()
        assert resolve_device("cpu").type == "cpu"
        with pytest.raises(ValueError):
            resolve_device("mps")

    def test_serve_cli_refuses_without_gpu(self, no_gpu, tmp_path):
        from dcgan_tpu_torch import convert
        from dcgan_tpu_torch.config import ModelConfig
        from dcgan_tpu_torch.models.dcgan import generator_init

        cfg = ModelConfig(output_size=8, gf_dim=4)
        p, s = generator_init(cfg, device="cpu")
        path = convert.save_weights(str(tmp_path / "g.npz"), cfg, p, s)
        out = subprocess.run(
            [sys.executable, "-m", "dcgan_tpu_torch.serve", "--weights",
             path, "--demo_requests", "1"], cwd=ROOT, env=_clean_env(),
            capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert "torch.cuda.is_available() is False" in out.stderr
        assert "warm: serving" not in out.stdout


class TestTrainerNeedsTheCard:
    def test_entry_points_raise_without_gpu(self, no_gpu):
        from dcgan_tpu_torch import convert
        from dcgan_tpu_torch.config import ModelConfig, TrainConfig
        from dcgan_tpu_torch.models.dcgan import discriminator_init, gan_init
        from dcgan_tpu_torch.train.steps import init_train_state, \
            make_train_step
        from dcgan_tpu_torch.train.trainer import train

        cfg = TrainConfig(model=ModelConfig(output_size=8, gf_dim=4,
                                            df_dim=4), batch_size=2)
        for call in (lambda: discriminator_init(cfg.model),
                     lambda: gan_init(cfg.model),
                     lambda: init_train_state(cfg),
                     lambda: make_train_step(cfg).init(),
                     lambda: convert.train_state_from_jax({}),
                     lambda: train(cfg, synthetic_data=True, max_steps=1)):
            with pytest.raises(RuntimeError, match="cuda"):
                call()

    def test_train_cli_refuses_without_gpu(self, no_gpu, tmp_path):
        out = subprocess.run(
            [sys.executable, "-m", "dcgan_tpu_torch.train", "--synthetic",
             "--max_steps", "1", "--checkpoint_dir", str(tmp_path)],
            cwd=ROOT, env=_clean_env(), capture_output=True, text=True,
            timeout=120)
        assert out.returncode != 0
        assert "torch.cuda.is_available() is False" in out.stderr
        assert not (tmp_path / "events.jsonl").exists()

    def test_train_cli_without_synthetic_names_the_missing_feed(self,
                                                               tmp_path):
        """Without --synthetic the run reads --data_dir's TFRecord shards:
        a directory without any fails, naming it, before anything is
        written to the checkpoint directory."""
        empty = tmp_path / "no_shards"
        empty.mkdir()
        out = subprocess.run(
            [sys.executable, "-m", "dcgan_tpu_torch.train", "--device",
             "cpu", "--max_steps", "1", "--data_dir", str(empty),
             "--checkpoint_dir", str(tmp_path / "run")], cwd=ROOT,
            env=_clean_env(), capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert f"no TFRecord shards in {empty}" in out.stderr
        assert not (tmp_path / "run").exists()


class TestChipSmokeRefuses:
    def _run(self, cwd):
        return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                              env=_clean_env(), capture_output=True,
                              text=True, timeout=120)

    def test_without_gpu(self, no_gpu):
        out = self._run(ROOT)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout

    def test_alone_in_a_directory(self, tmp_path):
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        out = self._run(tmp_path)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
