"""The port's dataset producer (dcgan_tpu_torch/data/prepare.py) against
`dcgan_tpu/data/prepare.py`: the same image folder or CIFAR-10 batches
give byte-identical shards and manifests in both packages; the shards load
in both packages' native and Python loaders to the same examples; stale
shards are refused with the same message; the CLI's defaults are the JAX
CLI's (uint8 records); importing the module loads no PIL."""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from dcgan_tpu.data import native as j_native
from dcgan_tpu.data import pipeline as j_pipeline
from dcgan_tpu.data import prepare as j_prepare
from dcgan_tpu_torch.data import native, pipeline, prepare
from torch_jax_draws import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _folder(root, labeled=False, n=6):
    """n small RGB images of assorted sizes, in two class subdirectories
    when labeled."""
    rng = np.random.default_rng(0)
    for i in range(n):
        d = os.path.join(root, f"class{i % 2}") if labeled else root
        os.makedirs(d, exist_ok=True)
        h, w = 20 + 3 * i, 24 + 2 * (i % 3)
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                        ).save(os.path.join(d, f"img{i}.png"))
    return str(root)


def _files(directory):
    return {f: open(os.path.join(directory, f), "rb").read()
            for f in sorted(os.listdir(directory))}


@pytest.mark.parametrize("kw", [
    {}, {"record_dtype": "float64"},
    {"labeled": True, "image_size": 8, "crop_size": 0}],
    ids=["uint8", "float64", "labeled"])
def test_shards_byte_equal_to_jax(tmp_path, kw):
    src = _folder(tmp_path / "src", labeled=kw.get("labeled", False))
    opts = dict(image_size=16, crop_size=16, num_shards=2, seed=3)
    opts.update(kw)
    a = prepare.convert(src, str(tmp_path / "port"), **opts)
    b = j_prepare.convert(src, str(tmp_path / "jax"), **opts)
    assert [os.path.basename(p) for p in a] == [os.path.basename(p)
                                                for p in b]
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    manifest = json.loads((tmp_path / "port" / "dataset.json").read_text())
    assert manifest["record_dtype"] == kw.get("record_dtype", "uint8")
    assert manifest["num_examples"] == 6 and manifest["num_shards"] == 2


def _one_pass(loader):
    try:
        out = []
        while (b := loader.next()) is not None:
            out.extend(b[0] if isinstance(b, tuple) else b)
        return sorted(r.tobytes() for r in out)
    finally:
        loader.close()


def test_shards_load_in_both_packages_loaders(tmp_path):
    """The port's uint8 shards through four loaders (native and Python,
    port and JAX), one pass on the raw pixel scale: the same examples bit
    for bit; the manifest passes both packages' checks, and the port's
    make_dataset reads them through the native loader."""
    src = _folder(tmp_path / "src", n=8)
    paths = prepare.convert(src, str(tmp_path / "out"), image_size=8,
                            crop_size=0, num_shards=2)
    kw = dict(batch=4, example_shape=(8, 8, 3), record_dtype="uint8",
              min_after_dequeue=4, n_threads=2, seed=0, loop=False,
              normalize=False)
    got = [_one_pass(cls(paths, **kw)) for cls in (
        native.NativeLoader, j_native.NativeLoader, pipeline.PythonLoader,
        j_pipeline.PythonLoader)]
    assert len(got[0]) == 8 and all(g == got[0] for g in got)
    for mod in (pipeline, j_pipeline):
        mod.check_manifest(str(tmp_path / "out"), mod.DataConfig(
            data_dir=str(tmp_path / "out"), image_size=8,
            record_dtype="uint8"))
    with pytest.raises(ValueError, match="record_dtype"):
        pipeline.check_manifest(str(tmp_path / "out"), pipeline.DataConfig(
            data_dir=str(tmp_path / "out"), image_size=8))
    cfg = pipeline.DataConfig(data_dir=str(tmp_path / "out"), image_size=8,
                              batch_size=4, record_dtype="uint8",
                              min_after_dequeue=4, n_threads=2, loop=False)
    ds = pipeline.make_dataset(cfg, "cpu")
    try:
        assert len(list(ds)) == 2
    finally:
        ds.close()


def test_jax_shards_load_in_the_port(tmp_path):
    src = _folder(tmp_path / "src", labeled=True, n=8)
    paths = j_prepare.convert(src, str(tmp_path / "out"), image_size=8,
                              crop_size=0, num_shards=2, labeled=True)
    kw = dict(batch=4, example_shape=(8, 8, 3), record_dtype="uint8",
              min_after_dequeue=4, n_threads=1, seed=0, loop=False,
              label_feature="label")
    loader = native.NativeLoader(paths, **kw)
    try:
        labels = []
        while (b := loader.next()) is not None:
            labels.extend(b[1].tolist())
    finally:
        loader.close()
    assert sorted(labels) == [0] * 4 + [1] * 4


def test_stale_shards_refused_alike(tmp_path):
    src = _folder(tmp_path / "src")
    errors = []
    for mod, out in ((prepare, "port"), (j_prepare, "jax")):
        mod.convert(src, str(tmp_path / out), image_size=8, crop_size=0)
        with pytest.raises(ValueError) as e:
            mod.convert(src, str(tmp_path / out), image_size=8, crop_size=0)
        errors.append(str(e.value).replace(out, "OUT"))
        mod.convert(src, str(tmp_path / out), image_size=8, crop_size=0,
                    num_shards=2, overwrite=True)
        assert len([f for f in os.listdir(tmp_path / out)
                    if f.endswith(".tfrecord")]) == 2
    assert errors[0] == errors[1] and "--overwrite" in errors[0]
    os.makedirs(tmp_path / "sm")
    for mod in (prepare, j_prepare):
        with pytest.raises(ValueError, match="no images"):
            mod.convert(str(tmp_path / "sm"), str(tmp_path / "x"))


def _cifar(root, n=10):
    rng = np.random.default_rng(1)
    os.makedirs(root, exist_ok=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(os.path.join(root, name), "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072),
                                               dtype=np.uint8),
                         b"labels": list(rng.integers(0, 10, n))}, f)
    return str(root)


@pytest.mark.parametrize("split", ["train", "test"])
def test_cifar10_byte_equal_to_jax(tmp_path, split):
    src = _cifar(tmp_path / "cifar")
    prepare.convert_cifar10(src, str(tmp_path / "port"), split=split,
                            num_shards=2)
    j_prepare.convert_cifar10(src, str(tmp_path / "jax"), split=split,
                              num_shards=2)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    manifest = json.loads((tmp_path / "port" / "dataset.json").read_text())
    assert manifest["num_examples"] == (50 if split == "train" else 10)
    assert manifest["label_feature"] == "label"


def test_cli_defaults_equal_jax(tmp_path):
    port = {a.dest: a.default for a in prepare.build_parser()._actions}
    jax_ = {a.dest: a.default for a in j_prepare.build_parser()._actions}
    assert port == jax_
    src = _folder(tmp_path / "src")
    prepare.main(["--input_dir", src, "--output_dir", str(tmp_path / "o"),
                  "--image_size", "8", "--crop_size", "0", "--num_shards",
                  "3"])
    manifest = json.loads((tmp_path / "o" / "dataset.json").read_text())
    assert manifest["record_dtype"] == "uint8"
    assert manifest["num_shards"] == 3


def test_import_loads_no_pil():
    code = ("import sys\nimport dcgan_tpu_torch.data.prepare\n"
            "assert 'PIL' not in sys.modules, 'PIL imported'\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
