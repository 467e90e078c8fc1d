"""The port's native C++ TFRecord loader (dcgan_tpu_torch/data/native.py
and data/native/loader.cc) against `dcgan_tpu`'s NativeLoader and the
port's PythonLoader, built with g++ here as it is on the card's host.

- One pass (loop=False) over shards written by the port, with three reader
  threads, for float64, float32 and uint8 records: the multiset of decoded
  examples equals the JAX NativeLoader's bit for bit, and the port's
  PythonLoader's bit for bit on the raw pixel scale (normalize=False).
  Normalized, the Python loader computes x / 127.5 - 1 and the C++ one
  x * (1 / 127.5f) - 1, which differ by one f32 ulp on 111 of the 256
  byte values: held to 2^-23 (the same holds between the JAX package's
  two loaders).
- With one reader thread and a pool that holds every example the order is
  fixed: the same batches in the same order as the JAX NativeLoader.
- Errors, message for message with the JAX NativeLoader: a data CRC
  mismatch, a missing feature, a label out of range, the corrupt-record
  budget; a quarantined record counts once in the process-wide tally.
- A failed build raises NativeLoaderError from make_dataset, with no
  fallback; stop() ends a consumer parked in next(); the device
  prefetcher's close stops, joins, then frees the loader; the trainer
  feeds from the native loader by default.
"""

import os
import threading

import numpy as np
import pytest
import torch

from dcgan_tpu.data import native as j_native
from dcgan_tpu.data import quarantine as j_quarantine
from dcgan_tpu_torch.config import ModelConfig, TrainConfig
from dcgan_tpu_torch.data import native, pipeline, quarantine
from dcgan_tpu_torch.data.example_proto import serialize_example
from dcgan_tpu_torch.data.synthetic import write_image_tfrecords
from dcgan_tpu_torch.data.tfrecord import write_tfrecords
from dcgan_tpu_torch.train import trainer
from torch_jax_draws import one_torch_thread  # noqa: F401

SIZE = 8
N = 48


def _shards(root, dtype, n=N, shards=3, **kw):
    return write_image_tfrecords(str(root), num_examples=n,
                                 image_size=SIZE, channels=3,
                                 num_shards=shards, record_dtype=dtype, **kw)


def _one_pass(loader):
    """Every batch of one pass (loop=False), the loader closed after."""
    try:
        out = []
        while (b := loader.next()) is not None:
            out.append(b)
        return out
    finally:
        loader.close()


def _rows(batches):
    """The multiset of examples as sorted byte strings."""
    return sorted(row.tobytes() for b in batches for row in b)


def _kw(dtype, **extra):
    kw = dict(batch=6, example_shape=(SIZE, SIZE, 3), record_dtype=dtype,
              min_after_dequeue=8, n_threads=3, seed=0, loop=False)
    kw.update(extra)
    return kw


@pytest.mark.parametrize("dtype", ["float64", "float32", "uint8"])
def test_one_pass_multiset_equals_jax_and_python(tmp_path, dtype):
    paths = _shards(tmp_path, dtype)
    port = _one_pass(native.NativeLoader(paths, **_kw(dtype)))
    jax_ = _one_pass(j_native.NativeLoader(paths, **_kw(dtype)))
    assert len(port) == len(jax_) == N // 6
    assert all(b.dtype == np.float32 and b.shape == (6, SIZE, SIZE, 3)
               for b in port)
    assert _rows(port) == _rows(jax_)
    raw = _one_pass(native.NativeLoader(paths,
                                        **_kw(dtype, normalize=False)))
    py_raw = _one_pass(pipeline.PythonLoader(paths,
                                             **_kw(dtype, normalize=False)))
    assert _rows(raw) == _rows(py_raw)
    py = _one_pass(pipeline.PythonLoader(paths, **_kw(dtype)))

    def by_value(batches):
        # rows paired across loaders by their leading values, which a
        # one-ulp difference does not reorder
        rows = [r.reshape(-1) for b in batches for r in b]
        return np.stack(sorted(rows, key=lambda r: tuple(np.round(r[:8],
                                                                  4))))
    a, b = by_value(port), by_value(py)
    assert float(np.abs(a - b).max()) <= 2.0 ** -23
    assert -1.0 <= float(a.min()) and float(a.max()) <= 1.0


def test_fixed_order_equals_jax(tmp_path):
    """One reader thread, a pool that holds every example: the batcher
    starts when the reader is done, and the same seeded mt19937_64 picks
    the same batches in the same order."""
    paths = _shards(tmp_path, "uint8")
    kw = _kw("uint8", n_threads=1, min_after_dequeue=N, seed=7)
    port = _one_pass(native.NativeLoader(paths, **kw))
    jax_ = _one_pass(j_native.NativeLoader(paths, **kw))
    assert len(port) == len(jax_) == N // 6
    for x, y in zip(port, jax_):
        np.testing.assert_array_equal(x, y)


def test_large_records_take_the_interleaved_crc(tmp_path):
    """64 px float64 records (98 KB payloads) run the 3-way interleaved
    hardware CRC over 12 KB blocks against CRCs written by the Python
    writer; the values round-trip exactly (normalize=False)."""
    img = np.random.default_rng(7).uniform(
        0.0, 255.0, size=(64, 64, 3)).astype(np.float64)
    path = str(tmp_path / "big.tfrecord")
    write_tfrecords(path, [serialize_example({"image_raw": [img.tobytes()]})]
                    * 4)
    with native.NativeLoader([path], batch=4, example_shape=(64, 64, 3),
                             min_after_dequeue=4, n_threads=1,
                             normalize=False) as ld:
        b = ld.next()
    np.testing.assert_array_equal(b, np.broadcast_to(
        img.astype(np.float32), (4, 64, 64, 3)))


def _flip_payload(path, record):
    """Flip one pixel byte of record `record` of a shard of equal-size
    records."""
    raw = bytearray(open(path, "rb").read())
    length = int.from_bytes(raw[:8], "little")
    raw[record * (16 + length) + 12 + 100] ^= 0x40
    open(path, "wb").write(bytes(raw))


def _errors(paths, **kw):
    """Each package's NativeLoader error message over one pass."""
    out = []
    for mod in (native, j_native):
        with pytest.raises(mod.NativeLoaderError) as e:
            _one_pass(mod.NativeLoader(paths, **kw))
        out.append(str(e.value))
    return out


@pytest.mark.parametrize("case", ["crc", "feature", "label"])
def test_errors_equal_jax(tmp_path, case):
    kw = _kw("uint8", n_threads=1)
    if case == "crc":
        paths = _shards(tmp_path, "uint8", shards=1)
        _flip_payload(paths[0], 3)
        want = "data CRC mismatch"
    elif case == "feature":
        paths = _shards(tmp_path, "uint8", shards=1)
        kw["feature_name"] = "pixels"
        want = "record missing feature 'pixels'"
    else:
        path = str(tmp_path / "labels.tfrecord")
        pix = np.zeros((SIZE, SIZE, 3), np.uint8).tobytes()
        write_tfrecords(path, [serialize_example(
            {"image_raw": [pix], "label": [lab]}) for lab in
            (1, 2, (1 << 24) + 1, 3)])
        paths = [path]
        kw.update(label_feature="label", batch=2)
        want = "label 16777217 out of range [0, 2^24]"
    port, jax_ = _errors(paths, **kw)
    assert port == jax_ and want in port


def test_corrupt_budget_and_quarantine_tally(tmp_path):
    """Two flipped records: with a budget of 2 both are skipped and each
    counted once in the process-wide tally (mirrored through
    quarantine.add) over two passes of a looping loader; with a budget of
    1 the second fails the stream with the JAX message."""
    paths = _shards(tmp_path, "uint8", shards=1)
    _flip_payload(paths[0], 3)
    _flip_payload(paths[0], 10)
    quarantine.reset()
    j_quarantine.reset()
    # one reader and a pool that holds every record: the same 42 of the 46
    # intact records in both packages (a pass drops the last partial batch)
    kw = _kw("uint8", n_threads=1, min_after_dequeue=N,
             max_corrupt_records=2)
    port = _one_pass(native.NativeLoader(paths, **kw))
    jax_ = _one_pass(j_native.NativeLoader(paths, **kw))
    assert _rows(port) == _rows(jax_) and len(_rows(port)) == 42
    assert quarantine.count() == j_quarantine.count() == 2
    quarantine.reset()
    with native.NativeLoader(paths, **dict(kw, loop=True)) as ld:
        for _ in range(20):   # more than two passes of 46 examples
            ld.next()
        assert ld.corrupt_records == 2
    assert quarantine.count() == 2
    port, jax_ = _errors(paths, **dict(kw, max_corrupt_records=1))
    assert port == jax_ and "budget 1 exhausted" in port
    quarantine.reset()
    j_quarantine.reset()


def test_stop_ends_a_consumer_parked_in_next(tmp_path):
    """stop() from another thread ends a looping stream whether the
    consumer is inside next() or between calls, without freeing the
    handle; close() after the join is safe."""
    ld = native.NativeLoader(_shards(tmp_path, "uint8"),
                             **_kw("uint8", loop=True))
    first = threading.Event()
    shapes = []

    def consume():
        while True:
            b = ld.next()
            first.set()
            if b is None:
                return
            shapes.append(b.shape)

    t = threading.Thread(target=consume)
    t.start()
    assert first.wait(timeout=10.0)
    ld.stop()
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert all(s == (6, SIZE, SIZE, 3) for s in shapes)
    ld.close()


def test_prefetcher_stops_joins_then_closes(tmp_path):
    """make_dataset on the CPU with the native loader (the default): the
    prefetcher's thread drives next(); close() mid-stream stops the
    loader, joins the thread, then frees the handle."""
    _shards(tmp_path, "uint8")
    cfg = pipeline.DataConfig(data_dir=str(tmp_path), image_size=SIZE,
                              batch_size=6, min_after_dequeue=8,
                              n_threads=3, record_dtype="uint8")
    assert cfg.use_native
    ds = pipeline.make_dataset(cfg, "cpu")
    loader = ds._owner
    assert isinstance(loader, native.NativeLoader)
    for _ in range(3):
        assert tuple(next(ds).shape) == (6, SIZE, SIZE, 3)
    ds.close()
    assert not ds._thread.is_alive() and loader._handle is None


def test_failed_build_raises_without_fallback(tmp_path, monkeypatch):
    """A compiler that cannot run: NativeLoaderError from make_dataset,
    naming the command; no Python loader is made."""
    _shards(tmp_path / "data", "uint8")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    made = []
    monkeypatch.setattr(pipeline.PythonLoader, "__init__",
                        lambda *a, **k: made.append(a))
    cfg = pipeline.DataConfig(data_dir=str(tmp_path / "data"),
                              image_size=SIZE, record_dtype="uint8")
    with pytest.raises(native.NativeLoaderError, match="no-such-g"):
        pipeline.make_dataset(cfg, "cpu")
    assert not made and not os.listdir(tmp_path / "build")


def test_build_is_keyed_by_the_source_hash():
    path = native.build_library()
    assert os.path.basename(path).startswith("libdcgan_loader_")
    assert path == native.library_path() and os.path.exists(path)
    assert os.path.dirname(path).endswith(os.path.join("dcgan_tpu_torch",
                                                       "_build"))


def test_trainer_feeds_from_the_native_loader(tmp_path):
    _shards(tmp_path / "data", "uint8", n=24)
    cfg = TrainConfig(model=ModelConfig(output_size=SIZE, base_size=4,
                                        gf_dim=8, df_dim=8, z_dim=8),
                      batch_size=4, data_dir=str(tmp_path / "data"),
                      shuffle_buffer=8, num_loader_threads=2,
                      record_dtype="uint8")
    data = trainer.make_data(cfg, torch.device("cpu"))
    try:
        assert isinstance(data._owner, native.NativeLoader)
        assert tuple(next(data).shape) == (4, SIZE, SIZE, 3)
    finally:
        data.close()
