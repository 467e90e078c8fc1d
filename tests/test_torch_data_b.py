"""Continued from test_torch_data.py: The port's data feed and its host-side
copies against `dcgan_tpu`'s on the CPU."""

import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

from dcgan_tpu.data import pipeline as j_pipeline
from dcgan_tpu.data import quarantine as j_quarantine
from dcgan_tpu.utils import retry as j_retry
from dcgan_tpu_torch.data import pipeline, quarantine
from dcgan_tpu_torch.utils import retry
from torch_jax_draws import one_torch_thread  # noqa: F401
from test_torch_data import (  # noqa: F401
    N_RECORDS, SIZE, TIMEOUT, _BlockingLoader, _drain, _loaders, shards)


class TestQuarantineAndRetry:
    def test_quarantine_equals_jax(self):
        quarantine.reset()
        j_quarantine.reset()
        for mod in (quarantine, j_quarantine):
            mod.record("s", 12, "data CRC mismatch", budget=2, seen=1)
            with pytest.raises(IOError, match="budget exhausted"):
                mod.record("s", 40, "data CRC mismatch", budget=1, seen=2)
        assert quarantine.count() == j_quarantine.count() == 2
        quarantine.reset()
        assert quarantine.count() == 0
        j_quarantine.reset()

    def test_retry_io_equals_jax(self):
        """Same attempts, same jittered delays, the last error re-raised."""
        for outcome in ("recovers", "fails"):
            runs = []
            for mod in (retry, j_retry):
                calls, sleeps = [], []

                def fn():
                    calls.append(1)
                    if outcome == "fails" or len(calls) < 3:
                        raise OSError(f"blip {len(calls)}")
                    return "ok"

                try:
                    got = mod.retry_io(fn, tag="ckpt-manifest",
                                       sleep=sleeps.append)
                except OSError as e:
                    got = str(e)
                runs.append((got, len(calls), sleeps))
            assert runs[0] == runs[1]


class TestLoader:
    @pytest.mark.parametrize("manifest", [
        {"image_size": 16}, {"record_dtype": "uint8", "channels": 1},
        {"label_feature": ""}, {"image_size": SIZE, "channels": 3}])
    def test_check_manifest_equals_jax(self, tmp_path, manifest):
        (tmp_path / "dataset.json").write_text(json.dumps(manifest))
        errors = []
        for mod in (pipeline, j_pipeline):
            cfg = mod.DataConfig(data_dir=str(tmp_path), image_size=SIZE,
                                 label_feature="label" if "label_feature"
                                 in manifest else "")
            try:
                mod.check_manifest(str(tmp_path), cfg)
                errors.append(None)
            except ValueError as e:
                errors.append(str(e))
        assert errors[0] == errors[1]
        assert (errors[0] is None) == (manifest == {"image_size": SIZE,
                                                    "channels": 3})

    def test_same_batches_in_the_same_order(self, shards):
        """One reader thread, loop=False and a shuffle pool that holds the
        whole dataset: the batcher starts only once the reader is done, so
        the pool's order is the files' and the seeded draws alone pick each
        batch; both loaders give the same batches in the same order.
        (With a smaller pool or more readers the pool's fill at each draw
        depends on thread timing, in either package.)"""
        paths = pipeline.list_shards(str(shards))
        assert paths == j_pipeline.list_shards(str(shards))
        port, jax_ = _loaders(paths, batch=5, example_shape=(SIZE, SIZE, 3),
                              min_after_dequeue=N_RECORDS, n_threads=1,
                              seed=7, loop=False)
        a, b = _drain(port, jax_)
        assert len(a) == len(b) == N_RECORDS // 5
        for x, y in zip(a, b):
            assert x.dtype == np.float32 and x.shape == (5, SIZE, SIZE, 3)
            np.testing.assert_array_equal(x, y)
        assert -1.0 <= float(a[0].min()) and float(a[0].max()) <= 1.0

    def test_corrupt_record_quarantined_alike(self, shards, tmp_path):
        """A flipped payload byte in one record: with a budget of 2 both
        loaders skip that record alone, count one quarantine, and give the
        same batches."""
        for p in pipeline.list_shards(str(shards)):
            (tmp_path / os.path.basename(p)).write_bytes(
                open(p, "rb").read())
        victim = tmp_path / "shard-00001.tfrecord"
        raw = bytearray(victim.read_bytes())
        length = int.from_bytes(raw[:8], "little")
        raw[2 * (16 + length) + 12 + 100] ^= 0x40   # record 3's pixels
        victim.write_bytes(bytes(raw))
        paths = pipeline.list_shards(str(tmp_path))
        quarantine.reset()
        j_quarantine.reset()
        port, jax_ = _loaders(paths, batch=4, example_shape=(SIZE, SIZE, 3),
                              min_after_dequeue=N_RECORDS, n_threads=1,
                              seed=1, loop=False, verify_crc=True,
                              max_corrupt_records=2)
        a, b = _drain(port, jax_)
        assert port.corrupt_records == jax_.corrupt_records == 1
        assert quarantine.count() == j_quarantine.count() == 1
        assert len(a) == len(b) == (N_RECORDS - 1) // 4
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        quarantine.reset()
        j_quarantine.reset()

    def test_make_dataset_on_the_cpu(self, shards):
        """Tensors on the CPU equal to the loader's own batches, through
        the prefetcher and through the consumer-thread copy."""
        [want] = _drain(pipeline.PythonLoader(
            pipeline.list_shards(str(shards)), batch=6,
            example_shape=(SIZE, SIZE, 3), min_after_dequeue=N_RECORDS,
            n_threads=1, seed=2, loop=False))
        for depth in (2, 0):
            cfg = pipeline.DataConfig(
                data_dir=str(shards), image_size=SIZE, batch_size=6,
                min_after_dequeue=N_RECORDS, n_threads=1, seed=2,
                loop=False, use_native=False, prefetch_device_batches=depth)
            ds = pipeline.make_dataset(cfg, "cpu")
            try:
                got = list(ds)
            finally:
                ds.close()
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
                np.testing.assert_array_equal(g.numpy(), w)

    def test_native_loader_raises(self, shards):
        """The default DataConfig reads through the native loader (one
        pass: the Python loader's examples, tests/test_torch_native.py
        holds the bits); a record it cannot decode (the wrong record
        dtype) raises NativeLoaderError on the consumer's thread, where the
        JAX package would have fallen back to its Python loader only for a
        failed build."""
        from dcgan_tpu_torch.data.native import NativeLoaderError

        cfg = pipeline.DataConfig(data_dir=str(shards), image_size=SIZE,
                                  batch_size=6, min_after_dequeue=8,
                                  n_threads=2, loop=False)
        ds = pipeline.make_dataset(cfg, "cpu")
        try:
            got = list(ds)
        finally:
            ds.close()
        assert len(got) == N_RECORDS // 6
        bad = pipeline.make_dataset(
            dataclasses.replace(cfg, record_dtype="float32"), "cpu")
        try:
            with pytest.raises(NativeLoaderError, match="payload size"):
                next(bad)
        finally:
            bad.close()

    def test_no_shards_names_the_directory(self, tmp_path):
        for mod in (pipeline, j_pipeline):
            with pytest.raises(FileNotFoundError, match=str(tmp_path)):
                mod.list_shards(str(tmp_path))


class TestPrefetcher:
    def test_cpu_batches_in_order_and_tuples(self):
        batches = [np.full((2, 2), i, np.float32) for i in range(5)]
        with pipeline.DevicePrefetcher(iter(batches), "cpu",
                                       depth=2) as pf:
            got = [t.numpy() for t in pf]
        assert [int(g[0, 0]) for g in got] == list(range(5))
        pairs = [(np.zeros((2, 2), np.float32), np.array([1, 3], np.int32))]
        with pipeline.DevicePrefetcher(iter(pairs), "cpu") as pf:
            imgs, labels = next(pf)
        assert labels.dtype == torch.int32 and labels.tolist() == [1, 3]

    def test_producer_errors_reraise_with_their_type(self):
        def bad():
            yield np.zeros((1,), np.float32)
            raise quarantine.CorruptRecordError("budget exhausted")

        pf = pipeline.DevicePrefetcher(bad(), "cpu")
        next(pf)
        with pytest.raises(quarantine.CorruptRecordError):
            next(pf)
        pf.close()

    @pytest.mark.parametrize("with_stop", [True, False])
    def test_close_order_with_a_blocking_loader(self, with_stop):
        """An owner with stop(): stop, join, then close once the feed
        thread has ended. An owner without: its close() unblocks the
        producer. Either way the thread ends and close() returns fast."""
        ref = [None]
        loader = _BlockingLoader(ref, with_stop)
        pf = pipeline.DevicePrefetcher(iter(loader), "cpu", depth=4,
                                       owner=loader)
        ref[0] = pf
        assert next(pf) is not None
        deadline = time.monotonic() + TIMEOUT
        while "blocked" not in loader.calls and time.monotonic() < deadline:
            time.sleep(0.01)
        assert "blocked" in loader.calls
        t0 = time.monotonic()
        pf.close()
        pf.close()   # idempotent
        assert time.monotonic() - t0 < 5.0
        assert not pf._thread.is_alive()
        if with_stop:
            assert loader.calls == ["blocked", "stop", ("close", False)]
        else:
            assert loader.calls == ["blocked", ("close", True)]
        with pytest.raises(StopIteration):
            next(pf)
