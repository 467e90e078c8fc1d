"""The port's data feed and its host-side copies against `dcgan_tpu`'s on
the CPU: the TFRecord and tf.Example codecs, the TensorBoard encoders, the
sample-grid PNG, the quarantine counter, retry_io, the manifest check, the
Python loader, and the device prefetcher's CPU path and close order."""

import json
import os
import threading

import numpy as np
import pytest
from PIL import Image

from dcgan_tpu.data import example_proto as j_proto
from dcgan_tpu.data import pipeline as j_pipeline
from dcgan_tpu.data import synthetic as j_synthetic
from dcgan_tpu.data import tfrecord as j_tfrecord
from dcgan_tpu.utils import images as j_images
from dcgan_tpu.utils import metrics as j_metrics
from dcgan_tpu.utils import tb_events as j_tb
from dcgan_tpu_torch.data import example_proto, pipeline, synthetic, tfrecord
from dcgan_tpu_torch.utils import images, metrics, tb_events
from torch_jax_draws import one_torch_thread  # noqa: F401

TIMEOUT = 30.0
N_RECORDS = 24
SIZE = 8


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Two float64 shards of N_RECORDS 8x8x3 images, written by the JAX
    package's writer."""
    d = tmp_path_factory.mktemp("shards")
    j_synthetic.write_image_tfrecords(str(d), num_examples=N_RECORDS,
                                      image_size=SIZE, num_shards=2, seed=3)
    return d


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

class TestCodecs:
    @pytest.mark.parametrize("n", [0, 1, 7, 255, 511, 512, 513, 1000, 4099,
                                   98305])
    def test_crc32c_equals_jax(self, n):
        """Byte-equal to the JAX package's per-byte loop on both sides of
        the lane threshold (2 * 256 bytes) and with a running crc."""
        data = np.random.default_rng(n).integers(
            0, 256, size=n, dtype=np.uint8).tobytes()
        assert tfrecord.crc32c(data) == j_tfrecord.crc32c(data)
        assert tfrecord.crc32c(data, 0x1234ABCD) == \
            j_tfrecord.crc32c(data, 0x1234ABCD)
        assert tfrecord.masked_crc32c(data) == j_tfrecord.masked_crc32c(data)

    @pytest.mark.parametrize("features", [
        {"image_raw": [b"\x00\x01\xff" * 11]},
        {"image_raw": [b"abc", b""], "label": [3]},
        {"f": [0.5, -2.25, 1e9], "i": [-1, 0, 2 ** 40]},
        {}])
    def test_example_round_trip_equals_jax(self, features):
        ser = example_proto.serialize_example(features)
        assert ser == j_proto.serialize_example(features)
        assert example_proto.parse_example(ser) == \
            j_proto.parse_example(ser)

    @pytest.mark.parametrize("kw", [
        dict(record_dtype="float64"), dict(record_dtype="uint8"),
        dict(record_dtype="float32", num_classes=5)])
    def test_write_image_tfrecords_byte_equal(self, tmp_path, kw):
        a = j_synthetic.write_image_tfrecords(
            str(tmp_path / "jax"), num_examples=5, image_size=SIZE,
            num_shards=2, seed=4, **kw)
        b = synthetic.write_image_tfrecords(
            str(tmp_path / "port"), num_examples=5, image_size=SIZE,
            num_shards=2, seed=4, **kw)
        assert [os.path.basename(p) for p in a] == \
            [os.path.basename(p) for p in b]
        for x, y in zip(a, b):
            assert open(x, "rb").read() == open(y, "rb").read()

    def test_write_tfrecords_byte_equal(self, tmp_path):
        recs = [b"", b"x" * 600, bytes(range(256))]
        tfrecord.write_tfrecords(str(tmp_path / "a"), recs)
        j_tfrecord.write_tfrecords(str(tmp_path / "b"), recs)
        assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()

    @pytest.mark.parametrize("damage", ["flip_payload", "truncate",
                                        "flip_length"])
    def test_read_tfrecords_corruption_equals_jax(self, tmp_path, damage):
        """On a damaged file both readers yield the same records and report
        the same (offset, reason) to on_corrupt, and raise the same error
        without it."""
        path = str(tmp_path / "s")
        j_tfrecord.write_tfrecords(path, [b"a" * 40, b"b" * 40, b"c" * 40])
        raw = bytearray(open(path, "rb").read())
        if damage == "flip_payload":
            raw[56 + 12 + 5] ^= 0xFF      # inside record 2's payload
        elif damage == "truncate":
            raw = raw[:-10]
        else:
            raw[56] ^= 0x01               # record 2's length
        open(path, "wb").write(bytes(raw))
        outs = []
        for mod in (tfrecord, j_tfrecord):
            seen = []
            recs = list(mod.read_tfrecords(
                path, verify_crc=True, with_offsets=True,
                on_corrupt=lambda off, why: seen.append((off, why))))
            with pytest.raises(IOError) as err:
                list(mod.read_tfrecords(path, verify_crc=True))
            outs.append((recs, seen, str(err.value)))
        assert outs[0] == outs[1]
        assert outs[0][1], "the damage went unnoticed"


class TestTensorBoard:
    def test_encoders_byte_equal(self):
        png = images.encode_png(np.zeros((4, 6, 3), np.uint8))
        assert tb_events.encode_version_event(5.0) == \
            j_tb.encode_version_event(5.0)
        assert tb_events.encode_scalar_event("d_loss", 0.75, 9, 5.0) == \
            j_tb.encode_scalar_event("d_loss", 0.75, 9, 5.0)
        assert tb_events.encode_image_event(
            "samples", png, 12, height=4, width=6, wall_time=5.0) == \
            j_tb.encode_image_event("samples", png, 12, height=4, width=6,
                                    wall_time=5.0)
        assert tb_events.png_dimensions(png) == j_tb.png_dimensions(png) \
            == (4, 6)

    def test_writer_file_reads_back(self, tmp_path):
        """The event file is TFRecord-framed: version, a scalar and an
        image, each CRC-checked by the JAX package's reader."""
        w = tb_events.TBEventWriter(str(tmp_path))
        w.add_scalar("g_loss", 1.5, 3)
        w.add_image_png("samples", images.encode_png(
            np.full((2, 2, 3), 7, np.uint8)), 3)
        w.close()
        recs = list(j_tfrecord.read_tfrecords(w.path, verify_crc=True))
        assert len(recs) == 3 and b"brain.Event:2" in recs[0]
        assert b"g_loss" in recs[1] and b"IHDR" in recs[2]

    def test_metric_writer_matches_jax(self, tmp_path):
        """events.jsonl lines equal the JAX writer's but for the time, the
        TensorBoard file holds the same records but for their wall times,
        and ready() throttles alike."""
        png_path = str(tmp_path / "g.png")
        images.save_png(png_path, np.ones((2, 3, 3)) * 0.5)
        texts = []
        for name, cls in (("port", metrics.MetricWriter),
                          ("jax", j_metrics.MetricWriter)):
            w = cls(str(tmp_path / name), every_secs=10.0)
            w.write_scalars(4, {"d_loss": 1.25, "perf/x": 3})
            w.write_image_event(5, "samples", png_path)
            assert [w.ready(now=t) for t in (0.0, 5.0, 10.0, 19.0, 21.0)] \
                == [True, False, True, False, True]
            w.close()
            lines = [json.loads(x) for x in
                     (tmp_path / name / "events.jsonl").read_text()
                     .splitlines()]
            for e in lines:
                assert isinstance(e.pop("time"), float)
            tb = [p for p in (tmp_path / name).iterdir()
                  if p.name.startswith("events.out.tfevents.")]
            recs = list(j_tfrecord.read_tfrecords(str(tb[0]),
                                                  verify_crc=True))
            # each event past its wall time (field 1, a tag byte and a
            # double) is byte-equal
            assert all(r[0] == 0x09 for r in recs)
            texts.append((lines, [r[9:] for r in recs]))
        assert texts[0] == texts[1]
        assert len(texts[0][1]) == 4


class TestImages:
    @pytest.mark.parametrize("shape,grid", [((4, 5, 6, 3), (2, 2)),
                                            ((6, 4, 4, 1), (2, 3)),
                                            ((64, 16, 16, 3), (8, 8))])
    def test_grid_png_decodes_like_jax(self, tmp_path, shape, grid):
        x = np.tanh(np.random.default_rng(0).normal(size=shape)) \
            .astype(np.float32)
        images.save_sample_grid(str(tmp_path / "p.png"), x, grid)
        j_images.save_sample_grid(str(tmp_path / "j.png"), x, grid)
        a = np.asarray(Image.open(tmp_path / "p.png"))
        b = np.asarray(Image.open(tmp_path / "j.png"))
        assert a.shape == b.shape == (grid[0] * shape[1],
                                      grid[1] * shape[2], *shape[3:])[
            :2 if shape[3] == 1 else 3]
        np.testing.assert_array_equal(a, b)

    def test_too_few_images_raise_like_jax(self):
        for mod in (images, j_images):
            with pytest.raises(ValueError, match="needs 4 images"):
                mod.image_grid(np.zeros((3, 2, 2, 3)), (2, 2))


# ---------------------------------------------------------------------------
# the loader and the device feed
# ---------------------------------------------------------------------------

def _loaders(paths, **kw):
    return (pipeline.PythonLoader(paths, **kw),
            j_pipeline.PythonLoader(paths, **kw))


def _drain(*loaders):
    """Each loader's batches up to its end of data; every loader closed."""
    try:
        outs = []
        for loader in loaders:
            out = []
            while (b := loader.next()) is not None:
                out.append(b)
            outs.append(out)
        return outs
    finally:
        for loader in loaders:
            loader.close()


class _BlockingLoader:
    """Yields two batches, then blocks inside next() until stop() (or
    close()) releases it; records the order of stop and close, and whether
    the feed thread was still alive at close."""

    def __init__(self, prefetcher_ref, with_stop):
        self._release = threading.Event()
        self.calls = []
        self.ref = prefetcher_ref
        if with_stop:
            self.stop = self._stop

    def __iter__(self):
        for i in range(2):
            yield np.full((2, 3), i, np.float32)
        self.calls.append("blocked")
        self._release.wait(TIMEOUT)

    def _stop(self):
        self.calls.append("stop")
        self._release.set()

    def close(self):
        self.calls.append(("close", self.ref[0]._thread.is_alive()))
        self._release.set()
