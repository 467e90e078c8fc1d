"""TensorBoard event files written natively, no TF dependency (a copy of
`dcgan_tpu/utils/tb_events.py`).

It hand-encodes the proto messages TensorBoard reads for scalars, images
and histograms from precomputed bins (the activation summaries):

    Event          { double wall_time=1; int64 step=2;
                     oneof { string file_version=3; Summary summary=5; } }
    Summary        { repeated Value value=1; }
    Summary.Value  { string tag=1; oneof { float simple_value=2;
                     Image image=4; HistogramProto histo=5; } }
    Summary.Image  { int32 height=1; int32 width=2; int32 colorspace=3;
                     bytes encoded_image_string=4; }
    HistogramProto { double min=1; double max=2; double num=3;
                     double sum=4; double sum_squares=5;
                     repeated double bucket_limit=6 [packed];
                     repeated double bucket=7 [packed]; }

and frames each serialized Event as a TFRecord (data/tfrecord.py). Files
are named `events.out.tfevents.<time>.<host>`, the pattern TensorBoard
globs for, and the first record is the `brain.Event:2` version header.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional, Sequence

from dcgan_tpu_torch.data.example_proto import _len_delimited, _write_varint
from dcgan_tpu_torch.data.tfrecord import masked_crc32c

_WT_VARINT = 0
_WT_I64 = 1
_WT_I32 = 5


def _write_tag(out: bytearray, field: int, wire_type: int) -> None:
    _write_varint(out, (field << 3) | wire_type)


def _write_double(out: bytearray, field: int, value: float) -> None:
    _write_tag(out, field, _WT_I64)
    out.extend(struct.pack("<d", float(value)))


def _write_float(out: bytearray, field: int, value: float) -> None:
    _write_tag(out, field, _WT_I32)
    out.extend(struct.pack("<f", float(value)))


def _write_int(out: bytearray, field: int, value: int) -> None:
    _write_tag(out, field, _WT_VARINT)
    _write_varint(out, int(value) & ((1 << 64) - 1))


def _packed_doubles(out: bytearray, field: int,
                    values: Sequence[float]) -> None:
    payload = struct.pack(f"<{len(values)}d", *[float(v) for v in values])
    _len_delimited(out, field, payload)


def encode_histogram_event(tag: str, step: int, *,
                           bin_edges: Sequence[float],
                           bin_counts: Sequence[int],
                           minimum: float, maximum: float,
                           num: float, total: float, total_squares: float,
                           wall_time: Optional[float] = None) -> bytes:
    """A histogram from precomputed bins: len(bin_edges) ==
    len(bin_counts) + 1; bucket_limit[i] is bucket i's right edge."""
    if len(bin_edges) != len(bin_counts) + 1:
        raise ValueError(
            f"need len(bin_edges) == len(bin_counts)+1, got "
            f"{len(bin_edges)} edges / {len(bin_counts)} counts")
    histo = bytearray()
    _write_double(histo, 1, minimum)
    _write_double(histo, 2, maximum)
    _write_double(histo, 3, num)
    _write_double(histo, 4, total)
    _write_double(histo, 5, total_squares)
    _packed_doubles(histo, 6, list(bin_edges[1:]))   # right edges
    _packed_doubles(histo, 7, list(bin_counts))
    sv = bytearray()
    _len_delimited(sv, 1, tag.encode("utf-8"))
    _len_delimited(sv, 5, bytes(histo))              # Value.histo
    return _encode_event_with_summary(bytes(sv), step, wall_time)


def encode_scalar_event(tag: str, value: float, step: int,
                        wall_time: Optional[float] = None) -> bytes:
    sv = bytearray()
    _len_delimited(sv, 1, tag.encode("utf-8"))       # Value.tag
    _write_float(sv, 2, value)                       # Value.simple_value
    return _encode_event_with_summary(bytes(sv), step, wall_time)


def encode_image_event(tag: str, png_bytes: bytes, step: int, *,
                       height: int, width: int, colorspace: int = 3,
                       wall_time: Optional[float] = None) -> bytes:
    img = bytearray()
    _write_int(img, 1, height)
    _write_int(img, 2, width)
    _write_int(img, 3, colorspace)                   # 3 = RGB
    _len_delimited(img, 4, png_bytes)
    sv = bytearray()
    _len_delimited(sv, 1, tag.encode("utf-8"))
    _len_delimited(sv, 4, bytes(img))                # Value.image
    return _encode_event_with_summary(bytes(sv), step, wall_time)


def _encode_event_with_summary(value_msg: bytes, step: int,
                               wall_time: Optional[float]) -> bytes:
    summary = bytearray()
    _len_delimited(summary, 1, value_msg)            # Summary.value
    ev = bytearray()
    _write_double(ev, 1, time.time() if wall_time is None else wall_time)
    _write_int(ev, 2, step)                          # Event.step
    _len_delimited(ev, 5, bytes(summary))            # Event.summary
    return bytes(ev)


def encode_version_event(wall_time: Optional[float] = None) -> bytes:
    ev = bytearray()
    _write_double(ev, 1, time.time() if wall_time is None else wall_time)
    _len_delimited(ev, 3, b"brain.Event:2")          # Event.file_version
    return bytes(ev)


def png_dimensions(png_bytes: bytes) -> tuple:
    """(height, width) from a PNG IHDR header."""
    if png_bytes[:8] != b"\x89PNG\r\n\x1a\n" or png_bytes[12:16] != b"IHDR":
        raise ValueError("not a PNG")
    width, height = struct.unpack(">II", png_bytes[16:24])
    return height, width


class TBEventWriter:
    """Append TFRecord-framed Event protos to an events.out.tfevents.* file,
    flushed per event batch so a running TensorBoard tails it live."""

    def __init__(self, logdir: str, *, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}{filename_suffix}")
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "ab")
        self._write_record(encode_version_event())
        self.flush()

    def _write_record(self, event_bytes: bytes) -> None:
        length = struct.pack("<Q", len(event_bytes))
        self._f.write(length)
        self._f.write(struct.pack("<I", masked_crc32c(length)))
        self._f.write(event_bytes)
        self._f.write(struct.pack("<I", masked_crc32c(event_bytes)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write_record(encode_scalar_event(tag, value, step))

    def add_histogram_bins(self, tag: str, step: int, *,
                           bin_edges: Sequence[float],
                           bin_counts: Sequence[int],
                           minimum: float, maximum: float, num: float,
                           mean: float, std: float) -> None:
        """From reduced stats (activation_stats): sum and sum_squares are
        reconstructed as num * mean and num * (std^2 + mean^2)."""
        self._write_record(encode_histogram_event(
            tag, step, bin_edges=bin_edges, bin_counts=bin_counts,
            minimum=minimum, maximum=maximum, num=num, total=num * mean,
            total_squares=num * (std * std + mean * mean)))

    def add_image_png(self, tag: str, png_bytes: bytes, step: int) -> None:
        h, w = png_dimensions(png_bytes)
        self._write_record(encode_image_event(tag, png_bytes, step,
                                              height=h, width=w))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.flush()
        self._f.close()
