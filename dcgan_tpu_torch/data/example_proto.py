"""Minimal tf.train.Example wire-format codec, no protobuf dependency (a
copy of `dcgan_tpu/data/example_proto.py`).

The reference's records each hold one bytes feature `image_raw`. This module
speaks exactly the protobuf wire format of that schema family:

    Example  { Features features = 1; }
    Features { map<string, Feature> feature = 1; }
    Feature  { oneof { BytesList bytes_list = 1;
                       FloatList float_list = 2;
                       Int64List int64_list = 3; } }
    BytesList{ repeated bytes value = 1; }
    FloatList{ repeated float value = 1 [packed]; }
    Int64List{ repeated int64 value = 1 [packed]; }
"""

from __future__ import annotations

import struct
from typing import Dict, List, Union

FeatureValue = Union[List[bytes], List[float], List[int]]

_WT_VARINT = 0
_WT_I64 = 1
_WT_LEN = 2
_WT_I32 = 5


def _read_varint(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _write_varint(out: bytearray, value: int) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _skip_field(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == _WT_VARINT:
        _, pos = _read_varint(buf, pos)
    elif wire_type == _WT_I64:
        pos += 8
    elif wire_type == _WT_LEN:
        n, pos = _read_varint(buf, pos)
        pos += n
    elif wire_type == _WT_I32:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire_type}")
    return pos


def _iter_fields(buf: bytes):
    pos = 0
    end = len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field, wire_type = tag >> 3, tag & 7
        if wire_type == _WT_LEN:
            n, pos = _read_varint(buf, pos)
            yield field, wire_type, buf[pos:pos + n]
            pos += n
        elif wire_type == _WT_VARINT:
            v, pos = _read_varint(buf, pos)
            yield field, wire_type, v
        else:
            start = pos
            pos = _skip_field(buf, pos, wire_type)
            yield field, wire_type, buf[start:pos]


def _parse_float_list(buf: bytes) -> List[float]:
    vals: List[float] = []
    for field, wt, payload in _iter_fields(buf):
        if field == 1 and wt == _WT_LEN:  # packed
            vals.extend(struct.unpack(f"<{len(payload) // 4}f", payload))
        elif field == 1 and wt == _WT_I32:
            vals.append(struct.unpack("<f", payload)[0])
    return vals


def _parse_int64_list(buf: bytes) -> List[int]:
    vals: List[int] = []
    for field, wt, payload in _iter_fields(buf):
        if field == 1 and wt == _WT_LEN:  # packed
            pos = 0
            while pos < len(payload):
                v, pos = _read_varint(payload, pos)
                vals.append(v - (1 << 64) if v >= (1 << 63) else v)
        elif field == 1 and wt == _WT_VARINT:
            vals.append(payload - (1 << 64) if payload >= (1 << 63) else payload)
    return vals


def _parse_feature(buf: bytes) -> FeatureValue:
    for field, wt, payload in _iter_fields(buf):
        if wt != _WT_LEN:
            continue
        if field == 1:    # BytesList
            return [p for f, w, p in _iter_fields(payload)
                    if f == 1 and w == _WT_LEN]
        if field == 2:    # FloatList
            return _parse_float_list(payload)
        if field == 3:    # Int64List
            return _parse_int64_list(payload)
    return []


def parse_example(serialized: bytes) -> Dict[str, FeatureValue]:
    """serialized Example -> {feature name: list of bytes/float/int}."""
    features: Dict[str, FeatureValue] = {}
    for field, wt, payload in _iter_fields(serialized):
        if field != 1 or wt != _WT_LEN:
            continue
        # payload is Features; its field 1 entries are map entries
        for f2, w2, entry in _iter_fields(payload):
            if f2 != 1 or w2 != _WT_LEN:
                continue
            name = b""
            feat: FeatureValue = []
            for f3, w3, p3 in _iter_fields(entry):
                if f3 == 1 and w3 == _WT_LEN:
                    name = p3
                elif f3 == 2 and w3 == _WT_LEN:
                    feat = _parse_feature(p3)
            features[name.decode("utf-8")] = feat
    return features


# ---------------------------------------------------------------------------
# serialization
# ---------------------------------------------------------------------------

def _len_delimited(out: bytearray, field: int, payload: bytes) -> None:
    _write_varint(out, (field << 3) | _WT_LEN)
    _write_varint(out, len(payload))
    out.extend(payload)


def _encode_feature(value: FeatureValue) -> bytes:
    inner = bytearray()
    if value and isinstance(value[0], (bytes, bytearray)):
        blist = bytearray()
        for v in value:
            _len_delimited(blist, 1, bytes(v))
        _len_delimited(inner, 1, bytes(blist))          # bytes_list = 1
    elif value and isinstance(value[0], float):
        packed = struct.pack(f"<{len(value)}f", *value)
        flist = bytearray()
        _len_delimited(flist, 1, packed)                # packed floats
        _len_delimited(inner, 2, bytes(flist))          # float_list = 2
    else:
        packed = bytearray()
        for v in value:
            _write_varint(packed, v & ((1 << 64) - 1))
        ilist = bytearray()
        _len_delimited(ilist, 1, bytes(packed))
        _len_delimited(inner, 3, bytes(ilist))          # int64_list = 3
    return bytes(inner)


def serialize_example(features: Dict[str, FeatureValue]) -> bytes:
    fmap = bytearray()
    for name, value in features.items():
        entry = bytearray()
        _len_delimited(entry, 1, name.encode("utf-8"))
        _len_delimited(entry, 2, _encode_feature(value))
        _len_delimited(fmap, 1, bytes(entry))
    out = bytearray()
    _len_delimited(out, 1, bytes(fmap))
    return bytes(out)
