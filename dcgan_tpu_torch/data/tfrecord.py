"""TFRecord container format: a pure-Python reader and writer (a copy of
`dcgan_tpu/data/tfrecord.py`, byte for byte the same files).

Each record is

    uint64 length (little-endian)
    uint32 masked_crc32c(length_bytes)
    byte   data[length]
    uint32 masked_crc32c(data)

with CRC32C (Castagnoli polynomial 0x1EDC6F41, reflected 0x82F63B78) and the
mask rot(crc, 15) + 0xa282ead8. The JAX package computes the CRC one byte at
a time in Python (a few MB/s); here inputs of more than `_LANE` * 2 bytes
run the same table through numpy over `_LANE`-byte lanes side by side and
join the lanes' registers with the linear map of `_LANE` zero bytes, which
gives the same value (tests pin it against the original).
"""

from __future__ import annotations

import os
import struct
from typing import Iterable, Iterator, List, Optional

import numpy as np

_MASK_DELTA = 0xA282EAD8
_U32 = 0xFFFFFFFF
_LANE = 256


def _make_crc32c_table() -> List[int]:
    poly = 0x82F63B78  # reflected Castagnoli
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    return table


_TABLE = _make_crc32c_table()
_NP_TABLE = np.asarray(_TABLE, dtype=np.uint32)
# byte-indexed tables of the register map "run _LANE zero bytes", built at
# the first long input
_SHIFT: Optional[List[List[int]]] = None


def _crc_bytes(reg: int, data) -> int:
    """The CRC register after `data`, one byte at a time (no inversion)."""
    for b in data:
        reg = _TABLE[(reg ^ b) & 0xFF] ^ (reg >> 8)
    return reg


def _shift_tables() -> List[List[int]]:
    """t[k][v]: the register that bit pattern v << 8k becomes after _LANE
    zero bytes; the map is linear over GF(2), so a register's image is
    the XOR of its four bytes' entries."""
    global _SHIFT
    if _SHIFT is None:
        zeros = bytes(_LANE)
        cols = [_crc_bytes(1 << bit, zeros) for bit in range(32)]
        tables = []
        for k in range(4):
            t = [0] * 256
            for v in range(1, 256):
                low = (v & -v).bit_length() - 1
                t[v] = t[v & (v - 1)] ^ cols[8 * k + low]
            tables.append(t)
        _SHIFT = tables
    return _SHIFT


def _crc_lanes(reg: int, data) -> int:
    """The register after `data`, its first n // _LANE * _LANE bytes in
    _LANE-byte lanes updated side by side (lane 0 from `reg`, the others
    from 0), then joined: reg(A || B) = shift(reg(A)) ^ reg0(B)."""
    n_lanes = len(data) // _LANE
    body = np.frombuffer(data, dtype=np.uint8,
                         count=n_lanes * _LANE).reshape(n_lanes, _LANE)
    regs = np.zeros(n_lanes, dtype=np.uint32)
    regs[0] = reg
    for i in range(_LANE):
        regs = _NP_TABLE[(regs ^ body[:, i]) & 0xFF] ^ (regs >> 8)
    t0, t1, t2, t3 = _shift_tables()
    out = 0
    for r in regs.tolist():
        out = (t0[out & 0xFF] ^ t1[(out >> 8) & 0xFF]
               ^ t2[(out >> 16) & 0xFF] ^ t3[out >> 24]) ^ r
    return _crc_bytes(out, memoryview(data)[n_lanes * _LANE:])


def crc32c(data: bytes, crc: int = 0) -> int:
    reg = ~crc & _U32
    if len(data) >= 2 * _LANE:
        reg = _crc_lanes(reg, data)
    else:
        reg = _crc_bytes(reg, data)
    return ~reg & _U32


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & _U32


def write_tfrecords(path: str, records: Iterable[bytes]) -> int:
    """Write serialized records to `path`. Returns the record count."""
    n = 0
    with open(path, "wb") as f:
        for rec in records:
            length = struct.pack("<Q", len(rec))
            f.write(length)
            f.write(struct.pack("<I", masked_crc32c(length)))
            f.write(rec)
            f.write(struct.pack("<I", masked_crc32c(rec)))
            n += 1
    return n


def read_tfrecords(path: str, *, verify_crc: bool = False,
                   on_corrupt=None,
                   with_offsets: bool = False) -> Iterator[bytes]:
    """Yield serialized records from a TFRecord file.

    CRC verification is off by default; pass verify_crc=True to check both
    CRCs of every record.

    `on_corrupt(offset, reason)`, when given, switches corruption handling
    from raise to quarantine: the callback is invoked (it may itself raise:
    data/quarantine.py enforces its budget that way) and the reader then
    skips what it safely can. A data-CRC mismatch skips that one record
    (the framing is intact); a bad length CRC or a truncated tail abandons
    the rest of the file (the length itself is untrusted, so there is no
    safe resync point).

    `with_offsets=True` yields (file_offset, record) pairs instead of bare
    records, so a caller quarantining at the parse layer can still log the
    byte position of the record it skipped.
    """
    if not os.path.exists(path):
        raise FileNotFoundError(f"TFRecord shard not found: {path}")

    def _corrupt(offset: int, reason: str) -> bool:
        """True = quarantined (caller skips); without a callback, raises."""
        if on_corrupt is None:
            raise IOError(f"{reason} in {path}")
        on_corrupt(offset, reason)
        return True

    with open(path, "rb") as f:
        while True:
            offset = f.tell()
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                _corrupt(offset, "truncated record header")
                return
            (length,) = struct.unpack("<Q", header[:8])
            if verify_crc:
                (lcrc,) = struct.unpack("<I", header[8:12])
                if masked_crc32c(header[:8]) != lcrc:
                    # the length itself is untrusted: no resync possible
                    _corrupt(offset, "length CRC mismatch")
                    return
            data = f.read(length)
            if len(data) < length:
                _corrupt(offset, "truncated record body")
                return
            tail = f.read(4)
            if len(tail) < 4:
                _corrupt(offset, "truncated record CRC")
                return
            if verify_crc:
                (dcrc,) = struct.unpack("<I", tail)
                if masked_crc32c(data) != dcrc:
                    # framing intact: skip just this record
                    _corrupt(offset, "data CRC mismatch")
                    continue
            yield (offset, data) if with_offsets else data
