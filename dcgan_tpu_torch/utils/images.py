"""Sample-grid rendering: tanh-range batches -> a tiled PNG (a copy of
`dcgan_tpu/utils/images.py`).

The JAX package saves the PNG with PIL; the GPU machine has no PIL, so
`save_png` writes the file itself: 8-bit greyscale or RGB, one IHDR, one
zlib-compressed IDAT with filter 0 on every row, IEND. Its pixels decode
equal to PIL's file's (tests pin them).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Tuple

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def inverse_transform(images: np.ndarray) -> np.ndarray:
    """tanh range [-1,1] -> [0,1]."""
    return (np.asarray(images, dtype=np.float32) + 1.0) / 2.0


def image_grid(images: np.ndarray, grid: Tuple[int, int]) -> np.ndarray:
    """Tile [N,H,W,C] into [rows*H, cols*W, C]; N must fill the grid."""
    rows, cols = grid
    images = np.asarray(images)
    n, h, w, c = images.shape
    if n < rows * cols:
        raise ValueError(f"grid {rows}x{cols} needs {rows*cols} images, "
                         f"got {n}")
    canvas = np.zeros((rows * h, cols * w, c), dtype=images.dtype)
    for idx in range(rows * cols):
        r, col = divmod(idx, cols)
        canvas[r * h:(r + 1) * h, col * w:(col + 1) * w] = images[idx]
    return canvas


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(pixels: np.ndarray) -> bytes:
    """[H, W] or [H, W, 1 | 3] uint8 -> PNG bytes."""
    arr = np.asarray(pixels)
    if arr.dtype != np.uint8:
        raise TypeError(f"PNG pixels must be uint8, got {arr.dtype}")
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    if arr.ndim == 2:
        color_type = 0                                # greyscale
    elif arr.ndim == 3 and arr.shape[-1] == 3:
        color_type = 2                                # RGB
    else:
        raise ValueError(f"PNG pixels must be [H, W], [H, W, 1] or "
                         f"[H, W, 3], got {arr.shape}")
    h, w = arr.shape[:2]
    rows = np.ascontiguousarray(arr).reshape(h, -1)
    # each scanline starts with its filter type byte: 0, none
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (_PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_png(path: str, image01: np.ndarray) -> None:
    """Save a [H,W,C] float image in [0,1] as PNG."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = np.clip(np.asarray(image01) * 255.0, 0, 255).astype(np.uint8)
    data = encode_png(arr)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def save_sample_grid(path: str, images: np.ndarray,
                     grid: Tuple[int, int] = (8, 8)) -> None:
    """tanh-range samples -> tiled PNG on disk."""
    save_png(path, image_grid(inverse_transform(images), grid))
