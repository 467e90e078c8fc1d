"""ctypes bindings for the native C++ TFRecord loader (data/native/loader.cc,
a copy of the JAX package's), built on first use.

The shared library is compiled with `g++ -std=c++17 -O3 -shared -fPIC
-pthread` at the first `NativeLoader`, never at import, into the
git-ignored `dcgan_tpu_torch/_build/`, named after a hash of the source (a
changed source builds a new library). Each process compiles to a temp file
of its own and installs it with `os.replace`, so concurrent builds do
not clobber each other. A build that fails raises `NativeLoaderError` with
the compiler's stderr; nothing falls back to the Python loader (the JAX
package warns and falls back; data/pipeline.py says why the port does
not).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Sequence

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "native", "loader.cc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "_build")
# the compiler; a test points it at a missing one
CXX = "g++"

_lib = None
_lib_lock = threading.Lock()


class NativeLoaderError(RuntimeError):
    """The native loader failed to build, to start, or to read its
    shards."""


def library_path() -> str:
    """Where the library of the current source is (built or not)."""
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libdcgan_loader_{tag}.so")


def build_library() -> str:
    """The library's path, compiling it first if it is not there."""
    so_path = library_path()
    if os.path.exists(so_path):
        return so_path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp_path = f"{so_path}.{os.getpid()}.tmp"
    cmd = [CXX, "-std=c++17", "-O3", "-shared", "-fPIC", "-pthread", _SRC,
           "-o", tmp_path]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
            FileNotFoundError) as e:
        detail = getattr(e, "stderr", b"") or b""
        if isinstance(detail, bytes):
            detail = detail.decode(errors="replace")
        raise NativeLoaderError(
            f"native loader build failed ({' '.join(cmd)}): {e}\n{detail}"
        ) from e
    os.replace(tmp_path, so_path)
    return so_path


def _get_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            lib.dcgan_loader_create.restype = ctypes.c_void_p
            lib.dcgan_loader_create.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
                ctypes.c_longlong]
            lib.dcgan_loader_next.restype = ctypes.c_int
            lib.dcgan_loader_next.argtypes = [ctypes.c_void_p,
                                              ctypes.POINTER(ctypes.c_float),
                                              ctypes.POINTER(ctypes.c_int32)]
            lib.dcgan_loader_error.restype = ctypes.c_char_p
            lib.dcgan_loader_error.argtypes = [ctypes.c_void_p]
            lib.dcgan_loader_corrupt_count.restype = ctypes.c_longlong
            lib.dcgan_loader_corrupt_count.argtypes = [ctypes.c_void_p]
            lib.dcgan_loader_stop.restype = None
            lib.dcgan_loader_stop.argtypes = [ctypes.c_void_p]
            lib.dcgan_loader_destroy.restype = None
            lib.dcgan_loader_destroy.argtypes = [ctypes.c_void_p]
            _lib = lib
        return _lib


_DTYPE_CODES = {"float64": 0, "float32": 1, "uint8": 2}


class NativeLoader:
    """Threaded shuffle-batch loader over TFRecord shards (loader.cc):
    reader threads verify each record's CRC32C (SSE4.2 where the CPU has
    it), parse the Example, decode float64, float32 or uint8 pixels to
    float32 into a shuffle pool; a batcher thread fills a bounded queue of
    batches. The contract of the JAX package's NativeLoader: `next()`,
    `stop()` (unblocks a `next()` on another thread without freeing the
    handle), then `close()`, and `corrupt_records`."""

    def __init__(self, paths: Sequence[str], *, batch: int,
                 example_shape: Sequence[int], record_dtype: str = "float64",
                 min_after_dequeue: int = 10_776, n_threads: int = 16,
                 prefetch_batches: int = 4, seed: int = 0,
                 normalize: bool = True, verify_crc: bool = True,
                 loop: bool = True, feature_name: str = "image_raw",
                 label_feature: str = "", max_corrupt_records: int = 0):
        if record_dtype not in _DTYPE_CODES:
            raise ValueError(f"record_dtype must be one of {list(_DTYPE_CODES)}")
        for p in paths:
            if not os.path.exists(p):
                raise FileNotFoundError(f"TFRecord shard not found: {p}")
        self._lib = _get_lib()
        self.batch = int(batch)
        self.example_shape = tuple(int(d) for d in example_shape)
        self.labeled = bool(label_feature)
        self._corrupt_synced = 0   # native count already mirrored into the
        #                            process-wide quarantine tally
        n_floats = int(np.prod(self.example_shape))
        c_paths = (ctypes.c_char_p * len(paths))(
            *[p.encode() for p in paths])
        self._handle = self._lib.dcgan_loader_create(
            c_paths, len(paths), self.batch, n_floats,
            _DTYPE_CODES[record_dtype], int(min_after_dequeue),
            int(n_threads), int(prefetch_batches), int(seed),
            int(bool(normalize)), int(bool(verify_crc)), int(bool(loop)),
            feature_name.encode(), label_feature.encode(),
            int(max_corrupt_records))
        if not self._handle:
            raise NativeLoaderError("loader_create failed")
        self._out = np.empty((self.batch,) + self.example_shape,
                             dtype=np.float32)
        self._out_labels = (np.empty((self.batch,), dtype=np.int32)
                            if self.labeled else None)

    @property
    def corrupt_records(self) -> int:
        """Records the native loader has quarantined so far."""
        if not getattr(self, "_handle", None):
            return self._corrupt_synced
        return int(self._lib.dcgan_loader_corrupt_count(self._handle))

    def _sync_corrupt_count(self) -> None:
        """Mirror the native quarantine count into the process-wide tally
        (data/quarantine.py), so that the trainer's data/corrupt_records
        covers both loaders."""
        n = self.corrupt_records
        if n > self._corrupt_synced:
            from dcgan_tpu_torch.data import quarantine

            quarantine.add(n - self._corrupt_synced)
            self._corrupt_synced = n

    def next(self):
        """Next float32 [B, ...] batch — or an ([B, ...], int32 [B]) pair for
        labeled configs — or None at end-of-data (loop=False)."""
        rc = self._lib.dcgan_loader_next(
            self._handle,
            self._out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._out_labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
            if self.labeled else None)
        self._sync_corrupt_count()
        if rc == 0:
            if self.labeled:
                return self._out.copy(), self._out_labels.copy()
            return self._out.copy()
        if rc == 1:
            return None
        raise NativeLoaderError(
            self._lib.dcgan_loader_error(self._handle).decode())

    def __iter__(self):
        while True:
            b = self.next()
            if b is None:
                return
            yield b

    def stop(self):
        """Halt the worker threads and unblock a `next()` parked on another
        thread, without freeing the native handle. A caller that drives
        `next()` from its own thread must stop, join that thread, then
        `close()`: destroying the handle while a thread is inside
        `dcgan_loader_next` is a use-after-free."""
        if getattr(self, "_handle", None):
            self._lib.dcgan_loader_stop(self._handle)

    def close(self):
        if getattr(self, "_handle", None):
            try:
                self._sync_corrupt_count()
            except Exception:
                pass
            self._lib.dcgan_loader_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
