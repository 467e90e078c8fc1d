"""Build and load the CUDA kernels in `dcgan_tpu_torch/csrc/`.

Each `csrc/*.cu` file is compiled by nvcc into its own shared library with a
plain C interface, loaded with ctypes (no PyTorch headers, so a build takes
seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v \
         -o _build/lib<name>-<hash>.so csrc/<name>.cu

The build runs at first use, into `dcgan_tpu_torch/_build/` (git-ignored),
keyed by a hash of every source and the flags, so an edited kernel is
rebuilt and an unchanged one is reused. All sources compile at once, one
nvcc process each. Each library's ptxas report (registers, shared memory,
spills) is kept beside it as `<lib>.log`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under /usr/local/cuda/bin); "
        "the CUDA kernels cannot be built")


def _sources() -> List[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(SRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, all at once; returns
    {name: library path}. Raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: (src, _library_path(src.stem))
               for src in _sources()}
    todo = {name: st for name, st in targets.items() if not st[1].exists()}
    if todo:
        nvcc = _nvcc()
        procs = {}
        try:
            for name, (src, lib) in todo.items():
                # unique temporary name, renamed into place when complete:
                # a concurrent builder never loads a half-written library
                tmp = lib.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
                procs[name] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True), tmp, lib)
            failures = []
            for name, (proc, tmp, lib) in procs.items():
                out, _ = proc.communicate()
                if proc.returncode != 0:
                    failures.append(f"--- nvcc {name} (exit "
                                    f"{proc.returncode}) ---\n{out}")
                    continue
                lib.with_name(lib.name + ".log").write_text(out)
                os.replace(tmp, lib)
            if failures:
                raise RuntimeError("CUDA kernel build failed:\n"
                                   + "\n".join(failures))
        finally:
            for proc, tmp, _ in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                if tmp.exists():
                    tmp.unlink()
    return {name: lib for name, (_, lib) in targets.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            paths = build_all()
            if name not in paths:
                raise KeyError(f"no kernel source csrc/{name}.cu")
            lib = ctypes.CDLL(str(paths[name]))
            _libs[name] = lib
        return lib
