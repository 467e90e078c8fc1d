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
spills) is kept beside it as `<lib>.log`; `ptxas_report` reads it per
kernel. `sass_counts` counts chosen instructions per kernel in
`cuobjdump -sass` of a built library (`sass`), to show which hardware
units a kernel's machine code uses.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

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


def ptxas_report(text: str) -> List[Dict[str, object]]:
    """One entry per kernel of an `nvcc -Xptxas -v` log, in its order:
    {"entry": mangled name, "registers", "stack", "spill_stores",
    "spill_loads"} (bytes for the last three)."""
    entries: List[Dict[str, object]] = []
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entries.append({"entry": m.group(1)})
            continue
        if not entries:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            entries[-1].update(stack=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entries[-1]["registers"] = int(m.group(1))
    return entries


def sass_counts(text: str, opcodes: Sequence[str]
                ) -> Dict[str, Dict[str, int]]:
    """{kernel: {opcode: count}} over the `Function : <mangled name>`
    sections of `cuobjdump -sass` output: an instruction counts for an
    opcode it equals or extends with modifiers (HGMMA counts
    `HGMMA.64x256x16.F32.BF16`, MUFU.EX2 counts `MUFU.EX2`, not
    `MUFU.RCP`); a predicate guard (`@P0`, `@!UPT`) is skipped."""
    out: Dict[str, Dict[str, int]] = {}
    counts = None
    for line in text.splitlines():
        m = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if m:
            counts = out.setdefault(m.group(1), dict.fromkeys(opcodes, 0))
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", line)
        if counts is None or not m:
            continue
        op = m.group(1)
        for name in opcodes:
            if op == name or op.startswith(name + "."):
                counts[name] += 1
    return out


def sass(library: Path) -> str:
    """`cuobjdump -sass` (beside nvcc) of a built library."""
    tool = Path(_nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout


def demangle(names: Sequence[str]) -> List[str]:
    """The names as `cu++filt -p` (beside nvcc) prints them: demangled,
    without parameter lists."""
    if not names:
        return []
    filt = Path(_nvcc()).with_name("cu++filt")
    out = subprocess.run([str(filt), "-p", *names], capture_output=True,
                         text=True, check=True).stdout.splitlines()
    if len(out) != len(names):
        raise RuntimeError(f"cu++filt printed {len(out)} lines for "
                           f"{len(names)} names")
    return out


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
