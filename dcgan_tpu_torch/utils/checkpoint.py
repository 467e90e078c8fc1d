"""Checkpoint / resume with integrity verification (the counterpart of
`dcgan_tpu/utils/checkpoint.py::Checkpointer`).

The format is the port's own, because the GPU machine has neither JAX nor
Orbax, and an Orbax reader cannot open it:

    <dir>/<step>/state.npz        the training state, keyed by pytree path
                                  as `convert.flatten` names it
                                  (params/gen/proj/w, opt/disc/count, step)
    <dir>/integrity/<step>.json   {"step", "files": {"state.npz":
                                  {"size", "crc32"}}}

`tools/export_torch_checkpoint.py` converts an Orbax checkpoint of the JAX
package into this format, and this format into the JAX state.

The integrity contract is the JAX package's. A step is written under a
temporary name and renamed into place, so an integer-named directory is
complete; its manifest (size and crc32 per file) is then written by tmp and
rename. `restore_latest` tries the steps newest first: a stat pre-check of
the sizes, then the CRC pass over the bytes it reads. A step that fails
either is renamed `<step>.corrupt` (kept for forensics, invisible to the
step scanner) and the next-newest step is tried. A step without a manifest
(a crash between the rename and the manifest) is trusted. A restore whose
tree, shapes or dtypes disagree with the template raises and never
quarantines a step.

`save` runs asynchronously, as the JAX default does: the state is copied
to pinned host memory on a side stream, and a background thread waits for
that copy and writes the file. The copy runs while the next steps run on
the main stream and reads the tensors of the state that was passed in.
The captured step (train/warmup.py) writes its static state in place, so
`save` leaves the event that marks its host copy done in `copy_event`,
and the trainer makes the main stream wait on it (`stream.wait_event`,
on the device, not the host) before the next step: the copy never reads
a leaf that a later step is writing.

Left out for now (ROADMAP): the JAX Checkpointer's sharding sidecars and
resharding restores, multi-host saves, the progressive-schedule tag and
`delete_steps_after`.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dcgan_tpu_torch.convert import flatten, unflatten
from dcgan_tpu_torch.utils.retry import retry_io

Pytree = dict

INTEGRITY_DIRNAME = "integrity"
STATE_FILENAME = "state.npz"


def _checksum(data: bytes) -> Dict[str, int]:
    return {"size": len(data), "crc32": zlib.crc32(data) & 0xFFFFFFFF}


def _file_checksum(path: str, chunk: int = 1 << 20) -> Dict[str, int]:
    """{size, crc32} of one file, streamed."""
    size = 0
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            size += len(block)
            crc = zlib.crc32(block, crc)
    return {"size": size, "crc32": crc & 0xFFFFFFFF}


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


class Checkpointer:
    """save / maybe_save (time-throttled) / restore_latest over the port's
    training state (a nested dict of tensors)."""

    def __init__(self, directory: str, *, save_interval_secs: float = 600.0,
                 max_to_keep: int = 5, async_save: bool = True):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.save_interval_secs = save_interval_secs
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self._next_save = time.time() + save_interval_secs
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # pinned host buffers by leaf path, reused from save to save (the
        # previous save has finished with them before the next copies in)
        self._pinned: Dict[str, torch.Tensor] = {}
        self._copy_stream: Optional[torch.cuda.Stream] = None
        # the event that marks the last save's host copy done (None when
        # it copied no CUDA leaf): a step that writes the saved tensors in
        # place must wait for it
        self.copy_event: Optional[torch.cuda.Event] = None
        # {"step", "bytes", "host_copy_ms", "write_ms", "save_ms"} of the
        # last finished save
        self.last_save_stats: Optional[Dict[str, float]] = None
        # {"step", "files", "bytes_read", "verify_ms", "read_ms",
        # "restore_ms"} of the last restore (verify_ms 0 when unverified)
        self.last_restore_stats: Optional[Dict[str, float]] = None

    # -- saving ---------------------------------------------------------------

    def save(self, step: int, state: Pytree) -> None:
        """Write `state` as step `step`: the host copy is queued now, the
        file is written on a background thread (inline when async_save is
        off). Raises a failure of the previous save, and FileExistsError
        if the step is on disk already."""
        self._join()
        step = int(step)
        if os.path.exists(self._step_dir(step)):
            raise FileExistsError(
                f"checkpoint step {step} already exists in {self.directory}")
        t0 = time.perf_counter()
        host, copied = self._host_copy(flatten(state))
        self.copy_event = copied
        if not self.async_save:
            self._write(step, host, copied, t0)
            return
        self._writer = threading.Thread(
            target=self._write_or_record, args=(step, host, copied, t0),
            name="ckpt-write", daemon=True)
        self._writer.start()

    def _host_copy(self, flat: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict[str, torch.Tensor],
                              Optional[torch.cuda.Event]]:
        """Every leaf copied to host memory: CUDA leaves into pinned
        buffers on a side stream that first waits for the work queued so
        far (returns the event that marks the copies done), CPU leaves
        cloned now."""
        host: Dict[str, torch.Tensor] = {}
        copied = None
        for path, t in flat.items():
            t = t.detach()
            if t.dtype == torch.bfloat16:
                raise TypeError(f"{path}: bfloat16 leaves have no numpy "
                                "dtype; keep the state in float32")
            if t.device.type != "cuda":
                host[path] = t.clone()
                continue
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(device=t.device)
            stream = self._copy_stream
            if copied is None:
                stream.wait_stream(torch.cuda.current_stream(t.device))
                copied = torch.cuda.Event()
            buf = self._pinned.get(path)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                self._pinned[path] = buf
            with torch.cuda.stream(stream):
                buf.copy_(t, non_blocking=True)
            # the leaf's memory is not reused before the side stream has
            # read it
            t.record_stream(stream)
            host[path] = buf
        if copied is not None:
            copied.record(stream)
        return host, copied

    def _write_or_record(self, *args) -> None:
        try:
            self._write(*args)
        except BaseException as e:  # noqa: BLE001 — raised by _join
            self._error = e

    def _write(self, step: int, host: Dict[str, torch.Tensor],
               copied: Optional[torch.cuda.Event], t0: float) -> None:
        if copied is not None:
            copied.synchronize()
        t_copied = time.perf_counter()
        final = self._step_dir(step)
        tmp_dir = f"{final}.tmp-{os.getpid()}"
        shutil.rmtree(tmp_dir, ignore_errors=True)
        os.makedirs(tmp_dir)
        path = os.path.join(tmp_dir, STATE_FILENAME)
        with open(path, "wb") as f:
            np.savez(f, **{k: v.numpy() for k, v in host.items()})
            f.flush()
            os.fsync(f.fileno())
        files = {STATE_FILENAME: _file_checksum(path)}
        # a manifest left by an earlier step of this number (one marked
        # .corrupt) must not judge the new bytes
        manifest = self._manifest_path(step)
        if os.path.exists(manifest):
            os.remove(manifest)
        os.replace(tmp_dir, final)
        self._write_manifest(step, files)
        self._prune()
        t_done = time.perf_counter()
        self.last_save_stats = {
            "step": float(step),
            "bytes": float(files[STATE_FILENAME]["size"]),
            "host_copy_ms": (t_copied - t0) * 1e3,
            "write_ms": (t_done - t_copied) * 1e3,
            "save_ms": (t_done - t0) * 1e3,
        }

    def _write_manifest(self, step: int, files: Dict[str, Dict[str, int]]
                        ) -> None:
        path = self._manifest_path(step)

        def _write():
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump({"step": step, "files": files}, f, indent=1,
                          sort_keys=True)
            os.replace(tmp, path)

        retry_io(_write, tag="ckpt-manifest")

    def _prune(self) -> None:
        """Keep the newest max_to_keep steps; drop the others with their
        manifests (.corrupt steps and their manifests stay)."""
        for step in self._finalized_steps()[self.max_to_keep:]:
            shutil.rmtree(self._step_dir(step))
            try:
                os.remove(self._manifest_path(step))
            except FileNotFoundError:
                pass

    def maybe_save(self, step: int, state: Pytree) -> bool:
        """Save when save_interval_secs have passed since the last save (or
        since construction); True if it saved."""
        now = time.time()
        if now < self._next_save:
            return False
        self._next_save = now + self.save_interval_secs
        self.save(step, state)
        return True

    def _join(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def wait(self) -> None:
        """Block until the last save is on disk with its manifest; raises
        its failure."""
        self._join()

    def close(self) -> None:
        self._join()

    # -- the steps on disk ----------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self.directory, INTEGRITY_DIRNAME,
                            f"{int(step)}.json")

    def _finalized_steps(self) -> List[int]:
        """Integer-named step directories, newest first."""
        try:
            entries = os.listdir(self.directory)
        except OSError:
            return []
        return sorted((int(n) for n in entries if n.isdigit()
                       and os.path.isdir(os.path.join(self.directory, n))),
                      reverse=True)

    def latest_step(self) -> Optional[int]:
        steps = self._finalized_steps()
        return steps[0] if steps else None

    # -- restoring ------------------------------------------------------------

    def _manifest_files(self, step: int
                        ) -> Tuple[Optional[Dict[str, Dict[str, int]]], str]:
        """The step's manifest file table, or (None, why) when the step
        restores unverified: no manifest, or one that cannot be read (a
        problem of the manifest, not evidence against the state)."""
        path = self._manifest_path(step)
        if not os.path.exists(path):
            return None, "no integrity manifest (unverified)"

        def _read_manifest():
            with open(path) as f:
                return json.load(f)

        try:
            return retry_io(_read_manifest, tag="ckpt-verify")["files"], \
                "manifest"
        except (OSError, ValueError, KeyError) as e:
            return None, f"unreadable integrity manifest ({e})"

    def _stat_precheck(self, step: int,
                       files: Dict[str, Dict[str, int]]) -> Optional[str]:
        """A manifest-listed file that is missing or of the wrong size,
        from stat calls alone; the reason, or None."""
        for rel, rec in files.items():
            fpath = os.path.join(self._step_dir(step), rel)
            try:
                size = os.stat(fpath).st_size
            except FileNotFoundError:
                return f"missing file {rel!r}"
            except OSError:
                # a transient stat error gets its retries before a verdict
                # that retires the step for good
                try:
                    size = retry_io(lambda p=fpath: os.stat(p).st_size,
                                    tag="ckpt-verify")
                except OSError as e:
                    return f"unreadable file {rel!r} ({e})"
            if size != rec["size"]:
                return f"size mismatch on {rel!r} ({size} != {rec['size']})"
        return None

    def _mark_corrupt(self, step: int, why: str) -> None:
        """Rename a failing step to `<step>.corrupt` (`.corrupt.<n>` when
        that name is taken); its manifest stays beside it."""
        src = self._step_dir(step)
        dst = f"{src}.corrupt"
        n = 0
        while os.path.exists(dst):
            n += 1
            dst = f"{src}.corrupt.{n}"
        print(f"[dcgan_tpu_torch] checkpoint step {step} failed integrity "
              f"check ({why}) — marking {dst} and falling back to the "
              f"newest intact checkpoint", flush=True)
        retry_io(lambda: os.replace(src, dst), tag="ckpt-corrupt-mark")

    def restore_latest(self, template: Pytree) -> Optional[Pytree]:
        """The newest intact checkpoint as a state shaped like `template`
        (pass the freshly initialized state), its tensors on the template
        leaves' devices; None if no checkpoint exists.

        Steps are tried newest first. With a manifest: the stat pre-check,
        then the bytes are read once and CRC-checked before they are
        parsed; a step failing either is marked .corrupt and the next
        newest is tried. Without a manifest the step is read unverified
        and its errors propagate. A tree, shape or dtype that differs from
        the template raises ValueError, whatever the manifest says."""
        want = flatten(template)
        for step in self._finalized_steps():
            files, _ = self._manifest_files(step)
            if files is not None:
                bad = self._stat_precheck(step, files)
                if bad is not None:
                    self._mark_corrupt(step, bad)
                    continue
            t0 = time.perf_counter()
            step_dir = self._step_dir(step)
            names = sorted(files) if files is not None else [STATE_FILENAME]
            data = {rel: retry_io(lambda p=os.path.join(step_dir, rel):
                                  _read(p), tag="ckpt-read")
                    for rel in names}
            t_read = t_verified = time.perf_counter()
            if files is not None:
                bad = [rel for rel in names
                       if _checksum(data[rel]) != files[rel]]
                t_verified = time.perf_counter()
                if bad:
                    self._mark_corrupt(step, f"crc32 mismatch on {bad[0]!r}")
                    continue
            with np.load(io.BytesIO(data[STATE_FILENAME])) as npz:
                arrays = {k: npz[k] for k in npz.files}
            state = self._to_template(step, arrays, want)
            t_done = time.perf_counter()
            self.last_restore_stats = {
                "step": float(step),
                "files": float(len(names)),
                "bytes_read": float(sum(len(b) for b in data.values())),
                "verify_ms": (t_verified - t_read) * 1e3,
                "read_ms": ((t_read - t0) + (t_done - t_verified)) * 1e3,
                "restore_ms": (t_done - t0) * 1e3,
            }
            return state
        return None

    def _to_template(self, step: int, arrays: Dict[str, np.ndarray],
                     want: Dict[str, torch.Tensor]) -> Pytree:
        missing = sorted(set(want) - set(arrays))
        extra = sorted(set(arrays) - set(want))
        if missing or extra:
            raise ValueError(
                f"checkpoint step {step} in {self.directory} holds another "
                f"state tree: missing {missing[:8]}, unexpected {extra[:8]}")
        out = {}
        for path, leaf in want.items():
            t = torch.from_numpy(arrays[path])
            if t.shape != leaf.shape or t.dtype != leaf.dtype:
                raise ValueError(
                    f"checkpoint step {step} in {self.directory}: {path} is "
                    f"{tuple(t.shape)} {t.dtype}, the state wants "
                    f"{tuple(leaf.shape)} {leaf.dtype}")
            out[path] = t.to(leaf.device)
        return unflatten(out)
