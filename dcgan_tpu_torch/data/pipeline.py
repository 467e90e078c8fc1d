"""Input pipeline: TFRecord shards -> shuffled host batches -> tensors on
the device, prefetched (a copy of `dcgan_tpu/data/pipeline.py` without JAX).

- `DataConfig`, `list_shards`, `read_manifest`, `check_manifest` and
  `PythonLoader` are copies: reader threads parse shards into a shuffle
  pool, a batcher thread assembles batches into a bounded queue.
- `DevicePrefetcher` takes the place of the JAX package's: a background
  thread copies each host batch into pinned host memory and from there to
  the card on a side stream; the consumer's stream waits on the copy's
  event, and each tensor it takes is marked with `record_stream`.
- `use_native=True` (the default) reads through the native C++ loader
  (data/native.py, a copy of the JAX package's), `use_native=False`
  through `PythonLoader`. Unlike the JAX package, which warns and falls
  back to the Python loader when the native one fails to build or start,
  the port raises `NativeLoaderError` (with the compiler's stderr): a
  silent fallback would leave a run on a loader several times slower
  without anyone having asked for it.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import queue
import random
import struct
import threading
from typing import Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from dcgan_tpu_torch.data.example_proto import parse_example
from dcgan_tpu_torch.data.tfrecord import read_tfrecords


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Input knobs, field for field the JAX `DataConfig`."""
    data_dir: str = "train"
    image_size: int = 64
    channels: int = 3
    batch_size: int = 64
    record_dtype: str = "float64"   # on-disk pixel dtype
    min_after_dequeue: int = 10_776  # shuffle pool: 10% of a CelebA epoch
    n_threads: int = 16             # reader threads
    prefetch_batches: int = 8       # host batches queued by the loader
    prefetch_device_batches: int = 2  # device batches the prefetcher keeps
                                    # ready ahead of the consumer (a
                                    # background thread stages and copies
                                    # them); 0 = copy on the consumer's
                                    # thread, one batch at a time
    seed: int = 0
    normalize: bool = True          # [-1,1]; False = the raw pixel scale
    feature_name: str = "image_raw"
    label_feature: str = ""         # non-empty: also read an int64 label per
                                    # example and yield (images, labels)
    num_classes: int = 0            # >0: every label must be < num_classes,
                                    # checked on the host before the copy
                                    # (on the device an out-of-range label
                                    # reads silently as a zero one-hot and
                                    # a clamped cBN row)
    max_corrupt_records: int = 0    # >0: CRC and parse failures quarantine
                                    # the record (skip, log file and offset,
                                    # count, data/quarantine.py) up to this
                                    # many before failing; 0 = any corrupt
                                    # record is fatal. CRCs are verified only
                                    # when quarantine is on
    use_native: bool = True         # the C++ loader (data/native.py);
                                    # False: the Python loader
    loop: bool = True


# The manifest the JAX package's `prepare.py` writes next to its shards; the
# one filename list_shards exempts from "every file is a shard".
MANIFEST_NAME = "dataset.json"


def list_shards(data_dir: str) -> List[str]:
    """Every regular file in data_dir is a shard, except the dataset.json
    manifest."""
    paths = sorted(p for p in glob.glob(os.path.join(data_dir, "*"))
                   if os.path.isfile(p)
                   and os.path.basename(p) != MANIFEST_NAME)
    if not paths:
        raise FileNotFoundError(f"no TFRecord shards in {data_dir}")
    return paths


def read_manifest(data_dir: str) -> dict:
    """The dataset.json manifest of `data_dir`, or {} when absent: the
    trainer adopts its recorded wire format."""
    path = os.path.join(data_dir, MANIFEST_NAME)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def check_manifest(data_dir: str, cfg: "DataConfig") -> None:
    """Validate DataConfig against the dataset.json manifest, if present.

    The manifest records the knobs the records were written with; a
    mismatched DataConfig otherwise fails deep in the loader ("example has N
    values, expected M") or, for byte-coincidental sizes, silently misreads
    pixels.
    """
    manifest = read_manifest(data_dir)
    if not manifest:
        return
    checks = [
        ("image_size", cfg.image_size),
        ("channels", cfg.channels),
        ("record_dtype", cfg.record_dtype),
        ("feature_name", cfg.feature_name),
    ]
    problems = [
        f"{key}: dataset was prepared with {manifest[key]!r}, "
        f"config says {got!r}"
        for key, got in checks
        if key in manifest and manifest[key] != got
    ]
    if cfg.label_feature and manifest.get("label_feature", "") and \
            manifest["label_feature"] != cfg.label_feature:
        problems.append(
            f"label_feature: dataset has {manifest['label_feature']!r}, "
            f"config says {cfg.label_feature!r}")
    if cfg.label_feature and "label_feature" in manifest and \
            not manifest["label_feature"]:
        problems.append(
            "config requests labels but the dataset was prepared unlabeled")
    if problems:
        raise ValueError(
            f"DataConfig disagrees with "
            f"{os.path.join(data_dir, MANIFEST_NAME)}:\n  "
            + "\n  ".join(problems))


class PythonLoader:
    """Reader threads parse shards into a shuffle pool; a batcher assembles
    batches into a bounded queue."""

    def __init__(self, paths: Sequence[str], *, batch: int,
                 example_shape: Sequence[int], record_dtype: str = "float64",
                 min_after_dequeue: int = 1024, n_threads: int = 4,
                 prefetch_batches: int = 4, seed: int = 0,
                 normalize: bool = True, loop: bool = True,
                 feature_name: str = "image_raw", label_feature: str = "",
                 verify_crc: bool = False, max_corrupt_records: int = 0):
        self.batch = batch
        self.example_shape = tuple(example_shape)
        self.labeled = bool(label_feature)
        self._paths = list(paths)
        self._dtype = np.dtype(record_dtype)
        self._mad = min_after_dequeue
        # readers block when the pool is full
        self._capacity = min_after_dequeue + 3 * batch
        self._normalize = normalize
        self._loop = loop
        self._feature = feature_name
        self._label_feature = label_feature
        self._rng = random.Random(seed)
        self._verify_crc = verify_crc
        self._max_corrupt = max_corrupt_records
        self._corrupt = 0            # DISTINCT records quarantined
        self._quarantined: set = set()   # (path, offset) already counted
        self._pool: List[np.ndarray] = []
        self._pool_lock = threading.Condition()
        self._batches: "queue.Queue" = queue.Queue(maxsize=prefetch_batches)
        self._stop = False
        self._error: Optional[str] = None
        self._readers_done = 0
        n = max(1, min(n_threads, len(self._paths)))
        self._n_readers = n
        self._threads = [
            threading.Thread(target=self._read_loop, args=(t, n), daemon=True)
            for t in range(n)]
        self._threads.append(
            threading.Thread(target=self._batch_loop, daemon=True))
        for t in self._threads:
            t.start()

    def _decode(self, payload: bytes) -> np.ndarray:
        n = int(np.prod(self.example_shape))
        arr = np.frombuffer(payload, dtype=self._dtype)
        if arr.size != n:
            raise ValueError(
                f"example has {arr.size} values, expected {n}")
        x = arr.astype(np.float32).reshape(self.example_shape)
        if self._normalize:
            x = x / 127.5 - 1.0
        return x

    @property
    def corrupt_records(self) -> int:
        """Records this loader has quarantined so far."""
        return self._corrupt

    def _quarantine(self, path: str, offset: int, reason: str) -> None:
        """Count one skipped record; raises CorruptRecordError past the
        budget (data/quarantine.py owns the log line and the process-wide
        tally the trainer surfaces as data/corrupt_records). A looping
        dataset re-encounters the same bad record every epoch — repeats are
        skipped silently, so the budget bounds DISTINCT corrupt records,
        not epochs survived."""
        from dcgan_tpu_torch.data import quarantine

        with self._pool_lock:
            if (path, offset) in self._quarantined:
                return
            self._quarantined.add((path, offset))
            self._corrupt += 1
            seen = self._corrupt
        quarantine.record(path, offset, reason,
                          budget=self._max_corrupt, seen=seen)

    def _read_loop(self, tid: int, n_threads: int) -> None:
        quarantining = self._max_corrupt > 0
        try:
            while not self._stop:
                read_any = False
                for i in range(tid, len(self._paths), n_threads):
                    path = self._paths[i]
                    on_corrupt = (
                        (lambda off, why, p=path: self._quarantine(p, off,
                                                                   why))
                        if quarantining else None)
                    for off, rec in read_tfrecords(
                            path, verify_crc=self._verify_crc,
                            on_corrupt=on_corrupt, with_offsets=True):
                        try:
                            feats = parse_example(rec)
                            if self._feature not in feats:
                                raise ValueError(
                                    "record missing feature "
                                    f"{self._feature!r}")
                            x = self._decode(feats[self._feature][0])
                            if self.labeled:
                                lab = feats.get(self._label_feature)
                                if not lab:
                                    raise ValueError(
                                        "record missing int64 feature "
                                        f"{self._label_feature!r}")
                                # reject rather than silently wrap or
                                # round class ids
                                if not 0 <= int(lab[0]) <= (1 << 24):
                                    raise ValueError(
                                        f"label {int(lab[0])} out of range "
                                        "[0, 2^24]")
                                x = (x, np.int32(lab[0]))
                        except (ValueError, IndexError, KeyError,
                                struct.error) as e:
                            # parse-layer corruption: quarantine the record
                            # like a CRC failure, or fail-fast when off.
                            # parse_example surfaces malformed proto bytes
                            # as struct.error/IndexError, not just
                            # ValueError — all of them are data faults here
                            if not quarantining:
                                raise
                            self._quarantine(path, off,
                                             f"{type(e).__name__}: {e}")
                            continue
                        read_any = True
                        with self._pool_lock:
                            self._pool_lock.wait_for(
                                lambda: len(self._pool) < self._capacity
                                or self._stop)
                            if self._stop:
                                return
                            self._pool.append(x)
                            self._pool_lock.notify_all()
                if not self._loop or not read_any:
                    break
        except Exception as e:  # surface errors to the consumer
            self._error = str(e)
        finally:
            with self._pool_lock:
                self._readers_done += 1
                self._pool_lock.notify_all()

    def _batch_loop(self) -> None:
        while not self._stop:
            with self._pool_lock:
                def ready():
                    done = self._readers_done == self._n_readers
                    return (self._stop or self._error or
                            len(self._pool) >= self._mad + self.batch or
                            (done and len(self._pool) >= self.batch) or
                            (done and not self._loop))
                self._pool_lock.wait_for(ready)
                if self._stop or self._error:
                    self._batches.put(None)
                    return
                if len(self._pool) < self.batch:
                    self._batches.put(None)  # end of data
                    return
                picked = []
                for _ in range(self.batch):
                    j = self._rng.randrange(len(self._pool))
                    self._pool[j], self._pool[-1] = (self._pool[-1],
                                                     self._pool[j])
                    picked.append(self._pool.pop())
                self._pool_lock.notify_all()  # wake readers waiting for space
            if self.labeled:
                self._batches.put((np.stack([p[0] for p in picked]),
                                   np.asarray([p[1] for p in picked],
                                              dtype=np.int32)))
            else:
                self._batches.put(np.stack(picked))

    def next(self):
        """Next [B, ...] batch — an (images, int32 labels) pair when labeled —
        or None at end-of-data."""
        b = self._batches.get()
        if b is None and self._error:
            raise RuntimeError(self._error)
        return b

    def __iter__(self):
        while True:
            b = self.next()
            if b is None:
                return
            yield b

    def close(self):
        self._stop = True
        with self._pool_lock:
            self._pool_lock.notify_all()
        try:
            while True:
                self._batches.get_nowait()
        except queue.Empty:
            pass


def _make_loader(cfg: DataConfig, paths: Sequence[str], seed: int):
    shape = (cfg.image_size, cfg.image_size, cfg.channels)
    kwargs = dict(batch=cfg.batch_size, example_shape=shape,
                  record_dtype=cfg.record_dtype,
                  min_after_dequeue=cfg.min_after_dequeue,
                  n_threads=cfg.n_threads,
                  prefetch_batches=cfg.prefetch_batches, seed=seed,
                  normalize=cfg.normalize, loop=cfg.loop,
                  feature_name=cfg.feature_name,
                  label_feature=cfg.label_feature,
                  max_corrupt_records=cfg.max_corrupt_records)
    if cfg.use_native:
        from dcgan_tpu_torch.data.native import NativeLoader

        # verifies every record's CRC; a failed build or start raises
        return NativeLoader(paths, **kwargs)
    # the pure-Python CRC pass runs only under quarantine: detecting a
    # payload flip needs it, and it costs a pass over every byte
    return PythonLoader(paths, verify_crc=cfg.max_corrupt_records > 0,
                        **kwargs)


def _as_tuple(batch):
    return batch if isinstance(batch, tuple) else (batch,)


def check_labels(batch, num_classes: int) -> None:
    """The host-side label range check of a labelled batch (the JAX
    package's `_check_labels`, with its message)."""
    labels = batch[1]
    bad = int(labels.max(initial=0))
    if bad >= num_classes or int(labels.min(initial=0)) < 0:
        raise ValueError(
            f"label {bad} out of range for num_classes="
            f"{num_classes} (dataset/config mismatch; on device "
            "this would silently one-hot to zeros or clamp the cBN "
            "table gather)")


class DevicePrefetcher:
    """Background device feed: host batches -> a bounded queue of tensors
    on `device`.

    One producer thread pulls `host_iter` and stages each batch. On a CUDA
    device it copies the batch into one of two pinned host buffers
    (waiting first for that buffer's previous copy to finish) and from
    there to the card on a side stream, recording an event; the consumer's
    stream waits on that event and `record_stream` marks each tensor for
    it, so the allocator does not reuse its memory while the consumer's
    work is queued. On the CPU a batch becomes a tensor that shares the
    numpy array's memory.

    Order is the host iterator's. With `num_classes` the labels of a
    labelled batch are range-checked (`check_labels`) before the copy. A
    producer exception re-raises on the consumer thread at the next
    `__next__`. `close()` is idempotent, safe mid-epoch, and closes
    `owner` (the loader) when given.
    """

    _SENTINEL = object()

    def __init__(self, host_iter: Iterator, device: Union[str, torch.device],
                 *, depth: int = 2, num_classes: int = 0, owner=None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._host_iter = host_iter
        self._device = torch.device(device)
        self._cuda = self._device.type == "cuda"
        if self._cuda and self._device.index is None:
            # the producer thread sets its device, which needs an index
            self._device = torch.device("cuda", torch.cuda.current_device())
        self._owner = owner
        self._num_classes = num_classes
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        if self._cuda:
            self._stream = torch.cuda.Stream(device=self._device)
            # two pinned staging buffers per batch element: one fills while
            # the other's copy to the card may still run
            self._pinned: List[List[torch.Tensor]] = [[], []]
            self._copied: List[Optional[torch.cuda.Event]] = [None, None]
        self._thread = threading.Thread(
            target=self._produce, name="dcgan-device-feed", daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Queue put that stays interruptible by close()."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _stage(self, batch, slot: int):
        """One host batch on the device: (tensors, copy event or None)."""
        srcs = [torch.from_numpy(a) for a in _as_tuple(batch)]
        if not self._cuda:
            return tuple(srcs), None
        done = self._copied[slot]
        if done is not None:
            done.synchronize()
        bufs = self._pinned[slot]
        if [(b.shape, b.dtype) for b in bufs] != [(s.shape, s.dtype)
                                                  for s in srcs]:
            bufs[:] = [torch.empty(s.shape, dtype=s.dtype, pin_memory=True)
                       for s in srcs]
        out = []
        with torch.cuda.stream(self._stream):
            for buf, src in zip(bufs, srcs):
                buf.copy_(src)
                out.append(buf.to(self._device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(self._stream)
        self._copied[slot] = event
        return tuple(out), event

    def _produce(self) -> None:
        try:
            if self._cuda:
                torch.cuda.set_device(self._device)
            slot = 0
            for batch in self._host_iter:
                if self._stop.is_set():
                    return
                if self._num_classes and isinstance(batch, tuple):
                    check_labels(batch, self._num_classes)
                staged = self._stage(batch, slot)
                slot ^= 1
                if not self._put((isinstance(batch, tuple), staged)):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised on consumer
            self._error = e
        finally:
            self._put(self._SENTINEL)

    def __iter__(self) -> "DevicePrefetcher":
        return self

    def __next__(self):
        while True:
            if self._stop.is_set():
                raise StopIteration
            try:
                item = self._queue.get(timeout=0.5)
            except queue.Empty:
                # producer still filling (or wedged on a slow loader):
                # keep waiting unless it died with an error
                if self._error is not None and not self._thread.is_alive():
                    self._raise()
                continue
            if item is self._SENTINEL:
                if self._error is not None:
                    self._raise()
                raise StopIteration
            labeled, (tensors, event) = item
            if event is not None:
                stream = torch.cuda.current_stream(self._device)
                stream.wait_event(event)
                for t in tensors:
                    t.record_stream(stream)
            return tensors if labeled else tensors[0]

    def _raise(self):
        err = self._error
        self._error = None
        self.close()
        # the producer's exception with its own type and traceback:
        # consumers match on the loader's error classes
        raise err

    def close(self) -> None:
        """Stop the producer and release the loader. Mid-epoch safe: queued
        batches are discarded. A producer parked inside the loader must be
        unblocked by the loader itself, and releasing the loader while the
        producer is still inside it is a use-after-free for a loader with
        native state, so the order is: a non-destructive owner `stop()`
        (unblocks the producer), join, then the owner's `close()`. An owner
        without `stop()` (the Python loader) is closed before the join: its
        close is what unblocks the producer, and frees no native state."""
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        owner, self._owner = self._owner, None
        stop = getattr(owner, "stop", None)
        if callable(stop):
            stop()
        elif owner is not None and hasattr(owner, "close"):
            owner.close()
            owner = None
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)
        if self._cuda and not self._thread.is_alive():
            # no copy out of the pinned buffers may outlive them
            self._stream.synchronize()
        if owner is not None and hasattr(owner, "close"):
            owner.close()

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _inline_feed(loader, device: torch.device,
                 num_classes: int = 0) -> Iterator:
    """prefetch_device_batches=0: each batch copied to the device on the
    consumer's thread when it asks for it; closing the generator closes
    the loader."""
    try:
        for batch in loader:
            if num_classes and isinstance(batch, tuple):
                check_labels(batch, num_classes)
            out = tuple(torch.from_numpy(a).to(device)
                        for a in _as_tuple(batch))
            yield out if isinstance(batch, tuple) else out[0]
    finally:
        loader.close()


def make_dataset(cfg: DataConfig,
                 device: Union[str, torch.device, None] = None) -> Iterator:
    """Endless (or one-epoch, cfg.loop=False) iterator of batches.

    Without `device`, yields host numpy batches straight from the loader.
    With one, yields tensors on it: through a DevicePrefetcher when
    cfg.prefetch_device_batches > 0 (the default), else copied on the
    consumer's thread. Call `.close()` on the result to release its threads
    and the loader. With cfg.label_feature set, yields (images, labels).
    """
    check_manifest(cfg.data_dir, cfg)
    loader = _make_loader(cfg, list_shards(cfg.data_dir), cfg.seed)
    if device is None:
        return iter(loader)
    num_classes = cfg.num_classes if cfg.label_feature else 0
    if cfg.prefetch_device_batches > 0:
        return DevicePrefetcher(iter(loader), device,
                                depth=cfg.prefetch_device_batches,
                                num_classes=num_classes, owner=loader)
    return _inline_feed(loader, torch.device(device), num_classes)
