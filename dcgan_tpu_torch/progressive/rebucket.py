"""Re-bucketing the data feed at a phase switch (the port of
`dcgan_tpu/progressive/rebucket.py`).

A phase switch changes the decode resolution (and maybe the batch),
which the native loader and the device prefetcher fix when they are
built, so the switch closes them and opens new ones: the trainer's own
factories (`train/trainer.py::make_data`, `make_sample_data`) pointed at
the phase's config, so every feed the trainer has (the native loader over
TFRecord shards, the synthetic stream) comes along.

The corrupt-record tally (data/quarantine.py) is process-wide, so it
carries across a re-open untouched and the `max_corrupt_records` budget
bounds the run, not each phase; `Rebucketer.reopen` records the tally so
the carry can be checked.

Real data: each phase's records must be of its resolution, so `data_dir`
and `sample_image_dir` may hold a literal `{res}` that resolves per phase
(`train_{res}` -> train_32, train_64, ...; `python -m
dcgan_tpu_torch.data.prepare` once per resolution). A directory without
the placeholder is used as it is. Synthetic runs need nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Optional, Tuple

from dcgan_tpu_torch.data import quarantine

RES_PLACEHOLDER = "{res}"

Feeds = Tuple[Iterator, Optional[Iterator]]


def phase_data_cfg(phase_cfg):
    """The phase's config with the `{res}` placeholders of its data
    directories resolved to the phase's resolution."""
    res = str(phase_cfg.model.output_size)
    repl = {}
    if RES_PLACEHOLDER in phase_cfg.data_dir:
        repl["data_dir"] = phase_cfg.data_dir.replace(RES_PLACEHOLDER, res)
    if RES_PLACEHOLDER in phase_cfg.sample_image_dir:
        repl["sample_image_dir"] = phase_cfg.sample_image_dir.replace(
            RES_PLACEHOLDER, res)
    return dataclasses.replace(phase_cfg, **repl) if repl else phase_cfg


def close_iterators(*iterators) -> None:
    """Stop the loaders' and prefetchers' threads; None and iterators
    without `close` are skipped. A close that fails raises: a loader that
    cannot release its threads is a leak."""
    for it in iterators:
        if it is not None and hasattr(it, "close"):
            it.close()


class Rebucketer:
    """The (train, held-out) feeds of a progressive run across its phase
    switches. `open_fn(phase_data_cfg, held_out_skip) -> (data,
    sample_data)` is the trainer's factory; `held_out_skip` is the number
    of held-out batches to fast-forward past (a resume inside a phase);
    the rebucketer adds the close-before-open order and the quarantine
    bookkeeping."""

    def __init__(self, open_fn: Callable[[object, int], Feeds]):
        self._open = open_fn
        self.data: Optional[Iterator] = None
        self.sample_data: Optional[Iterator] = None
        self.reopens = 0
        self.last_tally = 0   # the quarantine tally at the last (re)open

    def open(self, phase_cfg, held_out_skip: int = 0) -> Feeds:
        self.data, self.sample_data = self._open(phase_data_cfg(phase_cfg),
                                                 held_out_skip)
        self.last_tally = quarantine.count()
        return self.data, self.sample_data

    def reopen(self, phase_cfg) -> Feeds:
        """Close the old phase's feeds, open the new phase's from their
        first batch. The process-wide quarantine tally rides across
        untouched, recorded in `last_tally`."""
        before = quarantine.count()
        self.close()
        self.data, self.sample_data = self._open(phase_data_cfg(phase_cfg),
                                                 0)
        after = quarantine.count()
        if after < before:
            raise RuntimeError(
                "the quarantine tally went backwards across a loader "
                f"re-open ({before} -> {after})")
        self.last_tally = after
        self.reopens += 1
        return self.data, self.sample_data

    def close(self) -> None:
        close_iterators(self.data, self.sample_data)
        self.data = self.sample_data = None
