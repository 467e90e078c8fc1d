"""Progressive-resolution schedule: the phase table as data (a copy of
`dcgan_tpu/progressive/schedule.py`, with its error messages).

`--progressive "32:2000,64:2000,128:*"` parses into an ordered tuple of
phases, each a (resolution, steps, batch) triple validated against the
model stack and the dispatch granule, plus an optional linear fade-in
alpha for the steps right after each switch.

Spec grammar (one string, config + CLI):

    spec   := phase ("," phase)*
    phase  := RES ":" STEPS [":" BATCH]
    STEPS  := positive int | "*"       ("*" = the rest of the run;
                                        required on the last phase: the
                                        run length stays max_steps')

Resolutions must be strictly ascending power-of-two sites of the model
stack (base_size * 2^k), and the last phase's resolution must equal
`ModelConfig.output_size`: the base config describes the final model,
earlier phases are its shallower variants. A phase's BATCH defaults to
the run's batch_size; every phase batch must keep the grad_accum
microbatch divisibility. `validate_mesh` re-checks each phase against the
device mesh; the port trains on one device, so the trainer passes
{"data": 1, "model": 1}.

This module imports neither torch nor numpy: config.py validates the
spec when a TrainConfig is built.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Phase:
    """One row of the phase table."""

    resolution: int
    steps: Optional[int]    # None = "*" (runs to the end of the run)
    batch_size: int


@dataclasses.dataclass(frozen=True)
class ProgressiveSchedule:
    """The parsed, validated phase table plus the fade knob."""

    phases: Tuple[Phase, ...]
    fade_steps: int = 0

    # -- phase arithmetic ---------------------------------------------------
    #
    # All step math is in COMPLETED-step space (the trainer's step_num):
    # phase i covers dispatches of steps [start_i, start_i + steps_i). A
    # state saved at exactly a boundary step S was produced by the OLD
    # phase (the switch happens before the first new-phase dispatch), so
    # `index_for_state` and `index_for_dispatch` differ at boundaries —
    # the restore template needs the former, the switch check the latter.

    def starts(self, total_steps: int) -> List[int]:
        """Start step of each phase, clipped to the run length — phases
        whose start lands at/after total_steps never run."""
        out, at = [], 0
        for ph in self.phases:
            out.append(at)
            at += ph.steps if ph.steps is not None else max(
                0, total_steps - at)
        return out

    def index_for_dispatch(self, step: int, total_steps: int) -> int:
        """The phase whose program dispatches step number `step`."""
        starts = self.starts(total_steps)
        i = 0
        for j, s in enumerate(starts):
            if s <= step and s < max(total_steps, 1):
                i = j
        return i

    def index_for_state(self, step: int, total_steps: int) -> int:
        """The phase that PRODUCED a state at completed-step `step` — the
        restore-template phase (a boundary-step checkpoint carries the
        pre-switch tree; see the trainer's switch ordering)."""
        return self.index_for_dispatch(max(int(step) - 1, 0), total_steps)

    def alpha_at(self, step: int, total_steps: int) -> float:
        """The fade-in alpha for dispatching step `step`: a linear ramp
        over the first `fade_steps` steps of every phase after the first
        ((t+1)/fade_steps, capped at 1.0); 1.0 always for the first phase
        or with fading off."""
        if not self.fade_steps:
            return 1.0
        i = self.index_for_dispatch(step, total_steps)
        if i == 0:
            return 1.0
        t = step - self.starts(total_steps)[i]
        return min(1.0, (t + 1) / float(self.fade_steps))

    def config_for(self, cfg, index: int):
        """The phase's TrainConfig: the base config with the model rebuilt
        at the phase resolution and the phase batch size. Everything else
        (optimizer, loss, cadences, mesh) is shared across phases."""
        ph = self.phases[index]
        return dataclasses.replace(
            cfg,
            progressive="",  # the phase config is single-shape by definition
            progressive_fade_steps=0,
            batch_size=ph.batch_size,
            model=dataclasses.replace(cfg.model,
                                      output_size=ph.resolution))

    def validate_mesh(self, mesh_shape: dict, *, spatial: bool,
                      grad_accum: int = 1) -> None:
        """Granule/divisibility checks that need the LIVE mesh: every
        phase's batch (and microbatch) must divide over the data axis, and
        under a spatial mesh every phase resolution must divide over the
        height-sharding 'model' axis. Raises ValueError naming the phase."""
        data = int(mesh_shape.get("data", 1))
        model = int(mesh_shape.get("model", 1))
        for i, ph in enumerate(self.phases):
            if ph.batch_size % data:
                raise ValueError(
                    f"progressive phase {i} (r{ph.resolution}): batch "
                    f"{ph.batch_size} does not divide over the {data}-way "
                    "data axis")
            if (ph.batch_size // grad_accum) % data:
                raise ValueError(
                    f"progressive phase {i} (r{ph.resolution}): microbatch "
                    f"{ph.batch_size // grad_accum} (batch/grad_accum) does "
                    f"not divide over the {data}-way data axis")
            if spatial and ph.resolution % model:
                raise ValueError(
                    f"progressive phase {i}: resolution {ph.resolution} "
                    f"does not divide over the {model}-way spatial height "
                    "axis")


def parse_schedule(spec: str, *, model, batch_size: int, max_steps: int,
                   steps_per_call: int = 1, grad_accum: int = 1,
                   fade_steps: int = 0) -> ProgressiveSchedule:
    """Parse + validate a `--progressive` spec against the run config.

    `model` is the run's ModelConfig (the FINAL phase's architecture);
    raises ValueError with the offending phase named on any violation.
    """
    if not spec:
        raise ValueError("empty progressive spec")
    phases: List[Phase] = []
    items = [s.strip() for s in spec.split(",") if s.strip()]
    if not items:
        raise ValueError(f"progressive spec {spec!r} has no phases")
    for i, item in enumerate(items):
        parts = item.split(":")
        if len(parts) not in (2, 3):
            raise ValueError(
                f"progressive phase {i} ({item!r}): want RES:STEPS or "
                "RES:STEPS:BATCH")
        try:
            res = int(parts[0])
        except ValueError:
            raise ValueError(
                f"progressive phase {i} ({item!r}): resolution "
                f"{parts[0]!r} is not an integer") from None
        if parts[1] == "*":
            steps: Optional[int] = None
        else:
            try:
                steps = int(parts[1])
            except ValueError:
                raise ValueError(
                    f"progressive phase {i} ({item!r}): steps {parts[1]!r} "
                    "is not an integer or '*'") from None
            if steps <= 0:
                raise ValueError(
                    f"progressive phase {i} ({item!r}): steps must be > 0")
            if steps % steps_per_call:
                raise ValueError(
                    f"progressive phase {i} ({item!r}): steps {steps} must "
                    f"be a multiple of steps_per_call={steps_per_call} so "
                    "the switch lands on a dispatch boundary")
        if len(parts) == 3:
            try:
                batch = int(parts[2])
            except ValueError:
                raise ValueError(
                    f"progressive phase {i} ({item!r}): batch {parts[2]!r} "
                    "is not an integer") from None
        else:
            batch = batch_size
        if batch <= 0:
            raise ValueError(
                f"progressive phase {i} ({item!r}): batch must be > 0")
        if batch % grad_accum:
            raise ValueError(
                f"progressive phase {i} ({item!r}): batch {batch} must be "
                f"a multiple of grad_accum={grad_accum}")
        phases.append(Phase(resolution=res, steps=steps, batch_size=batch))

    for i, ph in enumerate(phases):
        k = math.log2(ph.resolution / model.base_size) \
            if ph.resolution > 0 else -1
        if ph.resolution <= 0 or k < 1 or k != int(k):
            raise ValueError(
                f"progressive phase {i}: resolution {ph.resolution} is not "
                f"a model-stack site (base_size={model.base_size} * 2^k, "
                "k >= 1)")
        if i and ph.resolution <= phases[i - 1].resolution:
            raise ValueError(
                f"progressive phase {i}: resolutions must be strictly "
                f"ascending ({phases[i - 1].resolution} -> {ph.resolution})")
        if ph.steps is None and i != len(phases) - 1:
            raise ValueError(
                f"progressive phase {i}: '*' steps are only valid on the "
                "last phase")
    if phases[-1].steps is not None:
        raise ValueError(
            "the last progressive phase must use '*' steps (the run length "
            "is max_steps' business; a fixed final count would silently "
            "truncate or extend it)")
    if phases[-1].resolution != model.output_size:
        raise ValueError(
            f"the last progressive phase's resolution "
            f"({phases[-1].resolution}) must equal model.output_size "
            f"({model.output_size}) — the base config describes the final "
            "model; earlier phases are its shallower variants")
    fixed = sum(ph.steps for ph in phases[:-1])
    if fixed >= max_steps:
        raise ValueError(
            f"progressive fixed phases cover {fixed} steps but max_steps is "
            f"{max_steps} — the final '*' phase would never run")
    if fade_steps < 0:
        raise ValueError(f"progressive_fade_steps must be >= 0, got "
                         f"{fade_steps}")
    if fade_steps:
        if steps_per_call != 1:
            raise ValueError(
                "progressive_fade_steps > 0 requires steps_per_call=1 (the "
                "fade blend is a per-step dispatch with a per-step alpha)")
        for i, ph in enumerate(phases[1:], start=1):
            if ph.steps is not None and fade_steps > ph.steps:
                raise ValueError(
                    f"progressive_fade_steps={fade_steps} exceeds phase "
                    f"{i}'s {ph.steps} steps — the fade would never "
                    "complete inside the phase")
    return ProgressiveSchedule(phases=tuple(phases), fade_steps=fade_steps)
