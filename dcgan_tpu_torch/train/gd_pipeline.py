"""Pipelined G/D dispatch: the fake-stack buffer between the stage
programs (a copy of `dcgan_tpu/train/gd_pipeline.py`).

Under `pipeline_gd` the trainer runs each step as the three stage
programs of `train/steps.py`:

    gen_fakes(state, draws) -> fakes            the fill
    d_update(state, images, fakes, draws)       consumes a fake stack
    g_update(state, draws) -> (state, fakes)    returns the next stack

and the [n_critic, B, S, S, c_dim] stack that d_update consumes at step N
is the one g_update produced during step N - 1 (staleness 1). This class
holds that stack and its lifecycle:

- fill: the buffer is empty at run start, after a restore and after any
  drain; `step()` then runs `gen_fakes` from the current state before the
  first d_update, so that step trains on fakes of staleness 0;
- steady: d_update consumes the held stack, handed over (the slot
  cleared) before d_update is dispatched, and g_update's stack takes its
  place;
- checkpoints: nothing. The buffer lives outside the checkpoint, so both
  modes save the same state tree and a resume refills;
- drain: a stop ("coordinated-stop") or the end of the run ("shutdown")
  drops the in-flight stack; the next `step()` refills.

`pt` is anything with the three stage functions: the step functions
(eager) or the captured runner's stage rows (train/warmup.py), whose
"stack" is one static slot that g_update overwrites in place.
"""

from __future__ import annotations

from typing import Any, Tuple

Pytree = Any


class GDPipeline:
    """The fake stack in flight between pipelined steps. `last_phase` is
    what the last event was: "fill" (this step ran gen_fakes first),
    "steady" (it consumed the previous step's stack) or "drain"."""

    def __init__(self) -> None:
        self._buf = None
        self.fills = 0
        self.drains = 0
        self.steps = 0
        self.last_phase = ""
        self.last_drain_reason = ""

    @property
    def primed(self) -> bool:
        """Whether a stack is in flight (the next step skips the fill)."""
        return self._buf is not None

    def step(self, pt, state: Pytree, images, draws,
             **d_kw) -> Tuple[Pytree, dict]:
        """One pipelined step: (state, the merged D and G metrics, with
        exactly the fused step's keys). `d_kw` goes to d_update (the lazy
        R1 `penalty` flag)."""
        if self._buf is None:
            self._buf = pt.gen_fakes(state, draws)
            self.fills += 1
            self.last_phase = "fill"
        else:
            self.last_phase = "steady"
        # hand the stack over and clear the slot before d_update runs: a
        # second reference here would keep the consumed stack alive for a
        # whole step
        fakes, self._buf = self._buf, None
        state, d_metrics = pt.d_update(state, images, fakes, draws, **d_kw)
        del fakes
        state, self._buf, g_metrics = pt.g_update(state, draws)
        self.steps += 1
        return state, {**d_metrics, **g_metrics}

    def drain(self, reason: str) -> bool:
        """Drop the in-flight stack; True if there was one. A drain of an
        empty buffer is a no-op. Reasons: "coordinated-stop" (a signal),
        "restore" (a checkpoint loaded into a runner) and "shutdown"."""
        if self._buf is None:
            return False
        # the stack's memory goes with its last reference
        self._buf = None
        self.drains += 1
        self.last_phase = "drain"
        self.last_drain_reason = reason
        return True
