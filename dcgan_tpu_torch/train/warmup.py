"""The trainer's captured programs (the counterpart of
`dcgan_tpu/train/warmup.py`'s AOT warmup and of the JAX trainer's
`steps_per_call` scan).

A JAX step is one compiled XLA program; the eager port dispatches some
two thousand kernels per step from the host. `StepRunner` runs the step
as captured CUDA graphs (graphs.py) over static buffers it owns:

- the train state, allocated once outside any graph and updated in place
  (the counterpart of JAX's buffer donation); a resume copies the restored
  leaves into it (`load`), never rebinds it;
- K image slots and K z slots (K = steps_per_call), which the trainer
  fills outside the graph on the current stream;
- the sampler's fixed z.

A row of the plan is one program: `train_step` (one step), `multi_step@kK`
(K steps, each reading slot k, the last one copying its new state into
the static state) and `sampler` (the grid's images from the static
state). The first step of a runner runs eagerly on the capture stream:
the warm-up, a real training step, which builds the kernels, creates their
tickets and lets cuDNN and cuBLAS pick their algorithms before anything is
captured. A row is captured at its first dispatch, or all of them right
after the warm-up by `aot_capture` (--aot_warmup), which returns the
`perf/compile_ms/<row>` capture times.

On the CPU the runner runs the same static-buffer path eagerly (slots,
copy-back, K steps per call), so the CPU tests cover all of it but the
capture itself. The step reads only tensors (no value of the state
reaches the host), and z is drawn outside the graph, so nothing of a
replay is frozen at capture time.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from dcgan_tpu_torch.config import TrainConfig
from dcgan_tpu_torch.graphs import CapturedProgram, on_stream
from dcgan_tpu_torch.train.steps import TrainStepFns, tree_leaves

Pytree = dict

METRIC_KEYS = ("d_loss", "d_loss_real", "d_loss_fake", "g_loss")
TRAIN_ROW = "train_step"
SAMPLER_ROW = "sampler"


def multi_step_row(k: int) -> str:
    return f"multi_step@k{k}"


def call_size(step: int, total: int, steps_per_call: int,
              warm: bool) -> int:
    """The steps of the call that starts at state step `step`: K when the
    runner is warm and the call is aligned to a K boundary with K steps
    left before `total`, else 1 (the warm-up, single steps that realign
    after a resume between boundaries, and the tail), as the JAX trainer
    chooses between its scanned and its single-step program."""
    k = steps_per_call
    if warm and k > 1 and step % k == 0 and step + k <= total:
        return k
    return 1


def build_warmup_plan(cfg: TrainConfig, *, sample: bool) -> List[str]:
    """The rows of the programs this run can dispatch, with the JAX plan's
    names: the single step (the tail and realignment calls), the K-step
    call when steps_per_call > 1, and the sampler when the run writes
    grids. The JAX plan's `state_copy` (the restore's buffer rebase) has
    no row: the port's restore copies into the static buffers."""
    rows = [TRAIN_ROW]
    if cfg.steps_per_call > 1:
        rows.append(multi_step_row(cfg.steps_per_call))
    if sample:
        rows.append(SAMPLER_ROW)
    return rows


def aot_capture(runner: "StepRunner", plan: List[str]) -> Dict[str, float]:
    """Capture every planned row now; {row: capture ms}."""
    return {name: runner.capture(name) for name in plan}


def _copy_into(static: Pytree, new: Pytree) -> None:
    for dst, src in zip(tree_leaves(static), tree_leaves(new)):
        if src is not dst:
            dst.copy_(src)


class StepRunner:
    """The train step and the sampler as captured programs over static
    buffers (eager on the CPU); see the module docstring."""

    def __init__(self, fns: TrainStepFns, state: Pytree, cfg: TrainConfig,
                 device: torch.device,
                 sample_z: Optional[torch.Tensor] = None):
        m = cfg.model
        k = cfg.steps_per_call
        self.fns = fns
        self.device = device
        self.state = state
        self.images = torch.empty(
            (k, cfg.batch_size, m.output_size, m.output_size, m.c_dim),
            dtype=torch.float32, device=device)
        self.z = torch.empty((k, cfg.batch_size, m.z_dim),
                             dtype=torch.float32, device=device)
        self.sample_z = sample_z
        self.stream = torch.cuda.Stream(device) \
            if device.type == "cuda" else None
        self.warm = False
        self.programs: Dict[str, CapturedProgram] = {}
        self._wait: List[torch.cuda.Event] = []

    def load(self, tree: Pytree) -> None:
        """Copy a state (a restored checkpoint) into the static state."""
        a, b = tree_leaves(self.state), tree_leaves(tree)
        if len(a) != len(b):
            raise ValueError(f"the state has {len(a)} leaves, the tree "
                             f"{len(b)}")
        _copy_into(self.state, tree)

    def wait_for(self, event: Optional[torch.cuda.Event]) -> None:
        """Make the next step wait, on the device, for `event` (a
        checkpoint's host copy of the static state, which the step
        overwrites)."""
        if event is not None:
            self._wait.append(event)

    def _steps_fn(self, k: int) -> Callable[[], torch.Tensor]:
        def steps() -> torch.Tensor:
            state, rows = self.state, []
            for i in range(k):
                state, m = self.fns.train_step(state, self.images[i],
                                               self.z[i])
                rows.append(torch.stack([m[key] for key in METRIC_KEYS]))
            _copy_into(self.state, state)
            return torch.stack(rows)
        return steps

    def _sample_fn(self) -> Callable[[], torch.Tensor]:
        if self.sample_z is None:
            raise ValueError("the runner has no sample z")
        return lambda: self.fns.sample(self.state, self.sample_z)

    def _program(self, name: str) -> CapturedProgram:
        prog = self.programs.get(name)
        if prog is not None:
            return prog
        if not self.warm:
            raise RuntimeError(f"{name}: the runner's first step (the "
                               "eager warm-up) must run before a capture")
        if name == SAMPLER_ROW:
            fn = self._sample_fn()
            with on_stream(self.stream):   # the sampler's own warm-up
                fn()
        elif name == TRAIN_ROW:
            fn = self._steps_fn(1)
        elif name.startswith("multi_step@k"):
            fn = self._steps_fn(int(name[len("multi_step@k"):]))
        else:
            raise KeyError(f"no program {name!r}")
        prog = CapturedProgram(name, fn, self.device, self.stream)
        prog.capture()
        self.programs[name] = prog
        return prog

    def capture(self, name: str) -> float:
        """Capture row `name` if it is not yet; its capture ms."""
        return self._program(name).capture_ms

    def row(self, k: int) -> str:
        return TRAIN_ROW if k == 1 else multi_step_row(k)

    def step(self, images: List[torch.Tensor], zs: List[torch.Tensor]
             ) -> torch.Tensor:
        """len(images) steps on the static state, step i on images[i] and
        zs[i]; returns the [k, 4] losses (METRIC_KEYS), which the next
        call overwrites. The first call (one step) is the eager warm-up."""
        k = len(images)
        if not 1 <= k <= self.images.shape[0] or len(zs) != k:
            raise ValueError(f"{k} batches and {len(zs)} z for a runner of "
                             f"{self.images.shape[0]} slots")
        for i in range(k):
            self.images[i].copy_(images[i])
            self.z[i].copy_(zs[i])
        current = torch.cuda.current_stream(self.device) \
            if self.stream is not None else None
        while self._wait:
            current.wait_event(self._wait.pop())
        if not self.warm:
            if k != 1:
                raise ValueError("the warm-up is one step")
            with on_stream(self.stream):
                out = self._steps_fn(1)()
            self.warm = True
            return out
        return self._program(self.row(k)).run()

    def sample(self) -> torch.Tensor:
        """The sampler's images of the sample z at the static state."""
        return self._program(SAMPLER_ROW).run()
