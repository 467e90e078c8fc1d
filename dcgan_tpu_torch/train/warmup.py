"""The trainer's captured programs (the counterpart of
`dcgan_tpu/train/warmup.py`'s AOT warmup and of the JAX trainer's
`steps_per_call` scan).

A JAX step is one compiled XLA program; the eager port dispatches some
two thousand kernels per step from the host. `StepRunner` runs the step
as captured CUDA graphs (graphs.py) over static buffers it owns:

- the train state, allocated once outside any graph and updated in place
  (the counterpart of JAX's buffer donation); a resume copies the restored
  leaves into it (`load`), never rebinds it;
- K image slots, K z slots and K slots of the step's other draws
  (`steps.draw_step`: the critic iterations' z, WGAN-GP's interpolation
  weights, the augmentations; none for a config without them), and for a
  conditional model K label slots, which the trainer fills outside the
  graph on the current stream;
- the sampler's fixed z (and, conditional, its fixed labels).

A row of the plan is one program: `train_step` (one step), `multi_step@kK`
(K steps, each reading slot k, the last one copying its new state into
the static state) and `sampler` (the grid's images from the static
state). The first step of a runner runs eagerly on the capture stream:
the warm-up, a real training step, which builds the kernels, creates their
tickets and lets cuDNN and cuBLAS pick their algorithms before anything is
captured. A row is captured at its first dispatch, or all of them right
after the warm-up by `aot_capture` (--aot_warmup), which returns the
`perf/compile_ms/<row>` capture times.

Lazy R1 (r1_interval k > 1) runs the penalty on the steps whose state step
is a multiple of k. That is no branch inside a graph: the host knows each
step's index, so a call of K steps takes the row of its pattern of
penalty and plain steps, `<row>/r1=<K digits>` (1: the penalty runs), one
program per pattern the run can meet (`r1_patterns`). Before the first
capture of a penalty step, one eager penalty step on a copy of the state
warms its double backward up on the capture stream, if the warm-up step
was a plain one.

Under `pipeline_gd` (train/gd_pipeline.py) the runner holds three stage
rows in place of the step: `gen_fakes` (the fill, writing the static
[n_critic, B, S, S, c_dim] fake-stack slot), `d_update` (reading that slot
and updating D's half of the static state) and `g_update` (updating G's
half and overwriting the slot with the next stack, later on the same
stream), each with the step's image and `steps.draw_stages` slots. A
`GDPipeline` drives them (`pipelined_step`); its first step, which always
fills, is the eager warm-up of all three. A restore (`load`) drains the
pipeline, so the step after it refills from the restored G.

On the CPU the runner runs the same static-buffer path eagerly (slots,
copy-back, K steps per call), so the CPU tests cover all of it but the
capture itself. The step reads only tensors (no value of the state
reaches the host), and z is drawn outside the graph, so nothing of a
replay is frozen at capture time.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from dcgan_tpu_torch.config import TrainConfig
from dcgan_tpu_torch.graphs import CapturedProgram, on_stream
from dcgan_tpu_torch.train.gd_pipeline import GDPipeline
from dcgan_tpu_torch.train.steps import TrainStepFns, draw_stages, \
    draw_step, lazy_r1, penalty_due, tree_leaves, tree_map

Pytree = dict

METRIC_KEYS = ("d_loss", "d_loss_real", "d_loss_fake", "g_loss")
TRAIN_ROW = "train_step"
SAMPLER_ROW = "sampler"
# the pipelined step's stage rows (pipeline_gd)
GEN_ROW, D_ROW, G_ROW = "gen_fakes", "d_update", "g_update"
STAGE_ROWS = (GEN_ROW, D_ROW, G_ROW)


def metric_keys(cfg: TrainConfig) -> Tuple[str, ...]:
    """The step's metrics, in the runner's column order: the losses, then
    "gp" (WGAN-GP) or "r1" where the config has the penalty."""
    if cfg.loss == "wgan-gp":
        return METRIC_KEYS + ("gp",)
    if cfg.r1_gamma > 0.0:
        return METRIC_KEYS + ("r1",)
    return METRIC_KEYS


def r1_pattern(cfg: TrainConfig, start: int, k: int) -> Tuple[bool, ...]:
    """Which of the k steps from state step `start` run lazy R1."""
    return tuple(penalty_due(cfg, start + i) for i in range(k))


def r1_patterns(cfg: TrainConfig, k: int) -> List[Tuple[bool, ...]]:
    """The patterns a call of k steps can meet: any start for k = 1, the
    starts on k boundaries for k > 1 (call_size's aligned calls)."""
    if k == 1:
        return [(False,), (True,)]
    span = cfg.r1_interval * k // math.gcd(cfg.r1_interval, k)
    return sorted({r1_pattern(cfg, s, k) for s in range(0, span, k)})


def multi_step_row(k: int) -> str:
    return f"multi_step@k{k}"


def pattern_row(row: str, pattern: Optional[Tuple[bool, ...]]) -> str:
    """A train row's name for a lazy-R1 pattern (None: no lazy R1)."""
    if pattern is None:
        return row
    return f"{row}/r1=" + "".join("1" if p else "0" for p in pattern)


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
    grids; under pipeline_gd the three stage rows in place of the step.
    The JAX plan's `state_copy` (the restore's buffer rebase) has no row:
    the port's restore copies into the static buffers."""
    if cfg.pipeline_gd:
        d_rows = [pattern_row(D_ROW, p) for p in r1_patterns(cfg, 1)] \
            if lazy_r1(cfg) else [D_ROW]
        return [GEN_ROW, *d_rows, G_ROW] + ([SAMPLER_ROW] if sample
                                            else [])
    rows = [TRAIN_ROW]
    if cfg.steps_per_call > 1:
        rows.append(multi_step_row(cfg.steps_per_call))
    if lazy_r1(cfg):
        # one program per pattern of penalty and plain steps
        rows = [pattern_row(row, p) for row in rows
                for p in r1_patterns(cfg, 1 if row == TRAIN_ROW
                                     else cfg.steps_per_call)]
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
                 sample_z: Optional[torch.Tensor] = None,
                 sample_labels: Optional[torch.Tensor] = None):
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
        # a conditional model's label slots (the step reads each through
        # the one-hot comparison, so any int32 value is safe in a slot)
        self.labels = torch.zeros((k, cfg.batch_size), dtype=torch.int32,
                                  device=device) if m.num_classes else None
        gen = torch.Generator(device=device).manual_seed(0)
        draw = draw_stages if cfg.pipeline_gd else draw_step
        self.draws = [{name: torch.empty_like(t) for name, t in
                       draw(cfg, gen).items()} for _ in range(k)]
        self.pipeline = GDPipeline() if cfg.pipeline_gd else None
        # the fake-stack slot of the stage rows
        self.fakes = torch.empty(
            (cfg.n_critic, cfg.batch_size, m.output_size, m.output_size,
             m.c_dim), dtype=torch.float32, device=device) \
            if cfg.pipeline_gd else None
        self.cfg = cfg
        self.keys = metric_keys(cfg)
        self.sample_z = sample_z
        self.sample_labels = sample_labels
        self.stream = torch.cuda.Stream(device) \
            if device.type == "cuda" else None
        self.warm = False
        self.penalty_warm = False
        self.programs: Dict[str, CapturedProgram] = {}
        self._wait: List[torch.cuda.Event] = []

    def load(self, tree: Pytree) -> None:
        """Copy a state (a restored checkpoint) into the static state;
        under pipeline_gd the fake stack in flight is drained, so the next
        step refills from the restored G."""
        a, b = tree_leaves(self.state), tree_leaves(tree)
        if len(a) != len(b):
            raise ValueError(f"the state has {len(a)} leaves, the tree "
                             f"{len(b)}")
        _copy_into(self.state, tree)
        if self.pipeline is not None:
            self.pipeline.drain("restore")

    def wait_for(self, event: Optional[torch.cuda.Event]) -> None:
        """Make the next step wait, on the device, for `event` (a
        checkpoint's host copy of the static state, which the step
        overwrites)."""
        if event is not None:
            self._wait.append(event)

    def _steps_fn(self, k: int, pattern: Optional[Tuple[bool, ...]] = None
                  ) -> Callable[[], torch.Tensor]:
        def steps() -> torch.Tensor:
            state, rows = self.state, []
            for i in range(k):
                state, m = self.fns.train_step(
                    state, self.images[i], self.z[i], self.draws[i],
                    None if self.labels is None else self.labels[i],
                    penalty=None if pattern is None else pattern[i])
                rows.append(torch.stack([m[key] for key in self.keys]))
            _copy_into(self.state, state)
            return torch.stack(rows)
        return steps

    def _stage_fn(self, base: str, pattern: Optional[Tuple[bool, ...]]
                  ) -> Callable[[], torch.Tensor]:
        """A stage row's function over the static buffers: gen_fakes
        writes the fake-stack slot and returns it; d_update returns D's
        metrics [len(keys) - 1] in `keys` order; g_update writes the next
        stack into the slot and returns g_loss."""
        fns, draws = self.fns, self.draws[0]
        if base == GEN_ROW:
            def fn():
                self.fakes.copy_(fns.gen_fakes(self.state, draws))
                return self.fakes
        elif base == D_ROW:
            def fn():
                state, m = fns.d_update(
                    self.state, self.images[0], self.fakes, draws,
                    penalty=None if pattern is None else pattern[0])
                _copy_into(self.state, state)
                return torch.stack([m[k] for k in self.keys
                                    if k != "g_loss"])
        else:
            def fn():
                state, fakes, m = fns.g_update(self.state, draws)
                _copy_into(self.state, state)
                self.fakes.copy_(fakes)
                return m["g_loss"]
        return fn

    def _warm_penalty(self) -> None:
        """One eager penalty step (under pipeline_gd a penalty d_update)
        on a copy of the state, on the capture stream, so that the
        penalty's double backward has run there before a capture records
        it."""
        with on_stream(self.stream):
            copy = tree_map(torch.clone, self.state)
            if self.pipeline is not None:
                self.fns.d_update(copy, self.images[0], self.fakes,
                                  self.draws[0], penalty=True)
            else:
                self.fns.train_step(copy, self.images[0], self.z[0],
                                    self.draws[0],
                                    None if self.labels is None
                                    else self.labels[0], penalty=True)
        self.penalty_warm = True

    def _pattern(self, k: int, start: Optional[int]
                 ) -> Optional[Tuple[bool, ...]]:
        if not lazy_r1(self.cfg):
            return None
        if start is None:
            raise ValueError("lazy R1: a call needs its start step")
        return r1_pattern(self.cfg, start, k)

    def _sample_fn(self) -> Callable[[], torch.Tensor]:
        if self.sample_z is None:
            raise ValueError("the runner has no sample z")
        if self.labels is not None and self.sample_labels is None:
            raise ValueError("a conditional runner needs sample labels")
        return lambda: self.fns.sample(self.state, self.sample_z,
                                       self.sample_labels)

    def _program(self, name: str) -> CapturedProgram:
        prog = self.programs.get(name)
        if prog is not None:
            return prog
        if not self.warm:
            raise RuntimeError(f"{name}: the runner's first step (the "
                               "eager warm-up) must run before a capture")
        base, _, digits = name.partition("/r1=")
        pattern = tuple(c == "1" for c in digits) if digits else None
        if pattern is not None and any(pattern) and not self.penalty_warm:
            self._warm_penalty()
        if name == SAMPLER_ROW:
            fn = self._sample_fn()
            with on_stream(self.stream):   # the sampler's own warm-up
                fn()
        elif base in STAGE_ROWS:
            fn = self._stage_fn(base, pattern)
        elif base == TRAIN_ROW:
            fn = self._steps_fn(1, pattern)
        elif base.startswith("multi_step@k"):
            fn = self._steps_fn(int(base[len("multi_step@k"):]), pattern)
        else:
            raise KeyError(f"no program {name!r}")
        prog = CapturedProgram(name, fn, self.device, self.stream)
        prog.capture()
        self.programs[name] = prog
        return prog

    def capture(self, name: str) -> float:
        """Capture row `name` if it is not yet; its capture ms."""
        return self._program(name).capture_ms

    def row(self, k: int, start: Optional[int] = None) -> str:
        """The row of a call of k steps from state step `start` (needed
        only under lazy R1)."""
        return pattern_row(TRAIN_ROW if k == 1 else multi_step_row(k),
                           self._pattern(k, start))

    def step(self, images: List[torch.Tensor], zs: List[torch.Tensor],
             draws: Optional[List[Dict[str, torch.Tensor]]] = None,
             start: Optional[int] = None,
             labels: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """len(images) steps on the static state, step i on images[i],
        zs[i], draws[i] (`steps.draw_step`'s; None for a config without
        them) and, for a conditional model, labels[i]; `start` is the
        state step the call starts from, which lazy R1 needs. Returns the
        [k, len(metric_keys(cfg))] metrics, which the next call
        overwrites. The first call (one step) is the eager warm-up."""
        k = len(images)
        if not 1 <= k <= self.images.shape[0] or len(zs) != k:
            raise ValueError(f"{k} batches and {len(zs)} z for a runner of "
                             f"{self.images.shape[0]} slots")
        if (labels is None) != (self.labels is None) or \
                (labels is not None and len(labels) != k):
            raise ValueError(
                "a conditional model's runner takes one label batch per "
                "step, an unconditional model's none")
        if draws is None:
            draws = [{}] * k
        for i in range(k):
            self.images[i].copy_(images[i])
            self.z[i].copy_(zs[i])
            if labels is not None:
                self.labels[i].copy_(labels[i])
            if set(draws[i]) != set(self.draws[i]):
                raise ValueError(
                    f"step {i}: draws {sorted(draws[i])}, the config's "
                    f"are {sorted(self.draws[i])}")
            for name, t in draws[i].items():
                self.draws[i][name].copy_(t)
        current = torch.cuda.current_stream(self.device) \
            if self.stream is not None else None
        while self._wait:
            current.wait_event(self._wait.pop())
        pattern = self._pattern(k, start)
        if not self.warm:
            if k != 1:
                raise ValueError("the warm-up is one step")
            with on_stream(self.stream):
                out = self._steps_fn(1, pattern)()
            self.warm = True
            self.penalty_warm = pattern is None or pattern[0]
            return out
        return self._program(pattern_row(
            TRAIN_ROW if k == 1 else multi_step_row(k), pattern)).run()

    def pipelined_step(self, images: torch.Tensor,
                       draws: Dict[str, torch.Tensor],
                       start: Optional[int] = None) -> torch.Tensor:
        """One pipelined step (pipeline_gd) on `images` and the step's
        `steps.draw_stages` draws, through the GDPipeline over the stage
        rows; `start` is the state step (lazy R1 needs it). Returns the
        [1, len(metric_keys(cfg))] metrics. The first call is the eager
        warm-up of all three stages (it always fills)."""
        if self.pipeline is None:
            raise ValueError("the runner's config has no pipeline_gd")
        self.images[0].copy_(images)
        if set(draws) != set(self.draws[0]):
            raise ValueError(f"draws {sorted(draws)}, the config's are "
                             f"{sorted(self.draws[0])}")
        for name, t in draws.items():
            self.draws[0][name].copy_(t)
        current = torch.cuda.current_stream(self.device) \
            if self.stream is not None else None
        while self._wait:
            current.wait_event(self._wait.pop())
        pattern = self._pattern(1, start)
        _, m = self.pipeline.step(_StageRows(self, pattern), self.state,
                                  self.images[0], self.draws[0])
        if not self.warm:
            self.warm = True
            self.penalty_warm = pattern is None or pattern[0]
        return torch.stack([m[k] for k in self.keys])[None]

    def _run_stage(self, base: str, pattern: Optional[Tuple[bool, ...]]
                   ) -> torch.Tensor:
        """A stage row: eager on the capture stream in the warm-up step,
        a captured program after it."""
        if not self.warm:
            with on_stream(self.stream):
                return self._stage_fn(base, pattern)()
        return self._program(pattern_row(base, pattern)).run()

    def sample(self) -> torch.Tensor:
        """The sampler's images of the sample z at the static state."""
        return self._program(SAMPLER_ROW).run()

    def close(self) -> None:
        """Release every captured program and its graph pool (the static
        state stays); a later call captures its row again."""
        if self.stream is not None and self.programs:
            torch.cuda.synchronize(self.device)
        for prog in self.programs.values():
            prog.release()
        self.programs.clear()


class _StageRows:
    """A runner's stage rows as GDPipeline's stage functions: each runs
    its row over the static buffers (the state it is given is the static
    state, returned as it is; the stack is the static slot)."""

    def __init__(self, runner: StepRunner,
                 pattern: Optional[Tuple[bool, ...]]):
        self.runner = runner
        self.pattern = pattern

    def gen_fakes(self, state, draws):
        return self.runner._run_stage(GEN_ROW, None)

    def d_update(self, state, images, fakes, draws):
        out = self.runner._run_stage(D_ROW, self.pattern)
        keys = [k for k in self.runner.keys if k != "g_loss"]
        return state, dict(zip(keys, out))

    def g_update(self, state, draws):
        g_loss = self.runner._run_stage(G_ROW, None)
        return state, self.runner.fakes, {"g_loss": g_loss}
