"""Per-phase step functions and the cross-phase state carry (the port of
`dcgan_tpu/progressive/phases.py`).

`PhaseRuntime` owns a progressive run's phase table: the current phase,
each phase's `TrainConfig` and `TrainStepFns` (built lazily and kept, so
a switch enters step functions that exist already), the warm-up plan's
rows of the phases still to run, the fade blend and the state carry that
moves the live train state across a change of the model's depth. The runners
(train/warmup.py's `StepRunner`, one per phase: each phase has its own
batch, shapes and static buffers) are the trainer's.

State carry rules (the JAX package's, `dcgan_tpu/progressive/phases.py:
55-132`), over the port's flat state names (`convert.flatten`:
`params/gen/deconv1/w`, `opt/gen/mu/deconv1/w`, `bn/gen/bn1/mean`,
`ema_gen/deconv1/b`, `opt/gen/count`, `step`):

- leaves are matched by path after a per-family rename, then guarded by
  shape and dtype: a matched leaf of equal shape and dtype is carried,
  every other leaf keeps its fresh init;
- the DCGAN generator indexes its stages from the top (deconv1 is the
  widest), so a stack grown by d stages renames `deconv{i}` ->
  `deconv{i+d}`, `bn{i}` -> `bn{i+d}` (i >= 1) and `sn_deconv{i}` ->
  `sn_deconv{i+d}` in every generator subtree (params, BN state, the EMA
  copy and the Adam moments that mirror them); the z-side top (`proj`,
  `bn0`) is new at each phase;
- the discriminator indexes from its input, so its convs carry under the
  identity map and only its new top conv and head start fresh; so do the
  scalars (`step`, each net's Adam `count`), which carry and are not
  reset;
- other model families match by name and shape.

The JAX package reshards a carried leaf whose sharding changed and
rebases host-staged leaves; on one device every carried tensor stays
where it is, so the port has neither branch.
"""

from __future__ import annotations

import re
import time
from typing import Dict, List, Optional, Tuple

import torch

from dcgan_tpu_torch.config import TrainConfig
from dcgan_tpu_torch.convert import flatten, unflatten
from dcgan_tpu_torch.progressive.schedule import ProgressiveSchedule
from dcgan_tpu_torch.train.steps import TrainStepFns
from dcgan_tpu_torch.train.warmup import build_warmup_plan

Pytree = dict

#: generator-rooted path prefixes whose stage names shift when the DCGAN
#: stack grows (the Adam moments mirror params/gen under opt/gen/...)
_GEN_ROOTS = ("params/gen/", "bn/gen/", "ema_gen/", "opt/gen/")

_GEN_STAGE_RE = re.compile(r"^(deconv|bn|sn_deconv)(\d+)$")

#: the seed offset of a later phase's fresh init: phase i draws its new
#: leaves from seed + PHASE_SEED_OFFSET + i (the JAX package's key)
PHASE_SEED_OFFSET = 1000


def _rename_gen_segment(seg: str, shift: int) -> Optional[str]:
    """A generator stage name, old -> new, for a stack grown by `shift`
    stages; None: the old leaf has no home in the new tree (bn0, whose
    width follows the top channel count)."""
    m = _GEN_STAGE_RE.match(seg)
    if m is None:
        return seg
    kind, idx = m.group(1), int(m.group(2))
    if kind == "bn" and idx == 0:
        return None
    return f"{kind}{idx + shift}"


def carry_path(path: str, *, arch: str, shift: int) -> Optional[str]:
    """Where an old phase's leaf lands in the new tree ("/"-separated
    path), or None when it has no home. The identity for other model
    families, for shift 0 and outside the generator's subtrees."""
    if arch != "dcgan" or shift == 0 or not path.startswith(_GEN_ROOTS):
        return path
    out = []
    for seg in path.split("/"):
        if seg == "proj":
            return None  # the z-side projection: its shape follows top_ch
        new = _rename_gen_segment(seg, shift)
        if new is None:
            return None
        out.append(new)
    return "/".join(out)


def carry_state(old_state: Pytree, new_state: Pytree, *, arch: str,
                shift: int) -> Tuple[Pytree, int]:
    """An old phase's live state merged into a fresh init of the new
    phase: (merged tree, carried-leaf count). A carried leaf is the old
    tensor itself (not a copy); every other leaf is the fresh one."""
    old_by_path: Dict[str, torch.Tensor] = {}
    for path, leaf in flatten(old_state).items():
        home = carry_path(path, arch=arch, shift=shift)
        if home is not None:
            old_by_path[home] = leaf
    merged: Dict[str, torch.Tensor] = {}
    carried = 0
    for path, fresh in flatten(new_state).items():
        old = old_by_path.get(path)
        if old is None or old.shape != fresh.shape \
                or old.dtype != fresh.dtype:
            merged[path] = fresh  # no home, or a renamed leaf that no
            continue              # longer fits: the fresh init
        merged[path] = old
        carried += 1
    return unflatten(merged, like=new_state), carried


def fade(images: torch.Tensor, alpha: float) -> torch.Tensor:
    """The fade-in blend of a real batch [B, H, W, C]: alpha * x + (1 -
    alpha) * up(down(x)), down a 2x2 mean, up a nearest repeat: the
    previous resolution's content at this phase's size (the JAX
    package's `_make_fade`, as plain torch ops)."""
    b, h, w, c = images.shape
    low = images.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))
    up = low.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    return alpha * images + (1.0 - alpha) * up


class PhaseRuntime:
    """A progressive run's companion to the trainer: the current phase,
    each phase's config and step functions, the switch's state carry, the
    fade and the phase tag of the checkpoints. `start()` picks the phase
    to resume in from the newest checkpoint's step."""

    def __init__(self, cfg: TrainConfig, schedule: ProgressiveSchedule,
                 total_steps: int, world=None):
        from dcgan_tpu_torch.parallel.distributed import single_process
        from dcgan_tpu_torch.parallel.mesh import make_mesh

        self.base_cfg = cfg
        self.schedule = schedule
        self.total_steps = int(total_steps)
        # the live world: every phase's batch over its data axis
        self.world = world if world is not None else single_process("cpu")
        mesh = make_mesh(cfg.mesh, self.world.size)
        schedule.validate_mesh(mesh.shape, spatial=False,
                               grad_accum=cfg.grad_accum)
        self.starts = schedule.starts(self.total_steps)
        # the phases that run under this run length
        self.n_phases = sum(1 for s in self.starts
                            if s < self.total_steps) or 1
        self.index = 0
        self._surfaces: Dict[int, Tuple[TrainConfig, TrainStepFns]] = {}
        self._pars: Dict[int, "ParallelTrain"] = {}
        self.last_switch_ms = 0.0
        self.last_carried = 0

    # -- per-phase configs and step functions -------------------------------

    def surface(self, i: int) -> Tuple[TrainConfig, TrainStepFns]:
        """(the phase's TrainConfig, its step functions: the world's
        per-rank programs, parallel/api.py), built at the first call and
        kept."""
        if i not in self._surfaces:
            from dcgan_tpu_torch.parallel.api import make_parallel_train

            cfg_i = self.schedule.config_for(self.base_cfg, i)
            self._pars[i] = make_parallel_train(cfg_i, self.world)
            self._surfaces[i] = (cfg_i, self._pars[i].fns)
        return self._surfaces[i]

    @property
    def par(self) -> "ParallelTrain":
        """The current phase's ParallelTrain."""
        self.surface(self.index)
        return self._pars[self.index]

    @property
    def cfg(self) -> TrainConfig:
        return self.surface(self.index)[0]

    @property
    def fns(self) -> TrainStepFns:
        return self.surface(self.index)[1]

    def resolution_of(self, i: int) -> int:
        return self.schedule.phases[i].resolution

    @property
    def resolution(self) -> int:
        return self.resolution_of(self.index)

    def tag(self) -> Dict[str, int]:
        """The checkpoint's phase tag: which phase's tree it holds."""
        return {"phase": int(self.index), "resolution": int(self.resolution)}

    def call_limit(self) -> int:
        """The step no call of the current phase may pass: the next
        phase's start, or the end of the run."""
        nxt = self.index + 1
        return self.starts[nxt] if nxt < self.n_phases else self.total_steps

    # -- lifecycle ------------------------------------------------------------

    def start(self, latest_step: Optional[int]) -> int:
        """The starting phase: 0 for a fresh run, else the phase that
        produced the newest checkpoint (its tree is the restore's
        template; a checkpoint at a boundary step holds the old phase's
        tree, and the loop switches right after the restore)."""
        self.index = 0 if latest_step is None else min(
            self.schedule.index_for_state(int(latest_step),
                                          self.total_steps),
            self.n_phases - 1)
        self.surface(self.index)
        return self.index

    def check_resume_tag(self, payload_tag: Optional[dict],
                         latest_step: int) -> None:
        """The newest checkpoint's phase tag against the phase the
        schedule gives its step: a schedule edited between runs fails
        here, with the JAX package's message, not as a tree mismatch."""
        if not payload_tag:
            return
        saved = int(payload_tag.get("phase", -1))
        saved_res = int(payload_tag.get("resolution", -1))
        if saved != self.index or saved_res != self.resolution:
            raise ValueError(
                f"checkpoint at step {latest_step} was saved in progressive "
                f"phase {saved} (r{saved_res}) but the current schedule "
                f"resolves that step to phase {self.index} "
                f"(r{self.resolution}) — the --progressive spec changed "
                "between runs; restore with the saving schedule or point at "
                "a fresh checkpoint_dir")

    def switch_due(self, step: int) -> bool:
        nxt = self.index + 1
        return nxt < self.n_phases and step >= self.starts[nxt]

    def advance(self, state: Pytree) -> Pytree:
        """The switch's state half: enter the next phase and carry the
        live state (the old phase's) into a fresh init of it, drawn from
        seed + PHASE_SEED_OFFSET + the new index on the state's device.
        Times itself into `last_switch_ms`; the count of carried leaves
        goes to `last_carried`."""
        t0 = time.perf_counter()
        old_cfg = self.cfg
        self.index += 1
        cfg_i, fns_i = self.surface(self.index)
        shift = cfg_i.model.num_up_layers - old_cfg.model.num_up_layers
        fresh = fns_i.init(
            seed=self.base_cfg.seed + PHASE_SEED_OFFSET + self.index,
            device=state["step"].device)
        merged, self.last_carried = carry_state(
            state, fresh, arch=cfg_i.model.arch, shift=shift)
        self.last_switch_ms = (time.perf_counter() - t0) * 1e3
        return merged

    # -- fade -----------------------------------------------------------------

    def alpha(self, step: int) -> float:
        return self.schedule.alpha_at(step, self.total_steps)

    def fade_images(self, images: torch.Tensor, step: int) -> torch.Tensor:
        """The fade blend of the batch of step `step` inside a fade
        window; the batch itself otherwise."""
        a = self.alpha(step)
        if a >= 1.0:
            return images
        return fade(images, a)

    # -- the scalar rows -------------------------------------------------------

    def scalar_extras(self, step: int) -> Dict[str, float]:
        """The progressive/* scalars of the row of step `step`; none for
        a one-phase schedule, whose run is the fixed-resolution trainer's
        row for row."""
        if len(self.schedule.phases) == 1:
            return {}
        out = {"progressive/phase": float(self.index),
               "progressive/resolution": float(self.resolution)}
        if self.schedule.fade_steps:
            a = self.alpha(max(step - 1, 0))
            if a < 1.0:
                out["progressive/alpha"] = float(a)
        return out

    # -- the warm-up plan -------------------------------------------------------

    def build_warmup_plan(self, *, sample: bool
                          ) -> List[Tuple[str, int, str]]:
        """Every program the phases from the current one on dispatch, as
        (plan name, phase, runner row): the current phase's rows under
        their plain names, each later phase's suffixed `@r<resolution>`
        (the JAX plan's names). The JAX plan also lists the phases before
        the current one, which a resumed run never enters again, and an
        `init` and a `fade` row per phase, which run eagerly here."""
        plan: List[Tuple[str, int, str]] = []
        for i in range(self.index, self.n_phases):
            rows = build_warmup_plan(self.surface(i)[0], sample=sample)
            suffix = "" if i == self.index else f"@r{self.resolution_of(i)}"
            plan += [(row + suffix, i, row) for row in rows]
        return plan
