"""Progressive-resolution training (the port of `dcgan_tpu/progressive/`).

Resolution as a scheduled, checkpointed dimension of a training run:

- `schedule.py`: the phase table (`--progressive "32:2000,64:2000,128:*"`),
  parsed and validated against the model stack and the dispatch granule,
  with an optional linear fade-in alpha per phase;
- `phases.py`: each phase's config and step functions, the warm-up plan's
  `@r<res>` rows of the phases that are not current, the state carry
  across the model's growth (new leaves start fresh, carried leaves move
  over) and the checkpoints' phase tag;
- `rebucket.py`: the data feed closed and re-opened at each phase's
  resolution, with the process-wide quarantine tally carried across.

The trainer's phase switch (train/trainer.py) puts them together.
"""

from dcgan_tpu_torch.progressive.phases import PhaseRuntime, carry_path, \
    carry_state, fade
from dcgan_tpu_torch.progressive.rebucket import Rebucketer, \
    close_iterators, phase_data_cfg
from dcgan_tpu_torch.progressive.schedule import Phase, \
    ProgressiveSchedule, parse_schedule

__all__ = [
    "Phase",
    "PhaseRuntime",
    "ProgressiveSchedule",
    "Rebucketer",
    "carry_path",
    "carry_state",
    "close_iterators",
    "fade",
    "parse_schedule",
    "phase_data_cfg",
]
