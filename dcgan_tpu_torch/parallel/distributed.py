"""Multi-process bring-up over torch.distributed (the counterpart of
`dcgan_tpu/parallel/distributed.py:20-51`).

Every rank is one process with one device. `initialize_multihost` forms
the job from the JAX function's arguments (`coordinator_address`,
`num_processes`, `process_id`, and `JAX_COORDINATOR_ADDRESS`) or from
torchrun's environment (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
`MASTER_ADDR`, `MASTER_PORT`):

    torchrun --nproc_per_node 8 -m dcgan_tpu_torch.train --preset lsun64-dp8
    JAX_COORDINATOR_ADDRESS=host0:1234 python -m dcgan_tpu_torch.train ...

A process that names no world is a world of one without a process group,
and every collective of the port is then skipped. The rank's device is
`cuda:LOCAL_RANK` unless the caller names one; the backend is NCCL on a
CUDA device and gloo on the CPU. `backend=` overrides that (gloo ranks
sharing one card, and the tests); gloo collectives cannot be captured
into a CUDA graph (train/warmup.py refuses the capture by name). The
"chief" is rank 0: it alone writes checkpoints, events, sample grids and
traces.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Union

import torch

from dcgan_tpu_torch.device import resolve_device

# the default deadline of every collective of a process group
DEFAULT_TIMEOUT_SECS = 600.0


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place in the job: its rank of `size`, its device,
    and the process group of all ranks (None in a process that named no
    world, where every collective is skipped)."""

    rank: int
    size: int
    local_rank: int
    device: torch.device
    backend: str = ""          # "nccl" | "gloo" | "" (no process group)
    group: Optional[object] = None

    @property
    def is_chief(self) -> bool:
        return self.rank == 0


def single_process(device: Union[str, torch.device] = "cuda") -> World:
    """The world of one process without a process group."""
    return World(rank=0, size=1, local_rank=0, device=resolve_device(device))


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value in (None, "") else int(value)


def _init_method(coordinator_address: Optional[str]) -> str:
    if coordinator_address is None:
        # torchrun's MASTER_ADDR / MASTER_PORT
        return "env://"
    if "://" in coordinator_address:   # tcp://..., file://...
        return coordinator_address
    return f"tcp://{coordinator_address}"


def _rank_device(device: Union[str, torch.device, None],
                 local_rank: int) -> torch.device:
    """The rank's device: `cuda:LOCAL_RANK` for an unindexed "cuda" (or
    None), else the named one."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    return resolve_device(dev)


def _world_of_group(device: Union[str, torch.device, None]) -> World:
    import torch.distributed as dist

    local_rank = _env_int("LOCAL_RANK") or 0
    return World(rank=dist.get_rank(), size=dist.get_world_size(),
                 local_rank=local_rank,
                 device=_rank_device(device, local_rank),
                 backend=dist.get_backend(), group=dist.group.WORLD)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         backend: Optional[str] = None,
                         device: Union[str, torch.device, None] = None,
                         local_rank: Optional[int] = None) -> World:
    """Form the job and return this process's World; a process that names
    no world (no coordinator address, no process count, no WORLD_SIZE)
    gets the single-process World and nothing is initialized. An
    initialized default group is reused, as the JAX function leaves a job
    the harness formed.

    The address may be "host:port" (TCP), or a "tcp://" or "file://"
    init method. The process count and id fall back to WORLD_SIZE and
    RANK, the local rank to LOCAL_RANK. Under NCCL the rank's device is
    bound to the group and one eager all_reduce forms the communicator,
    so a CUDA graph can capture the step's collectives later (NCCL cannot
    initialize under capture)."""
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if dist.is_available() and dist.is_initialized():
        return _world_of_group(device)
    if coordinator_address is None and num_processes is None:
        return single_process("cuda" if device is None else device)
    if num_processes is None:
        raise ValueError(
            f"coordinator address {coordinator_address!r} without a "
            "process count: pass num_processes or set WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if process_id is None:
        raise ValueError("a world of processes needs this process's id: "
                         "pass process_id or set RANK")
    if local_rank is None:
        local_rank = _env_int("LOCAL_RANK")
    if local_rank is None:
        local_rank = process_id if num_processes > 1 else 0
    dev = _rank_device(device, local_rank)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                         f"{backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the NCCL backend needs a CUDA device, got {dev}")
    kwargs = {}
    if backend == "nccl":
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    dist.init_process_group(
        backend=backend, init_method=_init_method(coordinator_address),
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_SECS), **kwargs)
    world = World(rank=int(process_id), size=int(num_processes),
                  local_rank=int(local_rank), device=dev, backend=backend,
                  group=dist.group.WORLD)
    if backend == "nccl":
        # forms the communicator now, outside any capture
        probe = torch.zeros(1, device=dev)
        dist.all_reduce(probe, group=world.group)
        torch.cuda.synchronize(dev)
    return world


def agree(world: World, value: Optional[int], what: str) -> Optional[int]:
    """Every rank's `value` (an int or None) gathered in one collective,
    which is also the ranks' meeting point: returns it when every rank
    holds the same, raises RuntimeError naming `what` otherwise."""
    if world.group is None:
        return value
    from dcgan_tpu_torch.parallel.collectives import gather_rows

    mine = torch.tensor([[-1 if value is None else int(value)]],
                        dtype=torch.int64, device=world.device)
    seen = [int(v) for v in gather_rows(world.group, mine).reshape(-1)]
    if len(set(seen)) != 1:
        raise RuntimeError(
            f"the ranks disagree on {what}: "
            f"{[None if v < 0 else v for v in seen]} by rank")
    return value


def shutdown() -> None:
    """Destroy the default process group, if one is initialized."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def is_chief() -> bool:
    """The checkpoint and observability owner: rank 0."""
    return process_index() == 0
