"""Device resolution shared by the port's entry points."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The torch.device an entry point runs on.

    CUDA is the default; with no GPU present a CUDA request raises instead
    of quietly running on the CPU. The CPU is used only when the caller
    asks for it by name (the CPU tests do)."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but "
                "torch.cuda.is_available() is False; pass device='cpu' "
                "explicitly to run on the CPU")
        if dev.index is None:
            # pin the card that is current now, so a thread that selects
            # this device later selects the same one
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
