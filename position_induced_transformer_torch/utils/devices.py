"""Device selection for the port's entry points."""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises when it asks for CUDA and
    none is present. The port never moves to the CPU on its own: a caller
    who wants the CPU passes ``device="cpu"``. Under an initialized process
    group, ``"cuda"`` is this rank's card: ``cuda:LOCAL_RANK`` where
    torchrun set it, else the current device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch sees no CUDA device; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}; expected cuda or cpu")
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        local = os.environ.get("LOCAL_RANK")
        dev = torch.device("cuda", int(local) if local is not None else torch.cuda.current_device())
    return dev
