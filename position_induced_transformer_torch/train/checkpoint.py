"""Checkpoints: a model's state dict and its benchmark's name, in one file
written with ``torch.save`` and read with ``torch.load(weights_only=True)``.

Parameters carry no mesh dimension, so a restored state dict binds to any
Geometry of its benchmark.
"""

from __future__ import annotations

import os
from typing import Mapping

import torch


def save(path: str, state_dict: Mapping[str, torch.Tensor], config_name: str) -> str:
    """Write ``{"config": config_name, "state_dict": ...}`` to ``path``
    atomically (a temporary file, then a rename)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    state = {k: v.detach().cpu() for k, v in state_dict.items()}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"config": str(config_name), "state_dict": state}, tmp)
    os.replace(tmp, path)
    return path


def restore(path: str) -> dict:
    """Read a checkpoint written by :func:`save`: ``{"config", "state_dict"}``
    with CPU tensors."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint file at {path!r}")
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(obj, dict) or set(obj) != {"config", "state_dict"}:
        raise ValueError(
            f"{path!r} is not a checkpoint of this package (expected the "
            "keys 'config' and 'state_dict')"
        )
    return obj
