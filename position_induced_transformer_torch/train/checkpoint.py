"""Checkpoints: a model's state dict and its benchmark's name, in one file
written with ``torch.save`` and read with ``torch.load(weights_only=True)``.

A training checkpoint adds the optimizer's state dict and the step count,
so that training resumes where it stopped; ``Predictor`` reads either kind.
A normalizing benchmark's checkpoint (darcy) also carries the per-pixel
statistics its training fitted, ``x_normalizer`` and ``y_normalizer``
(``mean``, ``std`` and ``eps`` as CPU tensors), so that evaluation and
serving at another resolution reuse them.
Parameters carry no mesh dimension, so a restored state dict binds to any
Geometry of its benchmark.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import torch

_KEYS = {"config", "state_dict"}
_TRAINING_KEYS = _KEYS | {"optimizer", "step"}
_NORMALIZER_KEYS = {"x_normalizer", "y_normalizer"}
_NORMALIZER_FIELDS = {"mean", "std", "eps"}


def _to_cpu(obj):
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_cpu(v) for v in obj]
    return obj


def save(
    path: str,
    state_dict: Mapping[str, torch.Tensor],
    config_name: str,
    *,
    optimizer: Optional[dict] = None,
    step: Optional[int] = None,
    x_normalizer: Optional[Mapping[str, torch.Tensor]] = None,
    y_normalizer: Optional[Mapping[str, torch.Tensor]] = None,
) -> str:
    """Write ``{"config": config_name, "state_dict": ...}`` to ``path``
    atomically (a temporary file, then a rename). With ``optimizer`` (an
    optimizer's ``state_dict()``) and ``step`` it is a training checkpoint.
    ``x_normalizer`` / ``y_normalizer``: normalizer statistics, each
    ``{"mean", "std", "eps"}`` (``PixelWiseNormalizer.state()``)."""
    if (optimizer is None) != (step is None):
        raise ValueError("a training checkpoint needs both optimizer and step")
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    obj = {"config": str(config_name), "state_dict": _to_cpu(dict(state_dict))}
    if optimizer is not None:
        obj["optimizer"] = _to_cpu(optimizer)
        obj["step"] = int(step)
    for k, v in (("x_normalizer", x_normalizer), ("y_normalizer", y_normalizer)):
        if v is not None:
            obj[k] = {f: torch.as_tensor(t).detach().cpu() for f, t in v.items()}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)
    return path


def restore(path: str) -> dict:
    """Read a checkpoint written by :func:`save`: ``{"config",
    "state_dict"}``, plus ``"optimizer"`` and ``"step"`` for a training
    checkpoint and ``"x_normalizer"`` / ``"y_normalizer"`` where they were
    saved, with CPU tensors."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint file at {path!r}")
    obj = torch.load(path, map_location="cpu", weights_only=True)
    keys = set(obj) - _NORMALIZER_KEYS if isinstance(obj, dict) else None
    if keys not in (_KEYS, _TRAINING_KEYS) or any(
        not isinstance(obj[k], dict) or set(obj[k]) != _NORMALIZER_FIELDS
        for k in _NORMALIZER_KEYS & set(obj)
    ):
        raise ValueError(
            f"{path!r} is not a checkpoint of this package (expected the "
            "keys 'config' and 'state_dict', for training also "
            "'optimizer' and 'step', and optionally 'x_normalizer' and "
            "'y_normalizer' holding 'mean', 'std' and 'eps')"
        )
    return obj
