"""Weights from the JAX package's PiT and PiTTFPointCloud params into the
port's state dicts."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def flax_params_to_state_dict(params) -> Dict[str, torch.Tensor]:
    """Convert JAX ``PiT`` params (a nested dict of arrays: ``down/lmda``,
    ``en_layer/mlp{1,2}/{kernel,bias}``, ``conv_<i>/lmda``, ``mlp_<i>/...``,
    ``up/lmda``, ``de/...``) to the port's ``PiT.state_dict()`` layout.

    Flax kernels are (fan_in, out); torch weights are (out, in), so every
    kernel is transposed.
    """
    out: Dict[str, torch.Tensor] = {}
    as_tensor = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))

    def emit(prefix: str, tree):
        for mlp_name, leaves in tree.items():  # mlp1 / mlp2
            out[f"{prefix}.{mlp_name}.weight"] = as_tensor(np.asarray(leaves["kernel"]).T)
            out[f"{prefix}.{mlp_name}.bias"] = as_tensor(leaves["bias"])

    for key, sub in params.items():
        if key in ("down", "up"):
            out[f"{key}.lmda"] = as_tensor(sub["lmda"])
        elif key.startswith("conv_"):
            out[f"conv.{key.split('_')[1]}.lmda"] = as_tensor(sub["lmda"])
        elif key.startswith("mlp_"):
            emit(f"mlp.{key.split('_')[1]}", sub)
        elif key in ("en_layer", "de"):
            emit(key, sub)
        else:
            raise KeyError(f"unrecognized PiT parameter subtree {key!r}")
    return out


def flax_tf_params_to_state_dict(params) -> Dict[str, torch.Tensor]:
    """Convert JAX ``PiTTFPointCloud`` params to the port's
    ``PiTTFPointCloud.state_dict()`` layout.

    Attention subtrees (``down``, ``up``, ``PA_<i>``) carry ``band_width``
    (1, H, 1, 1) and ``weight`` (H, in, V) unchanged; ``Dense`` subtrees
    (``en_layer``, ``w1``, ``w2``, ``W_<i>``) and the ``mlp1``/``mlp2``
    pairs of the ``TFMlp`` subtrees (``mlp1``, ``mlp2``, ``MLP_<i>``,
    ``de_layer``) carry ``kernel`` transposed to ``(out, in)`` and ``bias``.
    """
    out: Dict[str, torch.Tensor] = {}
    as_tensor = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))

    def emit(prefix: str, tree):
        if "band_width" in tree:
            out[f"{prefix}.band_width"] = as_tensor(tree["band_width"])
            out[f"{prefix}.weight"] = as_tensor(tree["weight"])
        elif "kernel" in tree:
            out[f"{prefix}.weight"] = as_tensor(np.asarray(tree["kernel"]).T)
            out[f"{prefix}.bias"] = as_tensor(tree["bias"])
        else:
            for name, sub in tree.items():
                emit(f"{prefix}.{name}", sub)

    for key, sub in params.items():
        emit(key, sub)
    return out
