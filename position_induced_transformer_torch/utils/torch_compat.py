"""Weights from the JAX package's PiT, PiTTF and PiTTFPointCloud params
into the port's state dicts, and the reference's ``model.pth`` files in
and out.

The port's ``PiT.state_dict()`` uses the reference's parameter names, so a
reference state dict loads into the benchmark's model as it is:
:func:`load_torch_checkpoint` reads one (``{'model_state': state_dict}``
or a bare state dict, ``torch.compile``'s ``_orig_mod.`` prefix removed)
and :func:`save_torch_checkpoint` writes one.
"""

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
    """Convert JAX ``PiTTF`` or ``PiTTFPointCloud`` params to the port's
    ``state_dict()`` layout of the same model.

    Attention subtrees (``down``, ``up``, ``PA_<i>``; ``PiTTF``'s
    ``MHPA_<i>`` and ``up2``) carry ``band_width`` ((1, H, 1, 1) in the
    point-cloud model, (H, 1, 1) in ``PiTTF``) and ``weight`` (H, in, V)
    unchanged; ``Dense`` subtrees (``en_layer``, ``w1``, ``w2``, ``W_<i>``,
    ``w``) and the ``mlp1``/``mlp2`` pairs of the ``TFMlp`` subtrees
    (``mlp1``, ``mlp2``, ``MLP_<i>``, ``mlp``, ``de_layer``) carry
    ``kernel`` transposed to ``(out, in)`` and ``bias``.
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


def _strip_compile_prefix(name: str) -> str:
    # torch.compile wraps state dicts with an ``_orig_mod.`` prefix
    return name[len("_orig_mod."):] if name.startswith("_orig_mod.") else name


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference ``model.pth`` into a state dict of CPU tensors.
    Parameters of a ``norm`` module are refused with ``KeyError``: the
    reference's ``InstanceNorm1d`` is ``affine=False`` and has none, and an
    affine norm's scale and shift have no counterpart in the port."""
    loaded = torch.load(path, map_location="cpu", weights_only=True)
    state = loaded.get("model_state", loaded)
    out: Dict[str, torch.Tensor] = {}
    for raw, value in state.items():
        name = _strip_compile_prefix(raw)
        if name.split(".")[0] == "norm":
            raise KeyError(
                f"cannot import {name!r}: the reference uses "
                "InstanceNorm1d(affine=False); an affine norm's parameters "
                "have no counterpart here"
            )
        out[name] = value
    return out


def save_torch_checkpoint(path: str, state) -> None:
    """Write a reference-compatible ``model.pth``: ``{'model_state':
    state}`` with contiguous CPU tensors."""
    torch.save({"model_state": {k: torch.as_tensor(v).detach().cpu().contiguous()
                                for k, v in state.items()}}, path)
