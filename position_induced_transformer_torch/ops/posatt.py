"""Position attention, the plain PyTorch version: the port's oracle.

Attention weights come from pairwise squared distances alone, with a
learnable per-head bandwidth and a quantile locality mask, followed by a
row softmax and a value contraction.

``position_attention(dist, lmda, inputs, locality)`` where

- ``dist``:   (L_out, L_in) fixed-mesh or (B, L_out, L_in) batched-mesh
              squared distances,
- ``lmda``:   (H, 1, 1) learnable bandwidth parameters,
- ``inputs``: (B, L_in, D) values,
- returns     (B, L_out, H*D), heads concatenated per point as
              ``[head0 | head1 | ...]``.

The model calls the kernel wrapper ``kernels.position_attention_fixed``;
this module is what the tests and ``chip_smoke.py`` hold it against.
"""

from __future__ import annotations

import math

import torch

from position_induced_transformer_torch.ops.locality import keep_mask

_F32_MAX = float(torch.finfo(torch.float32).max)

# a Python float times an f32 tensor rounds the constant to f32 once, as
# JAX's weakly typed constant does
_BANDWIDTH_C = 0.25 * math.pi * (1.0 - 1e-7)


def bandwidth_scale(lmda: torch.Tensor) -> torch.Tensor:
    """Per-head non-negative bandwidth ``tan(pi/4*(1-1e-7)*(1+sin(lmda)))``,
    in [0, ~1.3e7)."""
    return torch.tan(_BANDWIDTH_C * (1.0 + torch.sin(lmda)))


def attention_weights(
    dist: torch.Tensor,
    lmda: torch.Tensor,
    locality: float,
    keep: torch.Tensor | None = None,
    *,
    thr: torch.Tensor | None = None,
) -> torch.Tensor:
    """Distance matrix -> masked softmax attention weights.

    Returns (H, L_out, L_in) for a fixed mesh (``dist.ndim == 2``) or
    (B, H, L_out, L_in) for batched meshes. ``keep`` is an optional
    precomputed mask, ``thr`` an optional per-row threshold (..., L_out, 1).
    """
    scale = bandwidth_scale(lmda)  # (H, 1, 1)
    if dist.ndim == 2:
        scaled = dist[None, :, :] * scale
        expand = lambda m: m[None, :, :]
    else:
        scaled = dist[:, None, :, :] * scale
        expand = lambda m: m[:, None, :, :]
    if locality < 1.0:
        if keep is None:
            keep = (dist <= thr) if thr is not None else keep_mask(dist, locality)
        scaled = scaled.masked_fill(~expand(keep), _F32_MAX)
    # locality >= 1 keeps every entry (the quantile at 1 is the row max)
    return torch.softmax(-scaled, dim=-1)


def convolve(att: torch.Tensor, inputs: torch.Tensor) -> torch.Tensor:
    """Value contraction and head concat -> (B, L_out, H*D)."""
    if att.ndim == 3:
        out = torch.einsum("hnj,bjd->bnhd", att, inputs)
    else:
        out = torch.einsum("bhnj,bjd->bnhd", att, inputs)
    return out.reshape(out.shape[0], out.shape[1], -1)


def position_attention(
    dist: torch.Tensor,
    lmda: torch.Tensor,
    inputs: torch.Tensor,
    locality: float,
    keep: torch.Tensor | None = None,
    *,
    thr: torch.Tensor | None = None,
) -> torch.Tensor:
    """Full op: distances -> attention -> value contraction."""
    return convolve(attention_weights(dist, lmda, locality, keep, thr=thr), inputs)
