"""Quantile-based locality masking for position attention.

The bandwidth scale is non-negative and the quantile commutes with a
non-negative scalar, so the keep mask ``d <= quantile(d)`` does not depend
on the learnable bandwidth or the head: it is computed once per mesh pair.

On regular periodic grids a row's cut can fall inside a tie of two equal
distances (the left and right neighbours). Whether the tie is kept then
depends on the distances being bit-identical, which is why
``ops/distances.py`` keeps the JAX package's op order.
"""

from __future__ import annotations

import torch


def quantile_threshold(dist: torch.Tensor, locality: float) -> torch.Tensor:
    """Per-row linear-interpolation quantile along the last axis, keepdim.

    ``torch.quantile`` refuses inputs of more than 2**24 elements.
    """
    return torch.quantile(
        dist, locality, dim=-1, keepdim=True, interpolation="linear"
    )


def keep_mask(dist: torch.Tensor, locality: float) -> torch.Tensor:
    """Boolean mask of entries at or below the per-row locality quantile."""
    return dist <= quantile_threshold(dist, locality)
