"""Instance normalization over the mesh axis."""

from __future__ import annotations

import torch


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm over the mesh axis of a (B, L, C) tensor: per (sample,
    channel) statistics over L, biased variance, no affine parameters."""
    mean = torch.mean(x, dim=1, keepdim=True)
    var = torch.var(x, dim=1, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)
