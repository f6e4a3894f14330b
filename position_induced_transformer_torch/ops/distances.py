"""Pairwise squared-distance metrics between point clouds.

The operations run in the same order as the JAX package's
``ops/distances.py``: the periodic metrics' kept sets depend on exact ties
between left and right neighbours, and a different op order would break
them (see ``ops/locality.py``).

Shapes:

- fixed meshes:   mesh_out (L_out, d), mesh_in (L_in, d)  -> (L_out, L_in)
- batched meshes: mesh_out (B, L_out, d), mesh_in (B, L_in, d) -> (B, L_out, L_in)
"""

from __future__ import annotations

import torch


def euclidean_sq(mesh_out: torch.Tensor, mesh_in: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distance; fixed and batched meshes."""
    diff = mesh_out[..., :, None, :] - mesh_in[..., None, :, :]
    return torch.sum(diff * diff, dim=-1)


def periodic1d_sq(mesh_out: torch.Tensor, mesh_in: torch.Tensor) -> torch.Tensor:
    """Squared distance on a 1-D torus (fixed meshes).

    Grid spacing from the first two input points, period ``dx * L_in``;
    only the first coordinate participates.
    """
    dx = torch.abs(mesh_in[1, 0] - mesh_in[0, 0])
    period = dx * mesh_in.shape[0]
    diff = torch.abs(mesh_out[:, None, :] - mesh_in[None, :, :])
    diff = torch.minimum(diff, period - diff)
    return diff[..., 0] * diff[..., 0]


def periodic2d_sq(mesh_out: torch.Tensor, mesh_in: torch.Tensor) -> torch.Tensor:
    """Squared distance on a 2-D torus (fixed meshes).

    Resolution ``sqrt(L_in)``, period per axis from the extent of the first
    axis; the per-axis minimum of direct and wrapped differences is summed.
    """
    res = int(round(mesh_in.shape[0] ** 0.5))
    dx = (torch.max(mesh_in[:, 0]) - torch.min(mesh_in[:, 0])) / (res - 1)
    period = dx * res
    diff = torch.abs(mesh_out[:, None, :] - mesh_in[None, :, :])
    diff = torch.minimum(diff, period - diff)
    return torch.sum(diff * diff, dim=-1)


_METRICS = {
    "euclidean": euclidean_sq,
    "periodic1d": periodic1d_sq,
    "periodic2d": periodic2d_sq,
}


def pairwise_sq_dist(mesh_out, mesh_in, metric: str = "euclidean"):
    """Dispatch by metric name ('euclidean' | 'periodic1d' | 'periodic2d')."""
    try:
        fn = _METRICS[metric]
    except KeyError:
        raise ValueError(
            f"unknown metric {metric!r}; expected one of {sorted(_METRICS)}"
        ) from None
    return fn(mesh_out, mesh_in)
