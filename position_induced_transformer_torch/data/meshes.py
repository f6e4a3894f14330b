"""Mesh builders for regular grids (numpy, host side)."""

from __future__ import annotations

import numpy as np


def grid_1d(n: int, lo: float = 0.0, hi: float = 1.0, endpoint: bool = False):
    """(n, 1) uniform 1-D mesh. ``endpoint=False`` drops the final point
    (the periodic convention)."""
    pts = np.linspace(lo, hi, n if endpoint else n + 1)
    if not endpoint:
        pts = pts[:-1]
    return pts.reshape(-1, 1).astype(np.float32)


def grid_2d(s: int, endpoint: bool = True):
    """(s, s, 2) uniform 2-D mesh on [0,1]^2 in the 'xy' meshgrid stacking
    order. ``endpoint=False`` drops the last point of each axis (the
    periodic convention)."""
    if endpoint:
        xs = np.linspace(0, 1, s)
    else:
        xs = np.linspace(0, 1, s + 1)[:-1]
    xx, yy = np.meshgrid(xs, xs)
    mesh = np.stack([xx.ravel(), yy.ravel()], axis=-1)
    return mesh.reshape(s, s, 2).astype(np.float32)


def angular_sort_perm(coords):
    """Per-sample permutation ordering a 2-D point cloud by angle around
    its centroid: (n, L, 2) -> (n, L) indices.

    For a cloud sampled along a closed curve (the elasticity cell boundary)
    index order then follows spatial order, so each row tile's kept columns
    form a narrow circular band (``ops.locality.batched_band_starts`` with
    ``circular=True``). Position attention is permutation-equivariant in
    its keys and the loss is per point, so sorting inputs, coordinates and
    targets with one permutation changes only the order of the outputs.
    """
    c = np.asarray(coords)
    d = c - c.mean(axis=1, keepdims=True)
    return np.argsort(np.arctan2(d[..., 1], d[..., 0]), axis=1)
