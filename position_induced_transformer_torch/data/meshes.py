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
