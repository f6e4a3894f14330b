"""Synthetic dataset generators (numpy).

Same generators, numpy RNG streams and seeds as the JAX package's
``data/synthetic.py``, so that both packages see identical inputs.
"""

from __future__ import annotations

import numpy as np


def _fourier_series_1d(rng, n, L, n_modes=8, decay=1.5):
    """Random smooth periodic functions on [0,1): (n, L)."""
    x = np.linspace(0, 1, L, endpoint=False)
    k = np.arange(1, n_modes + 1)
    amp = rng.standard_normal((n, n_modes)) / k[None, :] ** decay
    phase = rng.uniform(0, 2 * np.pi, (n, n_modes))
    return np.sum(
        amp[:, None, :] * np.sin(2 * np.pi * k[None, None, :] * x[None, :, None]
                                 + phase[:, None, :]),
        axis=-1,
    ).astype(np.float32)


def burgers(n=1152, L=1024, seed=0):
    """(x, y) pairs shaped (n, L, 1): smooth periodic initial conditions and
    a nonlinearly advected target (a stand-in for the inviscid Burgers
    solution operator)."""
    rng = np.random.default_rng(seed)
    u0 = _fourier_series_1d(rng, n, L)
    shift = (L * 0.1 * np.tanh(u0.mean(axis=1, keepdims=True))).astype(int)
    idx = (np.arange(L)[None, :] - shift) % L
    y = np.take_along_axis(u0, idx, axis=1)
    y = y - 0.2 * y * np.gradient(y, axis=1)
    return u0[..., None], y.astype(np.float32)[..., None]
