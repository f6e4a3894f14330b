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


def _clamp_void_inside(a, da, radius, dradius):
    """Keep the void boundary strictly inside the measurement curve: clamp
    the profile to 0.92 * radius (still continuous in theta) and take the
    matching branch's derivative where the clamp is active."""
    cap = 0.92 * radius
    da = np.where(a < cap, da, 0.92 * dradius)
    a = np.minimum(a, cap)
    return a, da


def _void_radius(r_ctrl, theta, n_harm=6):
    """Void-boundary radius a(theta) and its derivative from 42 control
    radii by truncated trigonometric interpolation: r_ctrl (n, 42), theta
    (n, L) -> a, da (n, L)."""
    n_ctrl = r_ctrl.shape[-1]
    phi = 2 * np.pi * np.arange(n_ctrl) / n_ctrl
    a = np.full(theta.shape, r_ctrl.mean(-1, keepdims=True))
    da = np.zeros_like(theta)
    for k in range(1, n_harm + 1):
        ck = (r_ctrl * np.cos(k * phi)).mean(-1, keepdims=True) * 2
        sk = (r_ctrl * np.sin(k * phi)).mean(-1, keepdims=True) * 2
        a += ck * np.cos(k * theta) + sk * np.sin(k * theta)
        da += k * (sk * np.cos(k * theta) - ck * np.sin(k * theta))
    return a, da


def elasticity(n=1200, L=972, seed=0):
    """(X, ext, Y): X (n, L, 44) = coordinates ++ the sample's 42-dim radius
    vector, ext (n, L, 2) the point cloud, Y (n, L, 1) a Kirsch-type von
    Mises stress.

    The 42 control radii shape a smooth void boundary around (0.5, 0.5);
    the cloud is a separate closed curve, sorted by angle, whose
    coordinates say nothing of the void. The target is the plane-stress
    Kirsch solution for a hole of the local void radius under uniaxial
    tension, amplified by the local shape gradient.
    """
    rng = np.random.default_rng(seed)
    theta = np.sort(rng.uniform(0, 2 * np.pi, (n, L)), axis=1)
    r_inner = 0.2 + 0.05 * rng.standard_normal((n, 42))
    kk = np.arange(1, 8)
    amp = rng.standard_normal((n, 7)) * 0.03 / kk
    radius = 0.35 + np.sum(
        amp[:, None, :] * np.cos(theta[..., None] * kk[None, None, :]), axis=-1
    )
    ext = np.stack(
        [0.5 + radius * np.cos(theta), 0.5 + radius * np.sin(theta)], axis=-1
    ).astype(np.float32)
    rvec = np.repeat((5 * r_inner - 1)[:, None, :], L, axis=1).astype(np.float32)
    X = np.concatenate([ext, rvec], axis=-1)
    a, da = _void_radius(r_inner, theta)
    dradius = -np.sum(
        amp[:, None, :] * kk[None, None, :]
        * np.sin(theta[..., None] * kk[None, None, :]),
        axis=-1,
    )
    a, da = _clamp_void_inside(a, da, radius, dradius)
    ar2 = (a / radius) ** 2
    ar4 = ar2 * ar2
    c2t, s2t = np.cos(2 * theta), np.sin(2 * theta)
    s_rr = 0.5 * (1 - ar2) + 0.5 * (1 - 4 * ar2 + 3 * ar4) * c2t
    s_tt = 0.5 * (1 + ar2) - 0.5 * (1 + 3 * ar4) * c2t
    s_rt = -0.5 * (1 + 2 * ar2 - 3 * ar4) * s2t
    vm = np.sqrt(s_rr**2 - s_rr * s_tt + s_tt**2 + 3 * s_rt**2)
    Y = (vm * (1 + 1.5 * (da / a) ** 2))[..., None].astype(np.float32)
    return X, ext, Y
