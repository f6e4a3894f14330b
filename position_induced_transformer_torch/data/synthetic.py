"""Synthetic dataset generators (numpy): Burgers, sod, Darcy, elasticity.

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


_GAMMA = 1.4  # a diatomic gas


def _riemann_star(rl, ul, pl, rr, ur, pr, g=_GAMMA, n_iter=60):
    """Star-region pressure and velocity of the 1-D Euler Riemann problem:
    exact, Newton on the standard pressure function (Toro, ch. 4).

    All inputs broadcastable float64 arrays. Returns (p*, u*, c_l, c_r)."""
    cl = np.sqrt(g * pl / rl)
    cr = np.sqrt(g * pr / rr)

    def f_and_df(p, rk, pk, ck):
        # the shock branch (p > pk) and the rarefaction branch, both evaluated
        ak = 2.0 / ((g + 1.0) * rk)
        bk = (g - 1.0) / (g + 1.0) * pk
        root = np.sqrt(ak / (p + bk))
        f_sh = (p - pk) * root
        df_sh = root * (1.0 - (p - pk) / (2.0 * (p + bk)))
        pr_ = p / pk
        f_ra = 2.0 * ck / (g - 1.0) * (pr_ ** ((g - 1.0) / (2.0 * g)) - 1.0)
        df_ra = (1.0 / (rk * ck)) * pr_ ** (-(g + 1.0) / (2.0 * g))
        sh = p > pk
        return np.where(sh, f_sh, f_ra), np.where(sh, df_sh, df_ra)

    du = ur - ul
    # the two-rarefaction guess: positive and near the root over the
    # shock-tube states sampled by sod(), so Newton converges fast
    z = (g - 1.0) / (2.0 * g)
    p = ((cl + cr - 0.5 * (g - 1.0) * du)
         / (cl / pl**z + cr / pr**z)) ** (1.0 / z)
    p = np.maximum(p, 1e-10)
    for _ in range(n_iter):
        fl, dfl = f_and_df(p, rl, pl, cl)
        fr, dfr = f_and_df(p, rr, pr, cr)
        p = np.maximum(p - (fl + fr + du) / (dfl + dfr), 1e-10)
    fl, _ = f_and_df(p, rl, pl, cl)
    fr, _ = f_and_df(p, rr, pr, cr)
    us = 0.5 * (ul + ur) + 0.5 * (fr - fl)
    return p, us, cl, cr


def _riemann_sample(rl, ul, pl, rr, ur, pr, ps, us, cl, cr, xi, g=_GAMMA):
    """The self-similar exact solution W(xi), xi = (x - x0) / t.

    State arrays broadcast against ``xi``; returns (rho, u, p). Every
    branch (shock, rarefaction fan, star and outer state, on each side) is
    evaluated densely and selected with nested ``np.where``."""
    gm1, gp1 = g - 1.0, g + 1.0
    b = gm1 / gp1

    def one_side(rk, uk, pk, ck, sgn):
        # sgn = -1 for the left wave, +1 for the right wave
        pratio = ps / pk
        csk = ck * pratio ** (gm1 / (2.0 * g))
        r_star_sh = rk * (pratio + b) / (b * pratio + 1.0)
        r_star_ra = rk * pratio ** (1.0 / g)
        s_shock = uk + sgn * ck * np.sqrt(
            gp1 / (2.0 * g) * pratio + gm1 / (2.0 * g)
        )
        s_head = uk + sgn * ck
        s_tail = us + sgn * csk
        # inside the rarefaction fan
        u_fan = 2.0 / gp1 * (-sgn * ck + gm1 / 2.0 * uk + xi)
        c_fan = 2.0 / gp1 * (ck - sgn * gm1 / 2.0 * (uk - xi))
        r_fan = rk * (c_fan / ck) ** (2.0 / gm1)
        p_fan = pk * (c_fan / ck) ** (2.0 * g / gm1)
        outer = sgn * xi > sgn * s_shock  # a shock: beyond it
        out_h = sgn * xi > sgn * s_head   # a rarefaction: beyond its head
        in_star_ra = sgn * xi < sgn * s_tail
        shock = ps > pk
        rho = np.where(
            shock,
            np.where(outer, rk, r_star_sh),
            np.where(out_h, rk, np.where(in_star_ra, r_star_ra, r_fan)),
        )
        u = np.where(
            shock,
            np.where(outer, uk, us),
            np.where(out_h, uk, np.where(in_star_ra, us, u_fan)),
        )
        p = np.where(
            shock,
            np.where(outer, pk, ps),
            np.where(out_h, pk, np.where(in_star_ra, ps, p_fan)),
        )
        return rho, u, p

    rho_l, u_l, p_l = one_side(rl, ul, pl, cl, -1.0)
    rho_r, u_r, p_r = one_side(rr, ur, pr, cr, +1.0)
    left = xi < us
    return (
        np.where(left, rho_l, rho_r),
        np.where(left, u_l, u_r),
        np.where(left, p_l, p_r),
    )


def sod(n=1152, L=1024, seed=0, t_final=2.0):
    """(x, y) shaped (n, L, 3): exact shock-tube solutions of the 1-D Euler
    equations in primitive variables (rho, u, p) on [-5, 5).

    x is the Riemann initial condition (two constant states, the diaphragm
    at a random x0 in [-1, 1]) and y the exact self-similar solution at
    ``t_final``: shock, contact and rarefaction resolved analytically.
    The states are drawn around the classic Sod values (1, 0, 1) /
    (0.125, 0, 0.1); at seed 0 and n 1152 every wave stays inside [-5, 5).
    """
    rng = np.random.default_rng(seed)
    s = np.linspace(-5, 5, L, endpoint=False)
    x0 = rng.uniform(-1, 1, (n, 1))
    rl = rng.uniform(0.85, 1.15, (n, 1))
    pl = rng.uniform(0.85, 1.15, (n, 1))
    rr = rng.uniform(0.100, 0.150, (n, 1))
    pr = rng.uniform(0.080, 0.120, (n, 1))
    ul = np.zeros((n, 1))
    ur = np.zeros((n, 1))

    right0 = s[None, :] >= x0
    x = np.stack(
        [
            np.where(right0, rr, rl) * np.ones_like(s),
            np.zeros((n, L)),
            np.where(right0, pr, pl) * np.ones_like(s),
        ],
        axis=-1,
    )
    ps, us, cl, cr = _riemann_star(rl, ul, pl, rr, ur, pr)
    xi = (s[None, :] - x0) / t_final
    rho, u, p = _riemann_sample(rl, ul, pl, rr, ur, pr, ps, us, cl, cr, xi)
    y = np.stack([rho, u, p], axis=-1)
    return x.astype(np.float32), y.astype(np.float32)


def _grf_modes(rng, n, n_modes=6, decay=2.0):
    """Random mode amplitudes of a 2-D sine GRF (resolution-independent)."""
    k = np.arange(1, n_modes + 1)
    ksq = k[:, None] ** 2 + k[None, :] ** 2
    return (
        rng.standard_normal((n, n_modes, n_modes)) / ksq[None] ** (decay / 2)
    ).astype(np.float32)


def _eval_modes(amp, s, extra_damp=0.0, phase_x=None, phase_y=None):
    """sum_ij amp_ij * sin(i pi x + phi_i) sin(j pi y + psi_j) on an s x s
    grid, with optional extra (i^2 + j^2)-power damping: the same
    continuous function at every s. Per-sample phases (phase_x, phase_y
    shaped (n, m)) leave no pixel pinned across samples."""
    n_modes = amp.shape[-1]
    x = np.linspace(0, 1, s)
    k = np.arange(1, n_modes + 1)
    if extra_damp:
        ksq = k[:, None] ** 2 + k[None, :] ** 2
        amp = amp / ksq[None] ** extra_damp
    if phase_x is None:
        sx = np.sin(np.pi * np.outer(x, k))  # (s, m)
        return np.einsum("nij,xi,yj->nxy", amp, sx, sx).astype(np.float32)
    arg = np.pi * x[None, :, None] * k[None, None, :]  # (1, s, m)
    sx = np.sin(arg + phase_x[:, None, :])  # (n, s, m)
    sy = np.sin(arg + phase_y[:, None, :])
    return np.einsum(
        "nij,nxi,nyj->nxy", amp, sx, sy, optimize=True
    ).astype(np.float32)


def darcy(n=1124, s=43, seed=0):
    """(x, y) shaped (n, s, s, 1): a smoothly thresholded sine-GRF
    permeability in [4, 12] and a mode-damped solution stand-in under the
    Dirichlet window 64 x(1-x) y(1-y).

    Both are analytic functions of the same per-sample mode amplitudes and
    phases, so every resolution samples the same operator:
    ``darcy(s=43) == darcy(s=421)[:, ::10, ::10]``, which is what makes
    the zero-shot super-resolution evaluation meaningful on synthetic data.
    """
    rng = np.random.default_rng(seed)
    amp = _grf_modes(rng, n)
    n_modes = amp.shape[-1]
    phx = rng.uniform(0, 2 * np.pi, (n, n_modes)).astype(np.float32)
    phy = rng.uniform(0, 2 * np.pi, (n, n_modes)).astype(np.float32)
    g = _eval_modes(amp, s, phase_x=phx, phase_y=phy)
    coeff = (4.0 + 8.0 / (1.0 + np.exp(-6.0 * g))).astype(np.float32)
    sol = 0.1 * _eval_modes(amp, s, extra_damp=1.0, phase_x=phx, phase_y=phy)
    t = np.linspace(0, 1, s, dtype=np.float32)
    w = 4.0 * t * (1.0 - t)
    sol = sol * (4.0 * w[None, :, None] * w[None, None, :])
    return coeff[..., None], sol[..., None]


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
