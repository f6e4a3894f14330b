"""Inputs of the ``elasticity_tf`` configuration, made from the seed.

Each sample stands in for a published elasticity unit cell: a point cloud
of ``n_points`` points on a closed curve around (0.5, 0.5) (random angles,
sorted; a radius of 0.35 with seven random harmonics, held below 0.49),
42 control radii of the void, and a Kirsch-type von Mises stress on the
cloud, as the program's synthetic generator shapes them. The coordinates
lie on a 2**-12 lattice and the cloud's diameter is below 1, so every
(halved) squared distance is exact in float32 whatever the order of
operations, and the kept sets of the thresholds are defined by the inputs
alone. The model's input per point is the two coordinates and the 42
radii mapped to ``5 r - 1``, as the published loader builds it.
"""

from __future__ import annotations

import os

import numpy as np

from portbench.seeds import stream_seed

LATTICE = 4096
N_CTRL = 42


def _void_radius(r_ctrl, theta, n_harm=6):
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


def clouds(seed: int, n: int, n_points: int, purpose: str = "inputs") -> tuple:
    """(ext (n, L, 2) float32 on the lattice, r (n, 42) float32 control
    radii, y (n, L, 1) float32 stress)."""
    rng = np.random.default_rng(stream_seed(seed, purpose))
    theta = np.sort(rng.uniform(0, 2 * np.pi, (n, n_points)), axis=1)
    r_inner = 0.2 + 0.05 * rng.standard_normal((n, N_CTRL))
    kk = np.arange(1, 8)
    amp = rng.standard_normal((n, 7)) * 0.03 / kk
    radius = 0.35 + np.sum(amp[:, None, :] * np.cos(theta[..., None] * kk), axis=-1)
    dradius = -np.sum(amp[:, None, :] * kk * np.sin(theta[..., None] * kk), axis=-1)
    radius = np.minimum(radius, 0.49)
    ext = 0.5 + radius[..., None] * np.stack([np.cos(theta), np.sin(theta)], axis=-1)
    ext = (np.round(ext * LATTICE) / LATTICE).astype(np.float32)
    a, da = _void_radius(r_inner, theta)
    cap = 0.92 * radius
    da = np.where(a < cap, da, 0.92 * dradius)
    a = np.minimum(a, cap)
    ar2 = (a / radius) ** 2
    ar4 = ar2 * ar2
    c2t, s2t = np.cos(2 * theta), np.sin(2 * theta)
    s_rr = 0.5 * (1 - ar2) + 0.5 * (1 - 4 * ar2 + 3 * ar4) * c2t
    s_tt = 0.5 * (1 + ar2) - 0.5 * (1 + 3 * ar4) * c2t
    s_rt = -0.5 * (1 + 2 * ar2 - 3 * ar4) * s2t
    vm = np.sqrt(s_rr**2 - s_rr * s_tt + s_tt**2 + 3 * s_rt**2)
    y = (vm * (1 + 1.5 * (da / a) ** 2))[..., None].astype(np.float32)
    return ext, r_inner.astype(np.float32), y


def model_input(ext: np.ndarray, r: np.ndarray) -> np.ndarray:
    """(n, L, 44): the coordinates and ``5 r - 1`` at every point."""
    rvec = np.repeat((5 * r - 1)[:, None, :], ext.shape[1], axis=1)
    return np.concatenate([ext, rvec], axis=-1)


def write_setup_files(ext, r, y, path: str) -> str:
    """The data directory the program's elasticity setup reads: the three
    ``Random_UnitCell_{rr,XY,sigma}_10.npy`` arrays in the published
    layout."""
    os.makedirs(path, exist_ok=True)
    np.save(os.path.join(path, "Random_UnitCell_rr_10.npy"), r.T)
    np.save(os.path.join(path, "Random_UnitCell_XY_10.npy"), ext.transpose(1, 2, 0))
    np.save(os.path.join(path, "Random_UnitCell_sigma_10.npy"), y[..., 0].T)
    return path


def train_problem(cfg: dict, pcfg, seed: int, device, workdir: str) -> tuple:
    """(the program's Problem, the training data the window feeds, the
    inputs the reference reads): the program's setup reads the
    ``ntrain + ntest`` clouds from files in the published layout, sorts
    each by angle and works out its thresholds and bands; the window feeds
    its training split from the device. The reference reads the same
    clouds as made here (the model and the loss do not depend on the order
    of a cloud's points)."""
    import torch

    from position_induced_transformer_torch.train import benchmarks

    ext, r, y = clouds(seed, cfg["ntrain"] + cfg["ntest"], cfg["inputs"]["n_points"])
    path = write_setup_files(ext, r, y, os.path.join(workdir, "data"))
    problem = benchmarks.setup(pcfg, path, device=device)
    data = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in problem.train_data.items()}
    n = cfg["ntrain"]
    x = torch.from_numpy(model_input(ext[:n], r[:n])).to(device)
    return problem, data, {"x": x, "y": torch.from_numpy(y[:n]).to(device)}


def infer_inputs(cfg: dict, seed: int, device, workdir: str, n_fields: int) -> tuple:
    """(the data directory the Predictor's setup reads, ``n_fields`` model
    inputs as one host array, the inputs the reference reads): the
    directory holds 16 clouds of their own, which the Predictor's setup
    takes for its layouts; every cloud is in its input's first two
    channels, so the reference needs nothing more."""
    n_points = cfg["inputs"]["n_points"]
    path = write_setup_files(*clouds(seed, 16, n_points, purpose="layout"),
                             os.path.join(workdir, "data"))
    ext, r, _ = clouds(seed, n_fields, n_points, purpose="infer")
    return path, model_input(ext, r), {}
