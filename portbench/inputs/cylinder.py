"""Inputs of the ``cylinder`` configuration, made from the seed.

The mesh stands in for the published FEniCS mesh of the wake behind a
cylinder in the 2.2 x 0.41 channel: ``n_points`` distinct vertices drawn
uniformly from a 2**-10 lattice over the channel, and a latent cloud of
``n_latent`` of them. On that lattice every squared distance is a sum of
two squares of integers below 2**12, exact in float32 whatever the order
of operations, so the kept sets of the locality quantiles are defined by
the inputs alone. The fields are one-step pairs (frame t -> t + 1) of
11-frame trajectories of a closed-form von Karman street (three
downstream-travelling harmonics with per-trajectory random amplitudes,
phases, wavenumber and speed, a meandering wake envelope, a parabolic
channel profile, a slowdown at the cylinder at (0.25, 0.2)), made on the
device.

``write_setup_files`` writes what the program's cylinder setup reads from a
data directory (``vertices.csv``, ``vertices_small.csv`` and one trajectory
in each of ``WakeCylinder_{train,test}.mat``), so that its geometry is
built from this mesh.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from portbench.weights import generator

LATTICE = 1024  # points per unit length
CHANNEL = (2.2, 0.41)


def mesh(cfg: dict, seed: int, device) -> tuple:
    """(mesh (n_points, 2), mesh_ltt (n_latent, 2)) float32 on ``device``."""
    inp = cfg["inputs"]
    nx, ny = (int(math.floor(c * LATTICE)) + 1 for c in CHANNEL)
    nx, ny = nx - 1, ny - 1  # strictly inside the channel
    g = generator(seed, "mesh", device)
    cells = torch.randperm(nx * ny, generator=g, device=device)[: inp["n_points"]]
    m = torch.stack([cells // ny, cells % ny], dim=-1).float() / LATTICE
    ltt = torch.randperm(inp["n_points"], generator=g, device=device)[: inp["n_latent"]]
    return m.contiguous(), m[ltt].contiguous()


def trajectories(cfg: dict, seed: int, m: torch.Tensor, n_traj: int) -> torch.Tensor:
    """(n_traj, frames, L, 3) float32 (u, v, p) on ``m``'s device."""
    frames = cfg["inputs"]["frames"]
    dev = m.device
    g = generator(seed, "fields", dev)
    rand = lambda *shape: torch.rand(shape, generator=g, device=dev)
    x0, y0, R = 0.25, 0.2, 0.05
    kappa = 8.0 + 4.0 * rand(n_traj, 1, 1)
    speed = 0.08 + 0.04 * rand(n_traj, 1, 1)
    amp = 0.3 * (0.5 + 0.5 * rand(n_traj, 1, 3)) / torch.tensor([1.0, 1.6, 2.4], device=dev)
    phase = 2 * math.pi * rand(n_traj, 1, 3)
    kmul = torch.tensor([1.0, 1.53, 2.31], device=dev)
    xv, yv = m[None, :, 0:1], m[None, :, 1:2]
    prof = 4 * yv * (0.41 - yv) / 0.41**2
    slow = 1 - 0.8 * torch.exp(-((xv - x0) ** 2 + (yv - y0) ** 2) / (4 * R**2))
    wake_w = 0.05 + 0.07 * torch.clamp(xv - x0, min=0.0)
    onset = 1 / (1 + torch.exp(-(xv - x0 - 0.1) / 0.05))
    out = torch.empty((n_traj, frames, m.shape[0], 3), device=dev)
    for t in range(frames):
        arg = kappa * kmul * (xv - speed * t) + phase
        y_off = 0.03 * torch.sin(0.5 * kappa * (xv - speed * t) + phase[..., :1])
        env = onset * torch.exp(-((yv - y0 - y_off) ** 2) / (2 * wake_w**2))
        su = (amp * torch.sin(arg)).sum(-1, keepdim=True)
        sv = (amp * torch.cos(arg)).sum(-1, keepdim=True)
        sp = (0.6 * amp * torch.sin(arg + math.pi / 4)).sum(-1, keepdim=True)
        out[:, t] = torch.cat([prof * slow + su * env, 0.8 * sv * env,
                               0.5 * (2.2 - xv) / 2.2 + sp * env], dim=-1)
    return out


def pairs(cfg: dict, seed: int, m: torch.Tensor, n_pairs: int) -> tuple:
    """(x, y), each (n_pairs, L, 3): frame t and frame t + 1."""
    per = cfg["inputs"]["frames"] - 1
    traj = trajectories(cfg, seed, m, -(-n_pairs // per))
    L = m.shape[0]
    x = traj[:, :-1].reshape(-1, L, 3)[:n_pairs].contiguous()
    y = traj[:, 1:].reshape(-1, L, 3)[:n_pairs].contiguous()
    return x, y


def write_setup_files(cfg: dict, seed: int, m: torch.Tensor, ltt: torch.Tensor, path: str) -> str:
    """The data directory the program's setup reads this mesh from."""
    from scipy.io import savemat

    os.makedirs(path, exist_ok=True)
    # multiples of 2**-10 below 4 print exactly with 10 decimals
    np.savetxt(os.path.join(path, "vertices.csv"), m.cpu().numpy(), fmt="%.10f", delimiter=",")
    np.savetxt(os.path.join(path, "vertices_small.csv"), ltt.cpu().numpy(), fmt="%.10f",
               delimiter=",")
    traj = trajectories(cfg, seed, m, 1).permute(0, 2, 3, 1).cpu().numpy()  # (1, L, 3, T)
    for split in ("train", "test"):
        savemat(os.path.join(path, f"WakeCylinder_{split}.mat"), {"trajectories": traj})
    return path


def train_problem(cfg: dict, pcfg, seed: int, device, workdir: str) -> tuple:
    """(the program's Problem, the training pairs the window feeds, the
    inputs the reference reads): the program's setup builds its geometry
    and model from this mesh; the ``ntrain`` pairs are made on the device."""
    from position_induced_transformer_torch.train import benchmarks

    m, ltt = mesh(cfg, seed, device)
    path = write_setup_files(cfg, seed, m, ltt, os.path.join(workdir, "data"))
    problem = benchmarks.setup(pcfg, path, ntrain=10, ntest=10, device=device)
    x, y = pairs(cfg, seed, m, cfg["ntrain"])
    return problem, {"x": x, "y": y}, {"mesh": m, "ltt": ltt, "x": x, "y": y}


def infer_inputs(cfg: dict, seed: int, device, workdir: str, n_fields: int) -> tuple:
    """(the data directory the Predictor reads the mesh from, ``n_fields``
    input fields as one host array, the inputs the reference reads)."""
    m, ltt = mesh(cfg, seed, device)
    path = write_setup_files(cfg, seed, m, ltt, os.path.join(workdir, "data"))
    x, _ = pairs(cfg, seed, m, n_fields)
    return path, x.cpu().numpy(), {"mesh": m, "ltt": ltt}
