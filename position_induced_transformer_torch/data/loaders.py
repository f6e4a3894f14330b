"""Dataset loaders (numpy host arrays).

``.mat`` files are read with scipy (MATLAB v5); MATLAB v7.3 files, which
are HDF5, through the optional ``h5py``, imported only when such a file
is read (without it they raise, naming it). Without a usable file the
loaders fall back to the synthetic generators; a fallback from an
explicitly supplied path warns.
"""

from __future__ import annotations

import os
import warnings
from typing import Tuple

import numpy as np

from position_induced_transformer_torch.data import synthetic

_LFS_POINTER = b"version https://git-lfs"


def read_hdf5(path: str, transpose: bool) -> dict:
    """The datasets at the root of the HDF5 file ``path``, as arrays:
    transposed for MATLAB v7.3's column-major storage, native row-major
    layout otherwise. Groups (MATLAB structs and cells) are skipped with a
    warning, and ``#``-prefixed MATLAB bookkeeping silently. h5py is
    imported here; without it, or for a file it cannot open, this raises
    ``ValueError`` naming it."""
    try:
        import h5py
    except ImportError as e:
        raise ValueError(
            f"{path}: reading an HDF5 file (.h5, MATLAB v7.3 .mat) needs the "
            "optional package h5py, which is not installed; install it, or "
            "send .npy or a MATLAB v5 .mat"
        ) from e
    out, skipped = {}, []
    try:
        with h5py.File(path, "r") as f:
            for k, v in f.items():
                if isinstance(v, h5py.Dataset):
                    out[k] = np.array(v).T if transpose else np.array(v)
                elif not k.startswith("#"):
                    skipped.append(k)
    except OSError as e:
        raise ValueError(f"{path}: h5py cannot read it as HDF5 ({e})") from e
    if skipped:
        warnings.warn(
            f"{path}: skipped non-array HDF5 entries {skipped} "
            "(MATLAB structs/cells are not supported by this loader)",
            stacklevel=3,
        )
    return out


def load_mat(path: str) -> dict:
    """Load a MATLAB file into a dict of arrays: v5 through scipy, v7.3
    (and a bare HDF5 file, which has no MATLAB header) through h5py,
    transposed from MATLAB's column-major storage to ``loadmat``'s
    orientation."""
    from scipy.io import loadmat

    try:
        return loadmat(path)
    except (NotImplementedError, ValueError):
        # v7.3 raises NotImplementedError, bare HDF5 ValueError
        return read_hdf5(path, transpose=True)


def _is_real_file(path) -> bool:
    """A usable data file: exists and is not a git-LFS pointer stub."""
    if path is None or not os.path.exists(path):
        return False
    try:
        with open(path, "rb") as f:
            head = f.read(len(_LFS_POINTER))
    except OSError:
        return False
    return not head.startswith(_LFS_POINTER)


def _warn_fallback(requested, name: str):
    if requested is not None:
        warnings.warn(
            f"{name}: supplied data path {requested!r} is missing or a "
            "git-LFS stub; falling back to SYNTHETIC data — results are "
            "not real-benchmark numbers",
            stacklevel=3,
        )


def _split(arrays, n: int, ntrain: int, ntest: int, name: str):
    """Head-``ntrain`` / tail-``ntest`` split; raises instead of letting the
    two splits overlap on an undersized file."""
    if ntest < 1 or ntrain < 1:
        raise ValueError(f"{name}: ntrain/ntest must be >= 1")
    if n < ntrain + ntest:
        raise ValueError(
            f"{name}: dataset has {n} samples but ntrain+ntest = "
            f"{ntrain + ntest}; pass smaller ntrain/ntest"
        )
    out = []
    for a in arrays:
        out.append(a[:ntrain])
        out.append(a[-ntest:])
    return tuple(out)


def burgers(path=None, ntrain=1024, ntest=128, L=1024) -> Tuple[np.ndarray, ...]:
    if _is_real_file(path):
        data = load_mat(path)
        x = data["x"].astype(np.float32)[..., None]
        y = data["y"].astype(np.float32)[..., None]
    else:
        _warn_fallback(path, "burgers")
        x, y = synthetic.burgers(n=ntrain + ntest, L=L)
    x_tr, x_te, y_tr, y_te = _split((x, y), x.shape[0], ntrain, ntest, "burgers")
    return x_tr, y_tr, x_te, y_te


def sod(path=None, ntrain=1024, ntest=128, L=1024) -> Tuple[np.ndarray, ...]:
    """``(x_tr, y_tr, x_te, y_te)`` shaped (n, L, 3) in primitive variables
    (rho, u, p). A real file holds conservative ones (rho, m, E), turned
    into primitive ones in place: first p = (E - m^2 / (2 rho)) (gamma - 1),
    then u = m / rho."""
    gamma = 1.4
    if _is_real_file(path):
        data = load_mat(path)
        x = data["x"].astype(np.float32)
        y = data["y"].astype(np.float32)
        for arr in (x, y):
            arr[..., 2] = (arr[..., 2] - 0.5 * arr[..., 1] ** 2 / arr[..., 0]) * (
                gamma - 1
            )
            arr[..., 1] = arr[..., 1] / arr[..., 0]
    else:
        _warn_fallback(path, "sod")
        x, y = synthetic.sod(n=ntrain + ntest, L=L)
    x_tr, x_te, y_tr, y_te = _split((x, y), x.shape[0], ntrain, ntest, "sod")
    return x_tr, y_tr, x_te, y_te


def darcy(
    train_path=None, test_path=None, downsampling=10, ntrain=1024, ntest=100
) -> Tuple[np.ndarray, ...]:
    """``(x_tr, y_tr, x_te, y_te)`` shaped (n, s, s, 1) with s = 420 /
    downsampling + 1: every ``downsampling``-th point of the 421^2 grids
    (``coeff`` and ``sol``) of the two real files, the training split from
    the head of the first and the test split from the head of the second;
    else from the synthetic generator at resolution s."""
    s = int(((421 - 1) / downsampling) + 1)
    if _is_real_file(train_path) and _is_real_file(test_path):
        def slice_file(path, n, what):
            data = load_mat(path)
            a = data["coeff"].astype(np.float32)
            if a.shape[0] < n:
                raise ValueError(
                    f"darcy {what} file has {a.shape[0]} samples, "
                    f"requested {n}"
                )
            u = data["sol"].astype(np.float32)
            return (
                a[:n, ::downsampling, ::downsampling][:, :s, :s][..., None],
                u[:n, ::downsampling, ::downsampling][:, :s, :s][..., None],
            )

        xtr, ytr = slice_file(train_path, ntrain, "train")
        xte, yte = slice_file(test_path, ntest, "test")
        return xtr, ytr, xte, yte
    _warn_fallback(train_path or test_path, "darcy")
    x, y = synthetic.darcy(n=ntrain + ntest, s=s)
    x_tr, x_te, y_tr, y_te = _split((x, y), x.shape[0], ntrain, ntest, "darcy")
    return x_tr, y_tr, x_te, y_te


def vorticity(
    path=None, ntrain=1000, ntest=200, memory=10, steps=20
) -> Tuple[np.ndarray, ...]:
    """``(x_tr, y_tr, x_te, y_te)``: the first ``memory`` frames of each
    (n, s, s, T) trajectory (variable ``u`` of a real ``.mat``, else the
    synthetic generator) as inputs, the next ``steps`` frames as targets.
    A file with fewer than ``memory + steps`` frames raises."""
    if _is_real_file(path):
        flow = load_mat(path)["u"].astype(np.float32)
        if flow.shape[-1] < memory + steps:
            raise ValueError(
                f"vorticity file has {flow.shape[-1]} frames; the "
                f"configured memory+rollout needs {memory + steps} — "
                "targets would be silently truncated"
            )
    else:
        _warn_fallback(path, "vorticity")
        flow = synthetic.vorticity(n=ntrain + ntest, frames=memory + steps)
    (flow_tr, flow_te) = _split((flow,), flow.shape[0], ntrain, ntest, "vorticity")
    return (
        flow_tr[:, :, :, :memory],
        flow_tr[:, :, :, memory : memory + steps],
        flow_te[:, :, :, :memory],
        flow_te[:, :, :, memory : memory + steps],
    )


def elasticity(
    dirpath=None, ntrain=1000, ntest=200, n_points=972
) -> Tuple[np.ndarray, ...]:
    """``(X_tr, ext_tr, Y_tr, X_te, ext_te, Y_te)`` from the three
    ``Random_UnitCell_{rr,XY,sigma}_10.npy`` files in ``dirpath``, or from
    the synthetic generator when they are absent."""
    paths = None
    if dirpath is not None:
        paths = {
            k: os.path.join(dirpath, f"Random_UnitCell_{k}_10.npy")
            for k in ("rr", "XY", "sigma")
        }
    if paths and all(_is_real_file(p) for p in paths.values()):
        # cast before the (N, 972, 42) repeat: float64 would double it
        r = np.transpose(np.load(paths["rr"]), (1, 0))[:, None, :].astype(np.float32)
        ext = np.transpose(np.load(paths["XY"]), (2, 0, 1)).astype(np.float32)
        rvec = np.repeat(5 * r - 1, ext.shape[1], 1)
        X = np.concatenate([ext, rvec], axis=-1)
        Y = np.transpose(np.load(paths["sigma"]), (1, 0))[..., None].astype(np.float32)
    else:
        _warn_fallback(dirpath, "elasticity")
        X, ext, Y = synthetic.elasticity(n=ntrain + ntest, L=n_points)
    X_tr, X_te, ext_tr, ext_te, Y_tr, Y_te = _split(
        (X, ext, Y), X.shape[0], ntrain, ntest, "elasticity"
    )
    return X_tr, ext_tr, Y_tr, X_te, ext_te, Y_te


_NACA_FILES = ("shape_coords.npy", "NACA_Cylinder_X.npy", "NACA_Cylinder_Y.npy",
               "NACA_Cylinder_Q.npy")


def naca(
    dirpath=None, ntrain=1000, ntest=200, nx=221, ny=51, n_shape=120,
) -> Tuple[np.ndarray, ...]:
    """``(c_tr, X_tr, Y_tr, c_te, X_te, Y_te)``: airfoil shape points (n,
    n_shape, 2), C-grid vertices (n, nx, ny, 2) and the flow variables
    (n, nx, ny, 4), channels 0-3 of ``Q`` (the torch family's targets),
    from the four ``.npy`` files in ``dirpath`` when all are real, else
    from the synthetic generator. (The single Mach channel of the TF
    family's targets is not ported.)"""
    if dirpath is not None and all(
        _is_real_file(os.path.join(dirpath, f)) for f in _NACA_FILES
    ):
        coords = np.load(os.path.join(dirpath, "shape_coords.npy")).astype(np.float32)
        vx = np.load(os.path.join(dirpath, "NACA_Cylinder_X.npy"))[..., None]
        vy = np.load(os.path.join(dirpath, "NACA_Cylinder_Y.npy"))[..., None]
        X = np.concatenate([vx, vy], -1).astype(np.float32)
        Q = np.load(os.path.join(dirpath, "NACA_Cylinder_Q.npy"))
        Y = Q[:, :4].transpose(0, 2, 3, 1).astype(np.float32)
    else:
        _warn_fallback(dirpath, "naca")
        coords, X, Y = synthetic.naca(n=ntrain + ntest, n_shape=n_shape, nx=nx, ny=ny)
    c_tr, c_te, X_tr, X_te, Y_tr, Y_te = _split(
        (coords, X, Y), X.shape[0], ntrain, ntest, "naca"
    )
    return c_tr, X_tr, Y_tr, c_te, X_te, Y_te


def cylinder(
    train_path=None,
    test_path=None,
    vertices_path=None,
    vertices_small_path=None,
    ntrain=1000,
    ntest=100,
    n_points=4390,
    n_latent=896,
    elements_path=None,
) -> Tuple[np.ndarray, ...]:
    """``(trainX, trainY, testX, testY, mesh, mesh_ltt, test_traj,
    elements)``: ``ntrain`` and ``ntest`` trajectories (N, L, 3, T) cut
    into T - 1 one-step pairs each, (N (T - 1), L, 3); the raw test
    trajectories, kept for the rollout evaluation; the (L, 2) mesh and the
    latent cloud; and ``elements``, the (M, 3) 0-based triangles of the
    field plots.

    The trajectories come from ``WakeCylinder_{train,test}.mat`` (variable
    ``trajectories``) and the meshes from ``vertices.csv`` and
    ``vertices_small.csv`` when all four are real files, else from the
    synthetic generator. ``elements.csv`` is 1-based on disk; without it a
    Delaunay triangulation of the mesh stands in."""
    paths = (train_path, test_path, vertices_path, vertices_small_path)
    if all(_is_real_file(p) for p in paths):
        tr = load_mat(train_path)["trajectories"].astype(np.float32)[:ntrain]
        te = load_mat(test_path)["trajectories"].astype(np.float32)[:ntest]
        if tr.shape[0] < ntrain or te.shape[0] < ntest:
            raise ValueError(
                f"cylinder files have {tr.shape[0]}/{te.shape[0]} "
                f"trajectories, requested {ntrain}/{ntest}"
            )
        mesh = np.genfromtxt(vertices_path, delimiter=",").astype(np.float32)
        mesh_ltt = np.genfromtxt(vertices_small_path, delimiter=",").astype(np.float32)
    else:
        _warn_fallback(train_path or test_path, "cylinder")
        traj, mesh, mesh_ltt = synthetic.cylinder(
            n_traj=ntrain + ntest, L=n_points, n_small=n_latent
        )
        tr, te = traj[:ntrain], traj[-ntest:]
    if _is_real_file(elements_path):
        elements = np.genfromtxt(elements_path, delimiter=",").astype(np.int32) - 1
    else:
        from scipy.spatial import Delaunay

        elements = Delaunay(np.asarray(mesh)).simplices.astype(np.int32)
    L = tr.shape[1]

    def one_step_pairs(t):
        x = t[:, :, :, :-1].transpose(0, 3, 1, 2).reshape(-1, L, 3)
        y = t[:, :, :, 1:].transpose(0, 3, 1, 2).reshape(-1, L, 3)
        return x, y

    trainX, trainY = one_step_pairs(tr)
    testX, testY = one_step_pairs(te)
    return trainX, trainY, testX, testY, mesh, mesh_ltt, te, elements
