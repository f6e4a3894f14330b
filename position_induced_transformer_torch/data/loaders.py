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
