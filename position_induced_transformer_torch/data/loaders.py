"""Dataset loaders (numpy host arrays).

``.mat`` files are read with scipy (MATLAB v5). MATLAB v7.3 files are HDF5
and need ``h5py``, which the port does not depend on: they raise with the
reason. Without a usable file the loaders fall back to the synthetic
generators; a fallback from an explicitly supplied path warns.
"""

from __future__ import annotations

import os
import warnings
from typing import Tuple

import numpy as np

from position_induced_transformer_torch.data import synthetic

_LFS_POINTER = b"version https://git-lfs"


def load_mat(path: str) -> dict:
    """Load a MATLAB v5 file into a dict of arrays."""
    from scipy.io import loadmat

    try:
        return loadmat(path)
    except (NotImplementedError, ValueError) as e:
        raise ValueError(
            f"{path}: not a MATLAB v5 file ({e}); MATLAB v7.3 / HDF5 files "
            "need h5py, which this package does not use — save with "
            "scipy.io.savemat or send .npy"
        ) from e


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
