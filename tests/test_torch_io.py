"""HDF5 and MATLAB v7.3 inputs: the port's readers against the JAX
package's on the same files, on the CPU, and the refusal, naming h5py,
when h5py is not installed.

The files are written here with h5py: a v7.3-style ``.mat`` (a 512-byte
MATLAB header before the HDF5 data, each variable stored column-major as
MATLAB stores it, MATLAB's ``#refs#`` group and a struct), a bare HDF5
``.mat`` (no MATLAB header) and plain ``.h5`` / ``.hdf5`` files in native
row-major layout. Reading is exact: the arrays are compared bit for bit.
"""

import contextlib
import sys

import h5py
import numpy as np
import pytest

from position_induced_transformer_torch.data import loaders as t_loaders
from position_induced_transformer_torch.train import evaluate as t_eval
from position_induced_transformer_torch.train import serve as t_serve
from position_induced_transformer_tpu.data import loaders as j_loaders
from position_induced_transformer_tpu.train import evaluate as j_eval
from position_induced_transformer_tpu.train import serve as j_serve

_HEADER = (
    b"MATLAB 7.3 MAT-file, Platform: GLNXA64, Created on: Thu Jan  1 00:00:00 2026 "
    b"HDF5 schema 1.00 ."
).ljust(116, b" ") + b"\0" * 8 + b"\x00\x02IM"  # subsystem offset, version 0x0200


def write_v73(path, arrays, header=True):
    """A MATLAB v7.3-style file: each variable stored transposed (MATLAB is
    column-major), MATLAB's ``#refs#`` group and a struct ``params``; with
    ``header`` the 512-byte user block starts with MATLAB's header text."""
    with h5py.File(path, "w", userblock_size=512 if header else 0) as f:
        for k, v in arrays.items():
            f[k] = np.asarray(v).T
        f.create_group("#refs#")
        f.create_group("params")["a"] = np.ones(2)
    if header:
        with open(path, "r+b") as f:
            f.write(_HEADER)


def write_h5(path, arrays):
    with h5py.File(path, "w") as f:
        for k, v in arrays.items():
            f[k] = v


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((3, 5, 2)).astype(np.float32),
            "mesh": rng.random((3, 5, 2)), "n": np.arange(4, dtype=np.int32)}


@pytest.mark.parametrize("header", [True, False], ids=["v7.3", "bare-hdf5"])
def test_load_mat_reads_hdf5_as_the_jax_package_does(tmp_path, header):
    arrays = _arrays()
    path = str(tmp_path / "in.mat")
    write_v73(path, arrays, header=header)
    with pytest.warns(UserWarning, match="params"):
        got = t_loaders.load_mat(path)
    with pytest.warns(UserWarning, match="params"):
        want = j_loaders.load_mat(path)
    assert set(got) == set(want) == set(arrays)
    for k, v in arrays.items():
        assert got[k].dtype == want[k].dtype == v.dtype
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], v)  # back in MATLAB orientation


@pytest.mark.parametrize("suffix", [".h5", ".hdf5", ".mat"])
def test_load_input_matches_the_jax_package(tmp_path, suffix):
    """``.h5``/``.hdf5`` in native layout, a v7.3 ``.mat`` transposed back:
    the input and the whole table as the JAX package returns them."""
    arrays = _arrays(1)
    path = str(tmp_path / f"in{suffix}")
    if suffix == ".mat":
        write_v73(path, arrays)
    else:
        write_h5(path, arrays)
    # the v7.3 file's struct is skipped with a warning
    skipped = lambda: (pytest.warns(UserWarning, match="params") if suffix == ".mat"
                       else contextlib.nullcontext())
    with skipped():
        x, table = t_eval._load_input(path, "x")
    with skipped():
        jx, jtable = j_eval._load_input(path, "x")
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(x, arrays["x"])
    assert set(table) == set(jtable) == set(arrays)
    for k in arrays:
        np.testing.assert_array_equal(table[k], jtable[k])
    with skipped(), pytest.raises(KeyError, match="available"):
        t_eval._load_input(path, "u")


def test_server_sniffs_bodies_as_the_jax_server_does(tmp_path):
    from scipy.io import savemat

    arrays = {"x": np.ones((2, 3), np.float32)}
    paths = {"npy": tmp_path / "a.npy", "v5": tmp_path / "a.mat", "v73": tmp_path / "b.mat",
             "h5": tmp_path / "a.h5"}
    np.save(paths["npy"], arrays["x"])
    savemat(paths["v5"], arrays)
    write_v73(paths["v73"], arrays)
    write_h5(paths["h5"], arrays)
    want = {"npy": ".npy", "v5": ".mat", "v73": ".mat", "h5": ".h5"}
    for name, path in paths.items():
        body = path.read_bytes()
        assert t_serve._sniff_suffix(body) == j_serve._sniff_suffix(body) == want[name], name
    with pytest.raises(ValueError, match="HDF5"):
        t_serve._sniff_suffix(b"not an array")


def test_without_h5py_hdf5_inputs_raise_naming_it(tmp_path, monkeypatch):
    """h5py is imported only when an HDF5 file is read; without it the
    three readers raise ``ValueError`` naming it, and the other formats
    still load."""
    arrays = _arrays(2)
    write_v73(str(tmp_path / "in.mat"), arrays)
    write_h5(str(tmp_path / "in.h5"), arrays)
    np.save(tmp_path / "in.npy", arrays["x"])
    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py -> ImportError
    with pytest.raises(ValueError, match="h5py"):
        t_loaders.load_mat(str(tmp_path / "in.mat"))
    for name in ("in.mat", "in.h5"):
        with pytest.raises(ValueError, match="h5py"):
            t_eval._load_input(str(tmp_path / name))
    x, table = t_eval._load_input(str(tmp_path / "in.npy"))
    np.testing.assert_array_equal(x, arrays["x"])
    assert table is None


def test_unreadable_hdf5_raises_naming_h5py(tmp_path):
    path = tmp_path / "bad.h5"
    path.write_bytes(b"\x89HDF\r\n\x1a\n" + b"\0" * 64)
    with pytest.raises(ValueError, match="h5py"):
        t_eval._load_input(str(path))
