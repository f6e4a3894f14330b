"""The port's host geometry builder (``data/native.py`` over its copy of
``native/geometry.cpp``; ``models/geometry.build_geometry_host``) against
the JAX package's ``build_geometry_host``, on the CPU.

Both compile the same C++ with the same flags on this machine, so every
distance and every threshold is equal to the bit on the meshes of the
fixed-mesh setups (burgers, sod, darcy at 11^2, 22^2, 43^2 and the 421^2
zero-shot grid, vorticity, cylinder), and every setup builds its geometry
with it. The library is built with g++ at first use, atomically, so that
processes building at once each load a whole file; without g++, or when
the build fails, the builder raises with the compiler's message.
"""

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from position_induced_transformer_torch import configs as t_configs
from position_induced_transformer_torch.data import native
from position_induced_transformer_torch.models import build_geometry_host as t_host
from position_induced_transformer_torch.train import benchmarks as t_bench
from position_induced_transformer_tpu import configs as j_configs
from position_induced_transformer_tpu.data import native as j_native
from position_induced_transformer_tpu.train import benchmarks as j_bench

REPO = Path(__file__).resolve().parents[1]
FIELDS = ("mesh_in", "dist_down", "dist_proc", "dist_up", "thr_down", "thr_up")


@pytest.fixture(scope="module", autouse=True)
def _jax_native_library():
    """The JAX package builds its native library with make at first use, and
    test processes started together can race on that build: wait until the
    library loads in this process."""
    for _ in range(60):
        if j_native.load() is not None:
            return
        j_native._lib = False  # not built yet: try again
        time.sleep(1)
    pytest.fail("the JAX package's native geometry library did not build")


def _assert_bit_equal(tg, jg):
    for name in FIELDS:
        got, want = getattr(tg, name), getattr(jg, name)
        assert (got is None) == (want is None), name
        if got is not None:
            assert got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    assert tg.thr_down.shape == (tg.dist_down.shape[0], 1)
    assert tg.thr_up.shape == (tg.dist_up.shape[0], 1)


@pytest.mark.parametrize("name", ["burgers", "sod", "vorticity", "cylinder"])
def test_setup_geometry_equals_jax_to_the_bit(name):
    """Each fixed-mesh setup's geometry against the JAX setup's, at the
    configuration's meshes (burgers 1024 -> 256, sod 1024 -> 256 on [-5,
    5), vorticity 64^2 -> 16^2 periodic, cylinder 4390 -> 896)."""
    tp = t_bench.setup(getattr(t_configs, name.upper()), ntrain=2, ntest=2, device="cpu")
    jp = getattr(j_bench, f"setup_{name}")(getattr(j_configs, name.upper()), ntrain=2, ntest=2)
    _assert_bit_equal(tp.geom, jp.geom)


@pytest.mark.parametrize("s", [11, 22, 43, 421])
def test_darcy_geometry_equals_jax_to_the_bit(s):
    """``darcy_geometry`` (training at 43^2, the CPU tests' 11^2 and 22^2,
    the 421^2 zero-shot grid: 177,241 points to the 16^2 latent grid)."""
    _assert_bit_equal(t_bench.darcy_geometry(t_configs.DARCY, s, device="cpu"),
                      j_bench.darcy_geometry(j_configs.DARCY, s))


@pytest.mark.parametrize("metric", ["euclidean", "periodic1d", "periodic2d"])
@pytest.mark.parametrize("locality", [0.0, 0.05, 0.5, 1.0])
def test_geometry_host_equals_jax_native(metric, locality):
    """The bindings against the JAX package's at every metric, at the ends
    of the locality range and between; the inferred torus period too."""
    rng = np.random.default_rng(7)
    if metric == "euclidean":
        mi, mo = rng.random((50, 3)).astype(np.float32), rng.random((20, 3)).astype(np.float32)
    elif metric == "periodic1d":
        mi = np.linspace(-5, 5, 41)[:-1].reshape(-1, 1).astype(np.float32)
        mo = mi[::3]
    else:
        xs = np.linspace(0, 1, 9)[:-1]
        mi = np.stack(np.meshgrid(xs, xs), -1).reshape(-1, 2).astype(np.float32)
        mo = mi[::5]
    got, want = native.geometry_host(mo, mi, metric, locality), j_native.geometry_host(
        mo, mi, metric, locality)
    assert native._period_for(mi, metric) == j_native._period_for(mi, metric)
    np.testing.assert_array_equal(got[0], want[0])
    if locality >= 1.0:
        assert got[1] is None and want[1] is None
    else:
        np.testing.assert_array_equal(got[1], want[1])


def test_build_geometry_host_takes_tensors_and_refuses_other_meshes():
    import torch

    m = np.linspace(0, 1, 33)[:-1].reshape(-1, 1).astype(np.float32)
    a = t_host(m, m[::4], m, metric="periodic1d", device="cpu")
    b = t_host(torch.from_numpy(m), torch.from_numpy(m[::4]), torch.from_numpy(m),
               metric="periodic1d", device="cpu")
    for name in FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name))
    assert t_host(m, m[::4], m, en_loc=1.0, de_loc=1.0, device="cpu").thr_down is None
    with pytest.raises(ValueError, match="fixed"):
        t_host(m[None], m[None], m[None], device="cpu")
    with pytest.raises(ValueError, match="unknown metric"):
        t_host(m, m, m, metric="torus", device="cpu")


_CHILD = """
import sys
from pathlib import Path
sys.path.insert(0, sys.argv[1])
import numpy as np
from position_induced_transformer_torch.data import native
native.BUILD_DIR = Path(sys.argv[2])
mesh = np.random.default_rng(0).random((300, 2)).astype(np.float32)
dist, thr = native.geometry_host(mesh, mesh, "euclidean", 0.02)
print(float(dist.sum()), float(thr.sum()))
"""


def test_concurrent_first_build_in_two_processes(tmp_path):
    """Two processes build the library into one empty directory at once:
    both load a whole file and give the same geometry, one library is
    left and no partial file."""
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, str(REPO), str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert outs[0][0] == outs[1][0] and outs[0][0].strip()
    assert [f.name for f in tmp_path.iterdir()] == [native.library_path("g++").name]


def test_no_quiet_fallback(tmp_path, monkeypatch):
    """Without g++, or with a source g++ refuses, the builder raises with
    the reason; it never falls back to another builder."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="needs g\\+\\+"):
        native.geometry_host(np.zeros((4, 1), np.float32), np.zeros((4, 1), np.float32))
    monkeypatch.undo()
    bad = tmp_path / "geometry.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ build of the host geometry builder failed"):
        native.load()
    assert not any((tmp_path / "build").iterdir())
