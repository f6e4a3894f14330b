"""ctypes bindings for the host geometry builder (``native/geometry.cpp``).

:func:`load` compiles the source with g++ at first use, with the JAX
package's flags, into ``build/native/libpitgeom-<hash>.so`` at the
repository root (a directory that ``.gitignore`` lists). The hash covers
the source, the command and the target g++ resolves ``-march=native`` to,
so a library built for another CPU is never loaded. Several processes may
build at once: each compiles to a name of its own and moves the file into
place atomically, so every process loads a whole library. There is no
fallback: without g++, or when the build fails, :func:`load` raises with
the compiler's message (another builder would round the thresholds in
another order and change kept sets).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "geometry.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-pthread")
_METRIC_IDS = {"euclidean": 0, "periodic1d": 1, "periodic2d": 2}

_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None


def _compiler() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(
            "the host geometry builder needs g++ on PATH to compile "
            f"{SOURCE.name}; none was found"
        )
    return cxx


def _run(cmd, what: str) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{what} failed (exit {proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    return proc.stdout


def library_path(cxx: str) -> Path:
    """Where the library for this source, command and CPU target lives."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXXFLAGS).encode())
    digest.update(_run([cxx, "-march=native", "-Q", "--help=target"], "g++ target query").encode())
    return BUILD_DIR / f"libpitgeom-{digest.hexdigest()[:16]}.so"


def _build(cxx: str, out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        _run([cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)], "g++ build of the host geometry builder")
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    os.replace(tmp, out)  # atomic: a concurrent builder loads either copy


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises when it cannot be."""
    global _lib
    with _lock:
        if _lib is None:
            cxx = _compiler()
            out = library_path(cxx)
            if not out.exists():
                _build(cxx, out)
            lib = ctypes.CDLL(str(out))
            f32p = ctypes.POINTER(ctypes.c_float)
            lib.pit_geometry.argtypes = [
                f32p, f32p, f32p, f32p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ]
            lib.pit_geometry.restype = None
            _lib = lib
        return _lib


def _f32(x) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.float32)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _period_for(mesh_in: np.ndarray, metric: str) -> float:
    """The torus period, inferred as ``ops/distances.py`` infers it:
    periodic1d from the spacing of the first two points times their
    number, periodic2d from the first axis's extent over ``sqrt(L) - 1``
    steps times ``sqrt(L)``; 0 for the Euclidean metric."""
    if metric == "periodic1d":
        dx = abs(float(mesh_in[1, 0]) - float(mesh_in[0, 0]))
        return dx * mesh_in.shape[0]
    if metric == "periodic2d":
        res = int(round(mesh_in.shape[0] ** 0.5))
        dx = (float(mesh_in[:, 0].max()) - float(mesh_in[:, 0].min())) / (res - 1)
        return dx * res
    return 0.0


def geometry_host(mesh_out, mesh_in, metric: str = "euclidean", locality: float = 1.0):
    """``(dist (L_out, L_in), thr (L_out, 1))`` float32 numpy arrays from
    the host builder, for fixed (L, d) meshes; ``thr`` is None unless ``0
    <= locality < 1``."""
    if metric not in _METRIC_IDS:
        raise ValueError(f"unknown metric {metric!r}; expected one of {sorted(_METRIC_IDS)}")
    a, b = _f32(mesh_out), _f32(mesh_in)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(
            f"geometry_host takes fixed (L, d) meshes of one d, got {a.shape} and {b.shape}"
        )
    lib = load()
    la, lb = a.shape[0], b.shape[0]
    dist = np.empty((la, lb), np.float32)
    masked = 0.0 <= locality < 1.0
    thr = np.empty((la, 1), np.float32) if masked else None
    lib.pit_geometry(
        _ptr(a), _ptr(b), _ptr(dist),
        _ptr(thr) if masked else _ptr(dist),  # not written without a threshold
        la, lb, a.shape[1], _METRIC_IDS[metric],
        _period_for(b, metric), locality if masked else 2.0,
    )
    return dist, thr
