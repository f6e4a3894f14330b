"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exports plain C functions and is compiled on its
own into ``build/kernels/lib<name>-<hash>.so`` at the repository root (a
directory that ``.gitignore`` lists). The hash covers the source and the
command, so an edited source never loads a stale library. Nothing is built
when this module is imported: :func:`load` builds at first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = ("posatt_fixed_fwd",)

# no --use_fast_math: expf and the divisions must round as the f32 oracle's
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def nvcc_command(src: Path, out: Path) -> List[str]:
    return [nvcc_path(), *_NVCC_FLAGS, "-o", str(out), str(src)]


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(_NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _build(name: str, out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run(
        nvcc_command(CSRC / f"{name}.cu", tmp),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} (exit {res.returncode}):\n{res.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent builder loads either copy


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            out = library_path(name)
            if not out.exists():
                _build(name, out)
            lib = ctypes.CDLL(str(out))
            _loaded[name] = lib
        return lib
