"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exports plain C functions and is compiled on its
own into ``build/kernels/lib<name>-<hash>.so`` at the repository root (a
directory that ``.gitignore`` lists). The hash covers the source, the
headers of ``csrc/`` and the command, so an edited source never loads a
stale library. Nothing is built when this module is imported: :func:`load`
builds one library at first use, :func:`build_all` starts one ``nvcc`` per
missing library, all at once.
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
KERNELS = (
    "posatt_fixed_fwd", "posatt_fixed_bwd", "posatt_batched_fwd", "posatt_batched_bwd",
    "posatt_tf_fwd", "posatt_tf_bwd", "posatt_tf_fixed_fwd", "posatt_tf_fixed_bwd",
)

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
    for header in sorted(CSRC.glob("*.cuh")):  # what a source may include
        digest.update(header.read_bytes())
    digest.update(" ".join(_NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _build(names) -> None:
    """Compile the named sources concurrently; raises with every failure's
    output once all have finished. Call with ``_lock`` held."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            nvcc_command(CSRC / f"{name}.cu", tmp),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        jobs.append((name, out, tmp, proc))
    errors = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed for {name} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent builder loads either copy
    if errors:
        raise RuntimeError("\n".join(errors))


def build_all() -> None:
    """Build every missing kernel library, one nvcc each, in parallel."""
    with _lock:
        _build([n for n in KERNELS if not library_path(n).exists()])


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            out = library_path(name)
            if not out.exists():
                _build([name])
            lib = ctypes.CDLL(str(out))
            _loaded[name] = lib
        return lib
