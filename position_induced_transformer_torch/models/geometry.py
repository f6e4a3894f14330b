"""Mesh geometry: precomputed distances and locality thresholds.

For a fixed mesh triple (input, latent, output) the three distance matrices
(encoder cross, processor self, decoder cross) and the bandwidth-independent
per-row locality thresholds (see ``ops/locality.py``) are computed once and
reused by every forward: by :func:`build_geometry_host` on the host (the
builder the fixed-mesh setups take, as the JAX package's do) and uploaded
once, or by :func:`build_geometry` on the device the model runs on.

Per-sample meshes (elasticity) give each sample its own cloud: a lazy
Geometry carries the coordinates only, and the batched attention kernels
compute the distances themselves, per batch; a batched non-lazy Geometry
carries the (B, L_out, L_in) distances, which kernels #9/#10 read.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from position_induced_transformer_torch.ops.distances import pairwise_sq_dist
from position_induced_transformer_torch.ops.locality import (
    quantile_threshold,
    topk_threshold,
)
from position_induced_transformer_torch.utils.devices import resolve_device


@dataclasses.dataclass
class Geometry:
    """Distances and thresholds binding a PiT model to a mesh triple.

    ``dist_down`` (L_ltt, L_in), ``dist_proc`` (L_ltt, L_ltt) and
    ``dist_up`` (L_out, L_ltt) are squared distances; ``thr_down`` and
    ``thr_up`` are per-row thresholds (L_rows, 1), None where the locality
    is global or where the attention op takes the quantile itself in every
    call. ``mesh_in`` feeds the encoder's mesh concat. Batched non-lazy
    geometry (per-sample (B, L, d) meshes) gives each of these a leading
    batch axis.

    Lazy per-sample geometry: the ``dist_*`` are None and ``mesh_in``,
    ``mesh_ltt``, ``mesh_out`` carry (B, L, d) coordinates; ``thr_*`` are
    then (B, L_rows, 1) when precomputed, and ``band_down`` / ``band_up``
    optional ``kernels.BandSpec`` kept-column bands.
    """

    mesh_in: torch.Tensor
    dist_down: Optional[torch.Tensor]
    dist_proc: Optional[torch.Tensor]
    dist_up: Optional[torch.Tensor]
    thr_down: Optional[torch.Tensor] = None
    thr_up: Optional[torch.Tensor] = None
    mesh_ltt: Optional[torch.Tensor] = None
    mesh_out: Optional[torch.Tensor] = None
    band_down: Optional[Any] = None
    band_up: Optional[Any] = None


_THRESHOLDS = {"quantile": quantile_threshold, "topk": topk_threshold}


def build_geometry(
    mesh_in,
    mesh_ltt,
    mesh_out,
    *,
    metric: str = "euclidean",
    en_loc: float = 0.02,
    de_loc: float = 0.02,
    precompute_masks: bool = True,
    threshold_impl: str = "quantile",
    device="cuda",
    lazy: bool = False,
) -> Geometry:
    """Build a :class:`Geometry` for fixed (L, d) or batched (B, L, d)
    meshes on ``device``.

    Meshes may be numpy arrays or tensors; they are moved to ``device`` as
    float32 and every distance and threshold is computed there. Batched
    meshes (Euclidean only) give (B, L_out, L_in) distances and (B, L_out,
    1) thresholds. ``precompute_masks=False`` leaves ``thr_*`` None: the
    attention op then takes the row quantile in every call.
    ``threshold_impl``: ``"quantile"`` (the exact linear-interpolation
    quantile) or ``"topk"`` (the keep count's smallest distance, the same
    kept set where the cut falls in no tie; ``ops.locality.topk_threshold``).
    ``lazy=True`` takes per-sample (B, L, d) meshes and stores their
    coordinates only (Euclidean metric only).
    """
    if threshold_impl not in _THRESHOLDS:
        raise ValueError(
            f"unknown threshold_impl {threshold_impl!r}; expected one of {sorted(_THRESHOLDS)}"
        )
    dev = resolve_device(device)
    as_dev = lambda m: torch.as_tensor(m, dtype=torch.float32).to(dev)
    mesh_in, mesh_ltt, mesh_out = as_dev(mesh_in), as_dev(mesh_ltt), as_dev(mesh_out)
    meshes = (("mesh_in", mesh_in), ("mesh_ltt", mesh_ltt), ("mesh_out", mesh_out))
    if lazy:
        if metric != "euclidean":
            raise ValueError("lazy geometry supports the euclidean metric only")
        for name, m in meshes:
            if m.ndim != 3:
                raise ValueError(
                    f"lazy geometry takes per-sample (B, L, d) meshes; {name} "
                    f"has shape {tuple(m.shape)}"
                )
        return Geometry(
            mesh_in=mesh_in, dist_down=None, dist_proc=None, dist_up=None,
            mesh_ltt=mesh_ltt, mesh_out=mesh_out,
        )
    ndim = mesh_in.ndim
    for name, m in meshes:
        if m.ndim not in (2, 3) or m.ndim != ndim:
            raise ValueError(
                f"{name} must be a fixed (L, d) or per-sample (B, L, d) mesh like "
                f"mesh_in {tuple(mesh_in.shape)}, got shape {tuple(m.shape)}"
            )
    if ndim == 3:
        if metric != "euclidean":
            raise ValueError("per-sample (B, L, d) meshes take the euclidean metric only")
        if len({m.shape[0] for _, m in meshes}) != 1:
            raise ValueError(
                "per-sample meshes must share one batch size, got "
                f"{[tuple(m.shape) for _, m in meshes]}"
            )
    dist_down = pairwise_sq_dist(mesh_ltt, mesh_in, metric)
    dist_proc = pairwise_sq_dist(mesh_ltt, mesh_ltt, metric)
    dist_up = pairwise_sq_dist(mesh_out, mesh_ltt, metric)
    thr_down = thr_up = None
    if precompute_masks:
        thr_fn = _THRESHOLDS[threshold_impl]
        thr_down = thr_fn(dist_down, en_loc) if en_loc < 1.0 else None
        thr_up = thr_fn(dist_up, de_loc) if de_loc < 1.0 else None
    return Geometry(
        mesh_in=mesh_in,
        dist_down=dist_down,
        dist_proc=dist_proc,
        dist_up=dist_up,
        thr_down=thr_down,
        thr_up=thr_up,
    )


def _host_mesh(m) -> np.ndarray:
    if isinstance(m, torch.Tensor):
        m = m.detach().cpu()
    return np.ascontiguousarray(np.asarray(m, dtype=np.float32))


def build_geometry_host(
    mesh_in,
    mesh_ltt,
    mesh_out,
    *,
    metric: str = "euclidean",
    en_loc: float = 0.02,
    de_loc: float = 0.02,
    device="cuda",
) -> Geometry:
    """Fixed-mesh geometry from the host builder (``data/native.py``, the
    multithreaded C++ of ``native/geometry.cpp``): the three distance
    matrices and the nth_element quantile thresholds on the host, then one
    upload of each to ``device``. Its kept sets equal the JAX package's
    ``build_geometry_host`` to the bit. Meshes are (L, d) numpy arrays or
    tensors; raises when the builder cannot be built (no fallback)."""
    from position_induced_transformer_torch.data import native

    dev = resolve_device(device)
    mi, ml, mo = (_host_mesh(m) for m in (mesh_in, mesh_ltt, mesh_out))
    requests = ((ml, mi, en_loc), (ml, ml, 1.0), (mo, ml, de_loc))  # the processor is global
    (dist_down, thr_down), (dist_proc, _), (dist_up, thr_up) = (
        native.geometry_host(q, k, metric, loc) for q, k, loc in requests
    )
    up = lambda a: None if a is None else torch.from_numpy(a).to(dev)
    return Geometry(
        mesh_in=up(mi.copy()),  # not the caller's array
        dist_down=up(dist_down),
        dist_proc=up(dist_proc),
        dist_up=up(dist_up),
        thr_down=up(thr_down),
        thr_up=up(thr_up),
    )
