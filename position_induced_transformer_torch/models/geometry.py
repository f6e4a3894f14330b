"""Mesh geometry: precomputed distances and locality thresholds.

For a fixed mesh triple (input, latent, output) the three distance matrices
(encoder cross, processor self, decoder cross) and the bandwidth-independent
per-row locality thresholds (see ``ops/locality.py``) are computed once, on
the device the model runs on, and reused by every forward.

Per-sample meshes (elasticity) give each sample its own cloud: a lazy
Geometry carries the coordinates only, and the batched attention kernels
compute the distances themselves, per batch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from position_induced_transformer_torch.ops.distances import pairwise_sq_dist
from position_induced_transformer_torch.ops.locality import quantile_threshold
from position_induced_transformer_torch.utils.devices import resolve_device


@dataclasses.dataclass
class Geometry:
    """Distances and thresholds binding a PiT model to a mesh triple.

    ``dist_down`` (L_ltt, L_in), ``dist_proc`` (L_ltt, L_ltt) and
    ``dist_up`` (L_out, L_ltt) are squared distances; ``thr_down`` and
    ``thr_up`` are per-row thresholds (L_rows, 1), None where the locality
    is global. ``mesh_in`` feeds the encoder's mesh concat.

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


def build_geometry(
    mesh_in,
    mesh_ltt,
    mesh_out,
    *,
    metric: str = "euclidean",
    en_loc: float = 0.02,
    de_loc: float = 0.02,
    device="cuda",
    lazy: bool = False,
) -> Geometry:
    """Build a :class:`Geometry` for fixed (L, d) meshes on ``device``.

    Meshes may be numpy arrays or tensors; they are moved to ``device`` as
    float32 and every distance and threshold is computed there.
    ``lazy=True`` takes per-sample (B, L, d) meshes and stores their
    coordinates only (Euclidean metric only).
    """
    dev = resolve_device(device)
    as_dev = lambda m: torch.as_tensor(m, dtype=torch.float32).to(dev)
    mesh_in, mesh_ltt, mesh_out = as_dev(mesh_in), as_dev(mesh_ltt), as_dev(mesh_out)
    if lazy:
        if metric != "euclidean":
            raise ValueError("lazy geometry supports the euclidean metric only")
        for name, m in (("mesh_in", mesh_in), ("mesh_ltt", mesh_ltt), ("mesh_out", mesh_out)):
            if m.ndim != 3:
                raise ValueError(
                    f"lazy geometry takes per-sample (B, L, d) meshes; {name} "
                    f"has shape {tuple(m.shape)}"
                )
        return Geometry(
            mesh_in=mesh_in, dist_down=None, dist_proc=None, dist_up=None,
            mesh_ltt=mesh_ltt, mesh_out=mesh_out,
        )
    for name, m in (("mesh_in", mesh_in), ("mesh_ltt", mesh_ltt), ("mesh_out", mesh_out)):
        if m.ndim != 2:
            raise ValueError(
                f"{name} must be a fixed (L, d) mesh, got shape {tuple(m.shape)}; "
                "per-sample (B, L, d) meshes take lazy=True"
            )
    dist_down = pairwise_sq_dist(mesh_ltt, mesh_in, metric)
    dist_proc = pairwise_sq_dist(mesh_ltt, mesh_ltt, metric)
    dist_up = pairwise_sq_dist(mesh_out, mesh_ltt, metric)
    thr_down = quantile_threshold(dist_down, en_loc) if en_loc < 1.0 else None
    thr_up = quantile_threshold(dist_up, de_loc) if de_loc < 1.0 else None
    return Geometry(
        mesh_in=mesh_in,
        dist_down=dist_down,
        dist_proc=dist_proc,
        dist_up=dist_up,
        thr_down=thr_down,
        thr_up=thr_up,
    )
