"""Quantile-based locality masking for position attention.

The bandwidth scale is non-negative and the quantile commutes with a
non-negative scalar, so the keep mask ``d <= quantile(d)`` does not depend
on the learnable bandwidth or the head: it is computed once per mesh pair.

On regular periodic grids a row's cut can fall inside a tie of two equal
distances (the left and right neighbours). Whether the tie is kept then
depends on the distances being bit-identical, which is why
``ops/distances.py`` keeps the JAX package's op order.

Per-sample meshes (elasticity) are constant across training, so their
per-row thresholds and kept-column bands are data: computed once at setup
(:func:`batched_topk_thresholds`, :func:`batched_band_starts`) and gathered
with each batch.
"""

from __future__ import annotations

import numpy as np
import torch

from position_induced_transformer_torch.ops.distances import pairwise_sq_dist


def quantile_threshold(dist: torch.Tensor, locality: float) -> torch.Tensor:
    """Per-row linear-interpolation quantile along the last axis, keepdim.

    ``torch.quantile`` refuses inputs of more than 2**24 elements.
    """
    return torch.quantile(
        dist, locality, dim=-1, keepdim=True, interpolation="linear"
    )


def keep_mask(dist: torch.Tensor, locality: float) -> torch.Tensor:
    """Boolean mask of entries at or below the per-row locality quantile."""
    return dist <= quantile_threshold(dist, locality)


def topk_keep_count(L_in: int, locality: float) -> int:
    """Entries a per-row quantile mask keeps, absent ties: the quantile
    falls in ``[d_(k), d_(k+1))`` with ``k = floor(locality * (L-1))``
    (0-indexed), so ``k + 1`` entries."""
    if locality >= 1.0:
        return L_in
    return int(locality * (L_in - 1)) + 1


def topk_threshold(dist: torch.Tensor, locality: float) -> torch.Tensor:
    """The c-th smallest distance per row, ``c = topk_keep_count``: the
    quantile's kept set where the cut falls in no tie.

    For ``c <= 32`` it is found with c - 1 masked-min passes, which under
    exact ties yield the c-th smallest *distinct* value, as the batched
    kernel's in-kernel keep mask does; above that, the c-th order statistic.
    """
    c = topk_keep_count(dist.shape[-1], locality)
    if c >= dist.shape[-1]:
        return dist.amax(dim=-1, keepdim=True)
    if c <= 32:
        inf = torch.tensor(float("inf"), dtype=dist.dtype, device=dist.device)
        thr = dist.amin(dim=-1, keepdim=True)
        for _ in range(c - 1):
            thr = torch.where(dist > thr, dist, inf).amin(dim=-1, keepdim=True)
        return thr
    return torch.topk(dist, c, dim=-1, largest=False, sorted=True).values[..., -1:]


def robust_topk_threshold(
    dist: torch.Tensor, locality: float, window: int = 4, rel_gap: float = 1e-5,
) -> torch.Tensor:
    """The nearest wide-gap midpoint to the nominal cut: a threshold whose
    kept set ``d <= thr`` no rounding of the distances can change.

    Over the ascending order statistics ``d_(i)`` the cut index is scanned
    in the order c, c+1, c-1, c+2, ... within ``window`` of the keep count
    c; the first gap ``d_(i+1) - d_(i) >= rel_gap * d_(i+1)`` wins and the
    threshold is its midpoint, so an exact tie group is kept or dropped
    whole. Without a wide gap in the window, the midpoint at c.
    """
    L = dist.shape[-1]
    c = topk_keep_count(L, locality)
    if c >= L:
        return dist.amax(dim=-1, keepdim=True)
    lo = max(c - window, 1)
    hi = min(c + window, L - 1)
    small = torch.topk(dist, hi + 1, dim=-1, largest=False, sorted=True).values
    d_i = small[..., lo - 1 : hi]  # d_(i),   i = lo..hi (1-indexed)
    d_n = small[..., lo : hi + 1]  # d_(i+1)
    wide = (d_n - d_i) >= rel_gap * d_n
    mid = 0.5 * (d_i + d_n)
    order = [c]
    for s in range(1, window + 1):
        if c + s <= hi:
            order.append(c + s)
        if c - s >= lo:
            order.append(c - s)
    thr = mid[..., c - lo : c - lo + 1]
    # lowest priority first, so that a preferred wide gap overwrites it
    for i in reversed(order):
        j = i - lo
        thr = torch.where(wide[..., j : j + 1], mid[..., j : j + 1], thr)
    return thr


def batched_topk_thresholds(
    mesh_q: torch.Tensor, mesh_k: torch.Tensor, locality: float,
    metric: str = "euclidean", chunk: int = 32,
):
    """Per-sample per-row :func:`robust_topk_threshold` (B, L_q, 1), in
    chunks of ``chunk`` samples (bounding the transient distances); None
    for a global locality."""
    if locality >= 1.0:
        return None
    outs = [
        robust_topk_threshold(
            pairwise_sq_dist(mesh_q[s : s + chunk], mesh_k[s : s + chunk], metric),
            locality,
        )
        for s in range(0, mesh_q.shape[0], chunk)
    ]
    return torch.cat(outs, dim=0)


def batched_band_starts(
    mesh_q: torch.Tensor,
    mesh_k: torch.Tensor,
    thr: torch.Tensor,
    tile_rows: int,
    metric: str = "euclidean",
    chunk: int = 16,
    min_saving: float = 0.75,
    width=None,
    circular: bool = False,
):
    """Kept-column bands for the batched kernels: ``(starts (B, n_tiles)
    int32, width)``, with ``circular`` ``(starts, width, wrap)``, or None.

    For every sample and every tile of ``tile_rows`` rows, all columns kept
    by ``dist <= thr`` lie in ``[start, start + width)``; starts are
    8-aligned. ``width`` (optional) is a floor on the width, so that two
    splits share one. None when the band would cover ``min_saving`` of the
    128-padded key axis or more.

    ``circular``: the key axis is a ring (a cloud ordered along a closed
    curve): the band is the least circular arc covering the kept columns,
    and a start may point into the wrap margin ``[L_k, L_k + width)`` that
    the caller appends to the keys (``BandSpec.wrap``, equal to the width).
    Returns None when the width would reach ``L_k``, where a window could
    see both copies of a key.
    """
    B, L_q = mesh_q.shape[0], mesh_q.shape[1]
    L_k = mesh_k.shape[1]
    n_tiles = -(-L_q // tile_rows)
    Lk_pad = -(-L_k // 128) * 128
    keeps = []
    for s in range(0, B, chunk):
        keep = pairwise_sq_dist(mesh_q[s : s + chunk], mesh_k[s : s + chunk], metric)
        keep = keep <= thr[s : s + chunk]
        # union over the rows of each tile, rows padded to n_tiles * tile_rows
        keep = torch.nn.functional.pad(keep, (0, 0, 0, n_tiles * tile_rows - L_q))
        keeps.append(keep.reshape(keep.shape[0], n_tiles, tile_rows, L_k).any(2).cpu())
    keep = torch.cat(keeps, dim=0).numpy()  # (B, n_tiles, L_k) bool
    cols = np.arange(L_k)
    if circular:
        # the least arc covering the kept columns is the complement of the
        # longest circular run of unkept ones
        lo = np.zeros(keep.shape[:2], np.int64)
        hi = np.zeros(keep.shape[:2], np.int64)
        for b in range(keep.shape[0]):
            for t in range(keep.shape[1]):
                idx = np.flatnonzero(keep[b, t])
                if idx.size == 0:
                    continue
                gaps = np.diff(idx) - 1
                wrap_gap = (idx[0] + L_k - idx[-1]) - 1
                g = int(np.argmax(gaps)) if gaps.size else -1
                if gaps.size and gaps[g] > wrap_gap:
                    # the arc starts after the largest interior gap and wraps
                    lo[b, t] = idx[g + 1]
                    hi[b, t] = idx[g] + 1 + L_k  # index on the extended axis
                else:
                    lo[b, t] = idx[0]
                    hi[b, t] = idx[-1] + 1
    else:
        big = np.where(keep, cols, L_k)
        lo = big.min(-1)
        hi = np.where(keep, cols + 1, 0).max(-1)
        empty = hi <= lo  # a tile that keeps nothing: an empty band at 0
        lo = np.where(empty, 0, lo)
        hi = np.where(empty, 0, hi)
    start = (lo // 8) * 8
    need = int(np.max(hi - start)) if (hi > start).any() else 0
    need = -(-max(need, 8) // 128) * 128
    width = max(need, width or 0)
    if width >= min_saving * Lk_pad or width >= L_k:
        return None
    if circular:
        ext_pad = -(-(L_k + width) // 128) * 128
        start = np.minimum(start, ext_pad - width)
        return torch.from_numpy(start.astype(np.int32)), width, width
    start = np.minimum(start, Lk_pad - width)
    return torch.from_numpy(start.astype(np.int32)), width
