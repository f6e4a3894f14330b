"""Per-sample-mesh position attention: the CUDA kernels' wrappers, their
plain versions, and the autograd Function around them.

Counterpart of the JAX package's ``kernels/posatt_batched.py`` (the module
keeps that name). Per-sample point clouds (elasticity) give every sample
its own distances, so the kernels take raw coordinates and compute the
distances themselves; the (B, L_out, L_in) distance and attention tensors
never reach device memory. Two hand-written sm_90a sources, each the port
of one TPU kernel:

- ``csrc/posatt_batched_fwd.cu``: the forward ``_make_fwd_kernel``; it
  also writes the row statistics the backward needs when asked;
- ``csrc/posatt_batched_bwd.cu``: the backward ``_make_bwd_kernel``, as two
  entry points, the per-sample bandwidth gradient (dscale) and the value
  gradient (du).

For sample b and output row i the function is, over the row's column
window W_i (the whole key axis, or with a band ``[start, start + width)``
of the extended key axis, ``start = starts[b, i // band_tile_rows(L_out)]``):

- ``d_ij`` the squared distance, diff -> square -> sum over coordinates;
- ``keep_ij``: ``d_ij <= thr[b, i]``; without ``thr``, ``d_ij`` at or below
  the ``keep_count``-th smallest distinct value of the row; every column
  when ``keep_count >= L_in``;
- ``dmin_i`` the bare minimum of ``d`` over W_i;
- ``p_hij = exp(-s_h (d_ij - dmin_i))`` on kept entries, else 0;
- ``out[b, i, h*D:(h+1)*D] = sum_j p_hij u_bj / max(sum_j p_hij, 1e-30)``.

Dispatch is by device: a CUDA tensor launches the kernel or raises, a CPU
tensor takes the plain version (``*_reference``). There is no fallback and
no switch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from position_induced_transformer_torch.kernels.posatt_pallas import (
    CUDA_HEADS,
    _check_tensors,
    _entry,
    _launch,
)
from position_induced_transformer_torch.ops.distances import euclidean_sq
from position_induced_transformer_torch.ops.locality import (
    robust_topk_threshold,
    topk_keep_count,
)
from position_induced_transformer_torch.ops.posatt import bandwidth_scale

MAX_SPACE_DIM = 4  # coordinates per point the kernels take
_TLO = 16  # the kernels' row tile; divides every band tile height


def band_tile_rows(L_out: int) -> int:
    """The height of the output-row tiles that own one band start each:
    ``min(round_up(L_out, 8), 256)``. Setup-time band computations tile
    with it."""
    return min(-(-L_out // 8) * 8, 256)


@dataclasses.dataclass
class BandSpec:
    """Kept-column band: per (sample, row tile) 8-aligned ``starts``
    (B, n_tiles) int32 and a common ``width``. ``wrap``: the circular
    margin; the first ``wrap`` keys and values are appended to the key
    axis, so that a window crossing the seam is a plain range of the
    extended axis (``width < L_k``, so no window sees a key twice)."""

    starts: torch.Tensor
    width: int
    wrap: int = 0


# ------------------------------------------------------------ plain versions


def _window(starts, width, L_out, L_in, device):
    """(B, L_out, L_in) bool: the columns of each row's band window; None
    without a band."""
    if starts is None:
        return None
    tile = torch.arange(L_out, device=device) // band_tile_rows(L_out)
    s = starts.long()[:, tile, None]  # (B, L_out, 1)
    j = torch.arange(L_in, device=device)
    return (j >= s) & (j < s + width)


def _rows(mesh_q, mesh_k, thr, starts, keep_count, width):
    """Distances (B, L_out, L_in), the keep mask, and per row the bare
    window minimum and the keep threshold (B, L_out, 1)."""
    dist = euclidean_sq(mesh_q, mesh_k)
    L_out, L_in = dist.shape[1:]
    inf = torch.tensor(float("inf"), device=dist.device)
    win = _window(starts, width, L_out, L_in, dist.device)
    dw = dist if win is None else torch.where(win, dist, inf)
    dmin = dw.amin(dim=-1, keepdim=True)
    if thr is not None:
        t = thr
    elif keep_count >= L_in:
        t = torch.full_like(dmin, float("inf"))
    else:  # the keep_count-th smallest distinct value
        t = dmin
        for _ in range(keep_count - 1):
            t = torch.where(dw > t, dw, inf).amin(dim=-1, keepdim=True)
    keep = dist <= t
    if win is not None:
        keep = keep & win
    return dist, keep, dmin, t


def _exp_weights(dist, keep, dmin, scale):
    """Unnormalised weights (B, H, L_out, L_in), exactly 0 where not kept."""
    s = scale.reshape(1, -1, 1, 1)
    return torch.where(keep[:, None], torch.exp(-(dist - dmin)[:, None] * s), 0.0)


def posatt_batched_reference(
    mesh_q, mesh_k, scale, u, thr=None, starts=None, *, keep_count, width=0
):
    """Plain PyTorch version of the forward kernel: (B, L_out, H*D).

    ``mesh_q`` (B, L_out, d), ``mesh_k`` (B, L_in, d) and ``u`` (B, L_in,
    D) on the extended key axis, ``scale`` (H, 1), ``thr`` (B, L_out, 1),
    ``starts`` (B, n_tiles) int32 with ``width``.
    """
    dist, keep, dmin, _ = _rows(mesh_q, mesh_k, thr, starts, keep_count, width)
    p = _exp_weights(dist, keep, dmin, scale)
    att = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhij,bjd->bihd", att, u)
    return out.reshape(out.shape[0], out.shape[1], -1)


def posatt_batched_stats_reference(
    mesh_q, mesh_k, scale, thr=None, starts=None, *, keep_count, width=0
):
    """Plain version of the row statistics the forward kernel writes for
    the backward: (B, H + 2, L_out), holding per row the bare window
    minimum, the keep threshold (+inf where every column is kept), and per
    head the reciprocal softmax denominator ``1 / max(sum_j p, 1e-30)``."""
    dist, keep, dmin, t = _rows(mesh_q, mesh_k, thr, starts, keep_count, width)
    den = _exp_weights(dist, keep, dmin, scale).sum(dim=-1)  # (B, H, L_out)
    rden = 1.0 / den.clamp_min(1e-30)
    return torch.cat([dmin.transpose(1, 2), t.transpose(1, 2), rden], dim=1)


def _weights_from_stats(mesh_q, mesh_k, scale, stats, starts, width):
    """Attention weights (B, H, L_out, L_in) recomputed from the forward's
    row statistics, the keep mask and the distances."""
    dist = euclidean_sq(mesh_q, mesh_k)
    L_out, L_in = dist.shape[1:]
    dmin, t = stats[:, 0, :, None], stats[:, 1, :, None]
    keep = dist <= t
    win = _window(starts, width, L_out, L_in, dist.device)
    if win is not None:
        keep = keep & win
    att = _exp_weights(dist, keep, dmin, scale) * stats[:, 2:, :, None]
    return att, keep, dist


def posatt_batched_bwd_du_reference(mesh_q, mesh_k, scale, g, stats, starts=None, *, width=0):
    """Plain version of the du kernel: sum_h P_h^T G_h, (B, L_in, D) on the
    extended key axis. ``g`` (B, L_out, H*D) is the output's cotangent."""
    att, _, _ = _weights_from_stats(mesh_q, mesh_k, scale, stats, starts, width)
    B, L_out, HD = g.shape
    H = scale.shape[0]
    return torch.einsum("bhij,bihd->bjd", att, g.reshape(B, L_out, H, HD // H))


def posatt_batched_bwd_dscale_reference(
    mesh_q, mesh_k, scale, u, g, stats, starts=None, *, width=0
):
    """Plain version of the dscale kernel: d(loss)/d(scale) per sample,
    (B, H). With T = G U^T per head, r = sum_j P T and -d on kept entries:
    ``ds_bh = sum_ij P T (-d) - sum_i r_i sum_j P (-d)``."""
    att, keep, dist = _weights_from_stats(mesh_q, mesh_k, scale, stats, starts, width)
    B, L_out, HD = g.shape
    H = scale.shape[0]
    t = torch.einsum("bihd,bjd->bhij", g.reshape(B, L_out, H, HD // H), u)
    nd = torch.where(keep, -dist, 0.0)[:, None]
    pt = att * t
    r = pt.sum(dim=-1)
    return (pt * nd).sum(dim=(-1, -2)) - (r * (att * nd).sum(dim=-1)).sum(dim=-1)


def posatt_batched_bwd_reference(
    mesh_q, mesh_k, scale, u, g, thr=None, starts=None, *, keep_count, width=0
):
    """The backward as one plain function of the forward's inputs and the
    cotangent: (dU (B, L_in, D), dScale (B, H)), as the TPU kernel returns."""
    stats = posatt_batched_stats_reference(
        mesh_q, mesh_k, scale, thr, starts, keep_count=keep_count, width=width
    )
    return (
        posatt_batched_bwd_du_reference(mesh_q, mesh_k, scale, g, stats, starts, width=width),
        posatt_batched_bwd_dscale_reference(mesh_q, mesh_k, scale, u, g, stats, starts, width=width),
    )


# ------------------------------------------------------------ CUDA launchers


def _check(mesh_q, mesh_k, scale, u, thr, starts, width) -> None:
    named = [("mesh_q", mesh_q), ("mesh_k", mesh_k), ("scale", scale), ("inputs", u)]
    if thr is not None:
        named.append(("thr", thr))
    _check_tensors(named, mesh_q.device)
    if mesh_q.ndim != 3 or mesh_k.ndim != 3 or u.ndim != 3:
        raise ValueError("mesh_q, mesh_k and inputs must be (B, L, .) tensors")
    B, L_out, d = mesh_q.shape
    L_in = mesh_k.shape[1]
    if tuple(mesh_k.shape) != (B, L_in, d) or tuple(u.shape[:2]) != (B, L_in):
        raise ValueError(
            f"mesh_k {tuple(mesh_k.shape)} and inputs {tuple(u.shape)} must be "
            f"({B}, L_in, {d}) and ({B}, L_in, D)"
        )
    if scale.ndim != 2 or scale.shape[1] != 1:
        raise ValueError(f"scale must be (H, 1), got {tuple(scale.shape)}")
    if thr is not None and tuple(thr.shape) != (B, L_out, 1):
        raise ValueError(f"thr must be ({B}, {L_out}, 1), got {tuple(thr.shape)}")
    if starts is not None and thr is None:
        raise ValueError("a band needs the thresholds it was computed from")
    _check_starts(starts, width, B, L_out, mesh_q.device)


def _check_starts(starts, width, B, L_out, device) -> None:
    if starts is None:
        return
    n_tiles = -(-L_out // band_tile_rows(L_out))
    if width < 1:
        raise ValueError(f"a band needs a positive width, got {width}")
    if starts.dtype != torch.int32 or not starts.is_contiguous():
        raise ValueError("band starts must be a contiguous int32 tensor")
    if starts.device != device or tuple(starts.shape) != (B, n_tiles):
        raise ValueError(
            f"band starts must be ({B}, {n_tiles}) on {device}: one per band "
            f"tile of {band_tile_rows(L_out)} rows, got {tuple(starts.shape)} "
            f"on {starts.device}"
        )


def _check_cuda(name, mesh_q, scale) -> None:
    if mesh_q.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {mesh_q.device}")
    if scale.shape[0] not in CUDA_HEADS:
        raise ValueError(f"the kernels support {CUDA_HEADS} heads, got {scale.shape[0]}")
    if not 1 <= mesh_q.shape[-1] <= MAX_SPACE_DIM:
        raise ValueError(
            f"the kernels take 1 to {MAX_SPACE_DIM} coordinates per point, "
            f"got {mesh_q.shape[-1]}"
        )


def posatt_batched_cuda(
    mesh_q, mesh_k, scale, u, thr=None, starts=None, *, keep_count, width=0,
    stats=False,
):
    """Launch the forward kernel on CUDA tensors: (B, L_out, H*D), and with
    ``stats`` also the row statistics of
    :func:`posatt_batched_stats_reference`. Same arguments as
    :func:`posatt_batched_reference`. Adds one to
    ``posatt_batched_cuda.launches`` for each launch."""
    _check(mesh_q, mesh_k, scale, u, thr, starts, width)
    _check_cuda("posatt_batched_cuda", mesh_q, scale)
    H = scale.shape[0]
    B, L_out, d = mesh_q.shape
    L_in, D = u.shape[1:]
    dev = mesh_q.device
    out = torch.empty((B, L_out, H * D), dtype=torch.float32, device=dev)
    st = torch.empty((B, H + 2, L_out), dtype=torch.float32, device=dev) if stats else None
    fn = _entry("posatt_batched_fwd", "posatt_batched_fwd", 8, 9)
    _launch(fn, "posatt_batched_fwd", dev, mesh_q, mesh_k, scale, u, thr, starts,
            out, st, H, B, L_out, L_in, D, d, keep_count, width if starts is not None else 0,
            band_tile_rows(L_out))
    posatt_batched_cuda.launches += 1
    return (out, st) if stats else out


def _check_bwd(name, mesh_q, mesh_k, scale, g, stats, starts, width, u=None) -> None:
    """The backward launchers' inputs: the forward's coordinates, scale,
    values and band, its row statistics and a cotangent of its output."""
    named = [("mesh_q", mesh_q), ("mesh_k", mesh_k), ("scale", scale), ("g", g), ("stats", stats)]
    _check_tensors(named + ([("inputs", u)] if u is not None else []), mesh_q.device)
    _check_cuda(name, mesh_q, scale)
    H = scale.shape[0]
    B, L_out, d = mesh_q.shape
    L_in = mesh_k.shape[1]
    D = u.shape[-1] if u is not None else g.shape[-1] // H
    if tuple(mesh_k.shape) != (B, L_in, d) or (u is not None and tuple(u.shape) != (B, L_in, D)):
        raise ValueError(
            f"mesh_k {tuple(mesh_k.shape)} and inputs must be ({B}, L_in, {d}) "
            f"and ({B}, L_in, D)"
        )
    _check_starts(starts, width, B, L_out, mesh_q.device)
    if tuple(g.shape) != (B, L_out, H * D):
        raise ValueError(f"g must be ({B}, {L_out}, {H * D}), got {tuple(g.shape)}")
    if tuple(stats.shape) != (B, H + 2, L_out):
        raise ValueError(f"stats must be ({B}, {H + 2}, {L_out}), got {tuple(stats.shape)}")


def posatt_batched_bwd_dscale_cuda(mesh_q, mesh_k, scale, u, g, stats, starts=None, *, width=0):
    """Launch the dscale kernel on CUDA tensors: (B, H). Deterministic:
    per-block partials summed per sample in a fixed order inside the
    library. Adds one to ``posatt_batched_bwd_dscale_cuda.launches``."""
    _check_bwd("posatt_batched_bwd_dscale_cuda", mesh_q, mesh_k, scale, g, stats, starts, width, u)
    H = scale.shape[0]
    B, L_out, d = mesh_q.shape
    L_in, D = u.shape[1:]
    dev = mesh_q.device
    # an upper bound on the kernel's blocks per sample: 16 rows by at least
    # 32 value columns each
    partial = torch.empty((B, -(-L_out // _TLO) * -(-D // 32), H), dtype=torch.float32, device=dev)
    ds = torch.empty((B, H), dtype=torch.float32, device=dev)
    fn = _entry("posatt_batched_bwd", "posatt_batched_bwd_dscale", 9, 8)
    _launch(fn, "posatt_batched_bwd_dscale", dev, mesh_q, mesh_k, scale, u, g, stats,
            starts, partial, ds, H, B, L_out, L_in, D, d,
            width if starts is not None else 0, band_tile_rows(L_out))
    posatt_batched_bwd_dscale_cuda.launches += 1
    return ds


def posatt_batched_bwd_du_cuda(mesh_q, mesh_k, scale, g, stats, starts=None, *, width=0):
    """Launch the du kernel on CUDA tensors: (B, L_in, D) on the extended
    key axis. Adds one to ``posatt_batched_bwd_du_cuda.launches``."""
    _check_bwd("posatt_batched_bwd_du_cuda", mesh_q, mesh_k, scale, g, stats, starts, width)
    H = scale.shape[0]
    B, L_out, d = mesh_q.shape
    L_in = mesh_k.shape[1]
    D = g.shape[-1] // H
    du = torch.empty((B, L_in, D), dtype=torch.float32, device=mesh_q.device)
    fn = _entry("posatt_batched_bwd", "posatt_batched_bwd_du", 7, 8)
    _launch(fn, "posatt_batched_bwd_du", mesh_q.device, mesh_q, mesh_k, scale, g, stats,
            starts, du, H, B, L_out, L_in, D, d,
            width if starts is not None else 0, band_tile_rows(L_out))
    posatt_batched_bwd_du_cuda.launches += 1
    return du


posatt_batched_cuda.launches = 0
posatt_batched_bwd_dscale_cuda.launches = 0
posatt_batched_bwd_du_cuda.launches = 0


def _forward(mesh_q, mesh_k, scale, u, thr, starts, keep_count, width, stats=False):
    """The forward on either device, with the row statistics when asked;
    the inputs are validated once, by the launcher or here."""
    if mesh_q.device.type == "cuda":
        return posatt_batched_cuda(mesh_q, mesh_k, scale, u, thr, starts,
                                   keep_count=keep_count, width=width, stats=stats)
    _check(mesh_q, mesh_k, scale, u, thr, starts, width)
    kw = dict(keep_count=keep_count, width=width)
    out = posatt_batched_reference(mesh_q, mesh_k, scale, u, thr, starts, **kw)
    if not stats:
        return out
    return out, posatt_batched_stats_reference(mesh_q, mesh_k, scale, thr, starts, **kw)


class PosAttBatched(torch.autograd.Function):
    """Per-sample-mesh position attention with its fused backward:
    ``apply(mesh_q, mesh_k, scale, u, thr, starts, keep_count, width)`` ->
    (B, L_out, H*D), the ``_posatt_batched`` custom VJP.

    The forward runs the forward kernel with its row statistics and saves
    (coordinates, scale, values, statistics, starts); the backward runs the
    dscale kernel when ``scale`` needs a gradient, summing its per-sample
    (B, H) result over B, and the du kernel when ``u`` does. Coordinates,
    thresholds and starts get none. CPU tensors take the plain versions of
    the same functions.
    """

    @staticmethod
    def forward(ctx, mesh_q, mesh_k, scale, u, thr, starts, keep_count, width):
        out, stats = _forward(mesh_q, mesh_k, scale, u, thr, starts, keep_count, width, stats=True)
        ctx.save_for_backward(mesh_q, mesh_k, scale, u, stats, starts)
        ctx.width = width
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        mesh_q, mesh_k, scale, u, stats, starts = ctx.saved_tensors
        g = g.contiguous()  # the residual concat hands over a strided slice
        cuda = mesh_q.device.type == "cuda"
        dscale = du = None
        if ctx.needs_input_grad[2]:
            fn = posatt_batched_bwd_dscale_cuda if cuda else posatt_batched_bwd_dscale_reference
            ds = fn(mesh_q, mesh_k, scale, u, g, stats, starts, width=ctx.width)
            dscale = ds.sum(dim=0).reshape(scale.shape)
        if ctx.needs_input_grad[3]:
            fn = posatt_batched_bwd_du_cuda if cuda else posatt_batched_bwd_du_reference
            du = fn(mesh_q, mesh_k, scale, g, stats, starts, width=ctx.width)
        return None, None, dscale, du, None, None, None, None


def position_attention_batched(
    mesh_q: torch.Tensor,
    mesh_k: torch.Tensor,
    lmda: torch.Tensor,
    inputs: torch.Tensor,
    locality: float,
    thr: Optional[torch.Tensor] = None,
    band: Optional[BandSpec] = None,
) -> torch.Tensor:
    """Position attention over per-sample meshes: raw coordinates
    (B, L_out, d) and (B, L_in, d), values (B, L_in, D) -> (B, L_out, H*D).

    Same contract as ``ops.posatt.position_attention`` on the batched
    Euclidean distances. ``thr`` (B, L_out, 1): precomputed per-row
    thresholds; when missing with ``locality < 1`` and a keep count above
    32 they are computed here by ``robust_topk_threshold``, below it the
    kernel finds the keep count's distinct value itself. ``band``: a
    :class:`BandSpec` (needs ``thr``); with a wrap margin the keys and
    values are extended before the Function, so that autograd's concat
    adjoint routes the duplicated value gradients back. When a gradient
    is needed the call goes through :class:`PosAttBatched`; otherwise only
    the forward kernel runs.
    """
    if mesh_q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {mesh_q.device}")
    H = lmda.shape[0]
    keep_count = topk_keep_count(mesh_k.shape[1], locality)
    if band is not None and thr is None:
        raise ValueError(
            "a band needs precomputed thresholds: its starts hold only for "
            "the thresholds they were computed from"
        )
    if thr is None and locality < 1.0 and keep_count > 32:
        thr = robust_topk_threshold(euclidean_sq(mesh_q, mesh_k), locality)
    scale = bandwidth_scale(lmda).reshape(H, 1)
    starts, width = (None, 0) if band is None else (band.starts, band.width)
    if band is not None and band.wrap:
        mesh_k = torch.cat([mesh_k, mesh_k[:, : band.wrap]], dim=1)
        inputs = torch.cat([inputs, inputs[:, : band.wrap]], dim=1)
    if torch.is_grad_enabled() and (scale.requires_grad or inputs.requires_grad):
        return PosAttBatched.apply(mesh_q, mesh_k, scale, inputs, thr, starts, keep_count, width)
    return _forward(mesh_q, mesh_k, scale, inputs, thr, starts, keep_count, width)
