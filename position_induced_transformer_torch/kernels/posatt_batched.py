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

The TF-semantics point-cloud model (elasticity_tf) has four more kernels,
in two more sources:

- ``csrc/posatt_tf_fwd.cu``: the forwards ``_make_tf_fwd_kernel`` (#9,
  over pre-built (B, L_out, L_in) distances) and
  ``_make_tf_coord_fwd_kernel`` (#11, from coordinates, with an optional
  band); both write the backward's row statistics when asked;
- ``csrc/posatt_tf_bwd.cu``: their backwards ``_make_tf_bwd_kernel`` (#10)
  and ``_make_tf_coord_bwd_kernel`` (#12), each as two entry points, the
  per-sample bandwidth gradient (dscale, which also reads the forward's
  output) and the value gradient (dv).

They compute the function above with two differences: every column of
the window is kept without ``thr`` (no keep count), and the values are per
head, ``values`` (B, L_in, H*V) with head h reading only its own columns
``[h*V, (h+1)*V)``, so that ``out[b, i, h*V:(h+1)*V] = sum_j p_hij
values[b, j, h*V:(h+1)*V] / max(sum_j p_hij, 1e-30)``.

:func:`position_attention_dist` runs #9 and #10 for the torch-semantics
PiT on a batched non-lazy Geometry, whose (B, L_out, L_in) distances are
materialized: the values copied once per head, and a row that keeps
nothing given the uniform mean of the values, as the reference gives it.

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
    _check_tensors,
    _entry,
    _launch,
)
from position_induced_transformer_torch.ops.distances import euclidean_sq
from position_induced_transformer_torch.ops.locality import (
    quantile_threshold,
    robust_topk_threshold,
    topk_keep_count,
)
from position_induced_transformer_torch.ops.posatt import bandwidth_scale

MAX_SPACE_DIM = 4  # coordinates per point the kernels take


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


def _check_cuda(name, mesh_q) -> None:
    if mesh_q.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {mesh_q.device}")
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
    _check_cuda("posatt_batched_cuda", mesh_q)
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


def _check_bwd(name, mesh_q, mesh_k, scale, g, stats, starts, width, u=None, out=None) -> None:
    """The backward launchers' inputs: the forward's coordinates, scale,
    values and band, its row statistics and a cotangent of its output, and
    for dscale the values and the forward's output."""
    named = [("mesh_q", mesh_q), ("mesh_k", mesh_k), ("scale", scale), ("g", g), ("stats", stats)]
    named += [("inputs", u), ("out", out)] if u is not None else []
    _check_tensors(named, mesh_q.device)
    _check_cuda(name, mesh_q)
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
    if out is not None and out.shape != g.shape:
        raise ValueError(f"out must be {tuple(g.shape)} as g, got {tuple(out.shape)}")
    if tuple(stats.shape) != (B, H + 2, L_out):
        raise ValueError(f"stats must be ({B}, {H + 2}, {L_out}), got {tuple(stats.shape)}")


def posatt_batched_bwd_dscale_cuda(mesh_q, mesh_k, scale, u, out, g, stats, starts=None, *,
                                   width=0):
    """Launch the dscale kernel on CUDA tensors: (B, H), from the forward's
    inputs, its output ``out`` (B, L_out, H*D) and row statistics and a
    cotangent ``g``. Deterministic: per-block partials summed per sample
    and head in a fixed order inside the library. Adds one to
    ``posatt_batched_bwd_dscale_cuda.launches``."""
    _check_bwd("posatt_batched_bwd_dscale_cuda", mesh_q, mesh_k, scale, g, stats, starts, width,
               u, out)
    H = scale.shape[0]
    B, L_out, d = mesh_q.shape
    L_in, D = u.shape[1:]
    dev = mesh_q.device
    # an upper bound on the kernel's blocks per (sample, head): 32 rows by at
    # least 64 value columns each
    partial = torch.empty((B, H, -(-L_out // 32) * -(-D // 64)), dtype=torch.float32, device=dev)
    ds = torch.empty((B, H), dtype=torch.float32, device=dev)
    fn = _entry("posatt_batched_bwd", "posatt_batched_bwd_dscale", 10, 8)
    _launch(fn, "posatt_batched_bwd_dscale", dev, mesh_q, mesh_k, scale, u, out, g, stats,
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
    (coordinates, scale, values, statistics, starts, output); the backward
    runs the dscale kernel, which reads the output, when ``scale`` needs a
    gradient, summing its per-sample (B, H) result over B, and the du
    kernel when ``u`` does. Coordinates, thresholds and starts get none.
    CPU tensors take the plain versions of the same functions.
    """

    @staticmethod
    def forward(ctx, mesh_q, mesh_k, scale, u, thr, starts, keep_count, width):
        out, stats = _forward(mesh_q, mesh_k, scale, u, thr, starts, keep_count, width, stats=True)
        ctx.save_for_backward(mesh_q, mesh_k, scale, u, stats, starts, out)
        ctx.width = width
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        mesh_q, mesh_k, scale, u, stats, starts, out = ctx.saved_tensors
        g = g.contiguous()  # the residual concat hands over a strided slice
        cuda = mesh_q.device.type == "cuda"
        dscale = du = None
        if ctx.needs_input_grad[2]:
            if cuda:
                ds = posatt_batched_bwd_dscale_cuda(mesh_q, mesh_k, scale, u, out, g, stats, starts,
                                                    width=ctx.width)
            else:
                ds = posatt_batched_bwd_dscale_reference(mesh_q, mesh_k, scale, u, g, stats, starts,
                                                         width=ctx.width)
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


# ============================================ TF semantics: kernels #9 - #12
#
# #9 and #10 read pre-built distances (B, L_out, L_in); #11 and #12 compute
# them from coordinates and take a band. Both keep every column of the
# window without ``thr``. The forward kernels write the row statistics of
# posatt_batched_stats_reference (dmin, the keep threshold, +inf without
# thr, and per head the reciprocal denominator) for the backward kernels.

# ------------------------------------------------------------ plain versions


def _tf_keep(dist, thr):
    """The keep mask and bare row minimum over pre-built distances."""
    t = torch.full_like(dist[..., :1], float("inf")) if thr is None else thr
    return dist <= t, dist.amin(dim=-1, keepdim=True), t


def _tf_attention(dist, keep, dmin, scale):
    """Normalised weights (B, H, L_out, L_in), exactly 0 where not kept."""
    p = _exp_weights(dist, keep, dmin, scale)
    return p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def _tf_apply(att, values):
    """Head h's weights on head h's value columns: (B, L_out, H*V)."""
    B, H, L_out, L_in = att.shape
    v = values.reshape(B, L_in, H, -1)
    return torch.einsum("bhij,bjhv->bihv", att, v).reshape(B, L_out, -1)


def _tf_grads(att, keep, dist, values, g):
    """(dValues (B, L_in, H*V), dScale (B, H)) as the TPU backward kernels
    compute them: with T = G_h V_h^T, r = sum_j P T and -d on kept entries,
    ``ds_bh = sum_ij P T (-d) - sum_i r_i sum_j P (-d)``."""
    B, H, L_out, L_in = att.shape
    gh, vh = g.reshape(B, L_out, H, -1), values.reshape(B, L_in, H, -1)
    dv = torch.einsum("bhij,bihv->bjhv", att, gh).reshape(B, L_in, -1)
    t = torch.einsum("bihv,bjhv->bhij", gh, vh)
    nd = torch.where(keep, -dist, 0.0)[:, None]
    pt = att * t
    r = pt.sum(dim=-1)
    ds = (pt * nd).sum(dim=(-1, -2)) - (r * (att * nd).sum(dim=-1)).sum(dim=-1)
    return dv, ds


def posatt_tf_reference(dist, thr, scale, values):
    """Plain PyTorch version of kernel #9: (B, L_out, H*V) over pre-built
    distances ``dist`` (B, L_out, L_in), ``thr`` (B, L_out, 1) or None,
    ``scale`` (H, 1) >= 0 and per-head ``values`` (B, L_in, H*V)."""
    keep, dmin, _ = _tf_keep(dist, thr)
    return _tf_apply(_tf_attention(dist, keep, dmin, scale), values)


def posatt_tf_stats_reference(dist, thr, scale):
    """Plain version of the row statistics kernel #9 writes for the
    backward, laid out as :func:`posatt_batched_stats_reference`'s."""
    keep, dmin, t = _tf_keep(dist, thr)
    rden = 1.0 / _exp_weights(dist, keep, dmin, scale).sum(dim=-1).clamp_min(1e-30)
    return torch.cat([dmin.transpose(1, 2), t.transpose(1, 2), rden], dim=1)


def posatt_tf_bwd_reference(dist, thr, scale, values, g):
    """Plain version of kernel #10: (dValues (B, L_in, H*V), dScale (B, H))
    for a cotangent ``g`` (B, L_out, H*V) of #9's output."""
    keep, dmin, _ = _tf_keep(dist, thr)
    return _tf_grads(_tf_attention(dist, keep, dmin, scale), keep, dist, values, g)


def _tf_coord_rows(mesh_q, mesh_k, thr, starts, width):
    """Distances, keep mask and bare window minimum from coordinates: the
    rows of the batched kernels with every column of the window kept
    where ``thr`` is None."""
    dist, keep, dmin, _ = _rows(mesh_q, mesh_k, thr, starts, mesh_k.shape[1], width)
    return dist, keep, dmin


def posatt_tf_coord_reference(mesh_q, mesh_k, scale, values, thr=None, starts=None, *, width=0):
    """Plain version of kernel #11: (B, L_out, H*V) from coordinates
    ``mesh_q`` (B, L_out, d) and ``mesh_k`` (B, L_in, d), with ``values``
    (B, L_in, H*V) on the extended key axis and the band of
    :func:`posatt_batched_reference`. The caller folds the TF halving of
    the distances into ``scale`` and ``thr``."""
    dist, keep, dmin = _tf_coord_rows(mesh_q, mesh_k, thr, starts, width)
    return _tf_apply(_tf_attention(dist, keep, dmin, scale), values)


def posatt_tf_coord_bwd_reference(
    mesh_q, mesh_k, scale, values, g, thr=None, starts=None, *, width=0
):
    """Plain version of kernel #12: (dValues on the extended key axis,
    dScale (B, H)) for a cotangent ``g`` of #11's output."""
    dist, keep, dmin = _tf_coord_rows(mesh_q, mesh_k, thr, starts, width)
    return _tf_grads(_tf_attention(dist, keep, dmin, scale), keep, dist, values, g)


# ------------------------------------------------------------ CUDA launchers


def _check_tf(dist, thr, scale, values) -> None:
    named = [("dist", dist), ("scale", scale), ("values", values)]
    _check_tensors(named + ([("thr", thr)] if thr is not None else []), dist.device)
    if dist.ndim != 3 or values.ndim != 3:
        raise ValueError("dist and values must be (B, L, .) tensors")
    B, L_out, L_in = dist.shape
    _check_tf_heads(scale, values, B, L_in)
    if thr is not None and tuple(thr.shape) != (B, L_out, 1):
        raise ValueError(f"thr must be ({B}, {L_out}, 1), got {tuple(thr.shape)}")


def _check_tf_heads(scale, values, B, L_in) -> None:
    if scale.ndim != 2 or scale.shape[1] != 1 or scale.shape[0] < 1:
        raise ValueError(f"scale must be (H, 1), got {tuple(scale.shape)}")
    if tuple(values.shape[:2]) != (B, L_in) or values.shape[2] % scale.shape[0]:
        raise ValueError(
            f"values must be ({B}, {L_in}, H*V) with H = {scale.shape[0]}, got "
            f"{tuple(values.shape)}"
        )


def _check_tf_coord(mesh_q, mesh_k, scale, values, thr, starts, width) -> None:
    named = [("mesh_q", mesh_q), ("mesh_k", mesh_k), ("scale", scale), ("values", values)]
    _check_tensors(named + ([("thr", thr)] if thr is not None else []), mesh_q.device)
    if mesh_q.ndim != 3 or mesh_k.ndim != 3 or values.ndim != 3:
        raise ValueError("mesh_q, mesh_k and values must be (B, L, .) tensors")
    B, L_out, d = mesh_q.shape
    L_in = mesh_k.shape[1]
    if tuple(mesh_k.shape) != (B, L_in, d):
        raise ValueError(f"mesh_k must be ({B}, L_in, {d}), got {tuple(mesh_k.shape)}")
    _check_tf_heads(scale, values, B, L_in)
    if thr is not None and tuple(thr.shape) != (B, L_out, 1):
        raise ValueError(f"thr must be ({B}, {L_out}, 1), got {tuple(thr.shape)}")
    if starts is not None and thr is None:
        raise ValueError("a band needs the thresholds it was computed from")
    _check_starts(starts, width, B, L_out, mesh_q.device)


def _check_tf_cuda(name, t, space_dim=None) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {t.device}")
    if space_dim is not None and not 1 <= space_dim <= MAX_SPACE_DIM:
        raise ValueError(
            f"the kernels take 1 to {MAX_SPACE_DIM} coordinates per point, got {space_dim}"
        )


def _check_tf_bwd(B, L_out, L_in, scale, g, stats, values=None, out=None) -> None:
    """The backward launchers' cotangent, statistics, and for dscale the
    values and the forward's output."""
    named = [("g", g), ("stats", stats)]
    named += [("values", values), ("out", out)] if values is not None else []
    _check_tensors(named, scale.device)
    H = scale.shape[0]
    if g.ndim != 3 or tuple(g.shape[:2]) != (B, L_out) or g.shape[2] % H:
        raise ValueError(f"g must be ({B}, {L_out}, H*V), got {tuple(g.shape)}")
    if values is not None and tuple(values.shape) != (B, L_in, g.shape[2]):
        raise ValueError(f"values must be ({B}, {L_in}, {g.shape[2]}), got {tuple(values.shape)}")
    if out is not None and out.shape != g.shape:
        raise ValueError(f"out must be {tuple(g.shape)} as g, got {tuple(out.shape)}")
    if tuple(stats.shape) != (B, H + 2, L_out):
        raise ValueError(f"stats must be ({B}, {H + 2}, {L_out}), got {tuple(stats.shape)}")


def _check_tf_dist_bwd(name, dist, scale, g, stats, values=None, out=None):
    _check_tensors([("dist", dist), ("scale", scale)], dist.device)
    _check_tf_cuda(name, dist)
    if dist.ndim != 3:
        raise ValueError(f"dist must be (B, L_out, L_in), got {tuple(dist.shape)}")
    B, L_out, L_in = dist.shape
    _check_tf_bwd(B, L_out, L_in, scale, g, stats, values, out)
    return B, L_out, L_in


def _tf_partials(B, L_out, H, V, device):
    """Scratch for the dscale kernels' per-block partials: the blocks per
    (sample, head), 32 rows by 64 value columns each."""
    return torch.empty((B, H, -(-L_out // 32) * -(-V // 64)), dtype=torch.float32, device=device)


def posatt_tf_cuda(dist, thr, scale, values, *, stats=False):
    """Launch kernel #9 on CUDA tensors: (B, L_out, H*V), and with
    ``stats`` also its row statistics (:func:`posatt_tf_stats_reference`).
    Adds one to ``posatt_tf_cuda.launches`` for each launch."""
    _check_tf(dist, thr, scale, values)
    _check_tf_cuda("posatt_tf_cuda", dist)
    B, L_out, L_in = dist.shape
    H = scale.shape[0]
    dev = dist.device
    out = torch.empty((B, L_out, values.shape[2]), dtype=torch.float32, device=dev)
    st = torch.empty((B, H + 2, L_out), dtype=torch.float32, device=dev) if stats else None
    fn = _entry("posatt_tf_fwd", "posatt_tf_fwd", 6, 5)
    _launch(fn, "posatt_tf_fwd", dev, dist, thr, scale, values, out, st,
            B, L_out, L_in, H, values.shape[2] // H)
    posatt_tf_cuda.launches += 1
    return (out, st) if stats else out


def posatt_tf_bwd_dscale_cuda(dist, scale, values, out, g, stats):
    """Launch #10's dscale entry point: (B, H), from #9's inputs, its
    output ``out`` and row statistics and a cotangent ``g``. Deterministic:
    per-block partials summed per sample and head in a fixed order. Adds
    one to ``posatt_tf_bwd_dscale_cuda.launches``."""
    B, L_out, L_in = _check_tf_dist_bwd("posatt_tf_bwd_dscale_cuda", dist, scale, g, stats,
                                        values, out)
    H, V = scale.shape[0], g.shape[2] // scale.shape[0]
    partial = _tf_partials(B, L_out, H, V, dist.device)
    ds = torch.empty((B, H), dtype=torch.float32, device=dist.device)
    fn = _entry("posatt_tf_bwd", "posatt_tf_bwd_dscale", 8, 5)
    _launch(fn, "posatt_tf_bwd_dscale", dist.device, dist, scale, values, out, g, stats, partial,
            ds, B, L_out, L_in, H, V)
    posatt_tf_bwd_dscale_cuda.launches += 1
    return ds


def posatt_tf_bwd_dv_cuda(dist, scale, g, stats):
    """Launch #10's dv entry point: (B, L_in, H*V). Adds one to
    ``posatt_tf_bwd_dv_cuda.launches``."""
    B, L_out, L_in = _check_tf_dist_bwd("posatt_tf_bwd_dv_cuda", dist, scale, g, stats)
    H = scale.shape[0]
    dv = torch.empty((B, L_in, g.shape[2]), dtype=torch.float32, device=dist.device)
    fn = _entry("posatt_tf_bwd", "posatt_tf_bwd_dv", 5, 5)
    _launch(fn, "posatt_tf_bwd_dv", dist.device, dist, scale, g, stats, dv,
            B, L_out, L_in, H, g.shape[2] // H)
    posatt_tf_bwd_dv_cuda.launches += 1
    return dv


def posatt_tf_coord_cuda(mesh_q, mesh_k, scale, values, thr=None, starts=None, *, width=0,
                         stats=False):
    """Launch kernel #11 on CUDA tensors: (B, L_out, H*V), and with
    ``stats`` also its row statistics (those of
    :func:`posatt_batched_stats_reference` with every column of the window
    kept where ``thr`` is None). Adds one to
    ``posatt_tf_coord_cuda.launches`` for each launch."""
    _check_tf_coord(mesh_q, mesh_k, scale, values, thr, starts, width)
    B, L_out, d = mesh_q.shape
    _check_tf_cuda("posatt_tf_coord_cuda", mesh_q, d)
    L_in, H = mesh_k.shape[1], scale.shape[0]
    dev = mesh_q.device
    out = torch.empty((B, L_out, values.shape[2]), dtype=torch.float32, device=dev)
    st = torch.empty((B, H + 2, L_out), dtype=torch.float32, device=dev) if stats else None
    fn = _entry("posatt_tf_fwd", "posatt_tf_coord_fwd", 8, 8)
    _launch(fn, "posatt_tf_coord_fwd", dev, mesh_q, mesh_k, scale, values, thr, starts, out, st,
            B, L_out, L_in, H, values.shape[2] // H, d,
            width if starts is not None else 0, band_tile_rows(L_out))
    posatt_tf_coord_cuda.launches += 1
    return (out, st) if stats else out


def _check_tf_coord_bwd(name, mesh_q, mesh_k, scale, g, stats, starts, width, values=None,
                        out=None):
    _check_tensors([("mesh_q", mesh_q), ("mesh_k", mesh_k), ("scale", scale)], mesh_q.device)
    B, L_out, d = mesh_q.shape
    _check_tf_cuda(name, mesh_q, d)
    L_in = mesh_k.shape[1]
    if tuple(mesh_k.shape) != (B, L_in, d):
        raise ValueError(f"mesh_k must be ({B}, L_in, {d}), got {tuple(mesh_k.shape)}")
    _check_tf_bwd(B, L_out, L_in, scale, g, stats, values, out)
    _check_starts(starts, width, B, L_out, mesh_q.device)
    return B, L_out, L_in, d


def posatt_tf_coord_bwd_dscale_cuda(mesh_q, mesh_k, scale, values, out, g, stats, starts=None,
                                    *, width=0):
    """Launch #12's dscale entry point: (B, H), from #11's inputs, its
    output ``out`` and row statistics and a cotangent ``g``; deterministic
    as #10's. Adds one to ``posatt_tf_coord_bwd_dscale_cuda.launches``."""
    B, L_out, L_in, d = _check_tf_coord_bwd("posatt_tf_coord_bwd_dscale_cuda", mesh_q, mesh_k,
                                            scale, g, stats, starts, width, values, out)
    H, V = scale.shape[0], g.shape[2] // scale.shape[0]
    dev = mesh_q.device
    partial = _tf_partials(B, L_out, H, V, dev)
    ds = torch.empty((B, H), dtype=torch.float32, device=dev)
    fn = _entry("posatt_tf_bwd", "posatt_tf_coord_bwd_dscale", 10, 8)
    _launch(fn, "posatt_tf_coord_bwd_dscale", dev, mesh_q, mesh_k, scale, values, out, g, stats,
            starts, partial, ds, B, L_out, L_in, H, V, d,
            width if starts is not None else 0, band_tile_rows(L_out))
    posatt_tf_coord_bwd_dscale_cuda.launches += 1
    return ds


def posatt_tf_coord_bwd_dv_cuda(mesh_q, mesh_k, scale, g, stats, starts=None, *, width=0):
    """Launch #12's dv entry point: (B, L_in, H*V) on the extended key
    axis. Adds one to ``posatt_tf_coord_bwd_dv_cuda.launches``."""
    B, L_out, L_in, d = _check_tf_coord_bwd("posatt_tf_coord_bwd_dv_cuda", mesh_q, mesh_k,
                                            scale, g, stats, starts, width)
    H = scale.shape[0]
    dev = mesh_q.device
    dv = torch.empty((B, L_in, g.shape[2]), dtype=torch.float32, device=dev)
    fn = _entry("posatt_tf_bwd", "posatt_tf_coord_bwd_dv", 7, 8)
    _launch(fn, "posatt_tf_coord_bwd_dv", dev, mesh_q, mesh_k, scale, g, stats, starts, dv,
            B, L_out, L_in, H, g.shape[2] // H, d,
            width if starts is not None else 0, band_tile_rows(L_out))
    posatt_tf_coord_bwd_dv_cuda.launches += 1
    return dv


posatt_tf_cuda.launches = 0
posatt_tf_bwd_dscale_cuda.launches = 0
posatt_tf_bwd_dv_cuda.launches = 0
posatt_tf_coord_cuda.launches = 0
posatt_tf_coord_bwd_dscale_cuda.launches = 0
posatt_tf_coord_bwd_dv_cuda.launches = 0


# ------------------------------------------------------------ autograd


def _tf_grad_outputs(ctx, scale, ds, dv):
    """dScale summed over the batch, and dValues, where they are needed."""
    dscale = ds.sum(dim=0).reshape(scale.shape) if ctx.needs_input_grad[2] else None
    return dscale, dv if ctx.needs_input_grad[3] else None


def _tf_forward(dist, thr, scale, values):
    """Kernel #9 with its row statistics on either device: (out, stats)."""
    if dist.device.type == "cuda":
        return posatt_tf_cuda(dist, thr, scale, values, stats=True)
    _check_tf(dist, thr, scale, values)
    return posatt_tf_reference(dist, thr, scale, values), posatt_tf_stats_reference(dist, thr, scale)


class PosAttTF(torch.autograd.Function):
    """Kernel #9 with its backward #10: ``apply(dist, thr, scale, values)``
    -> (out (B, L_out, H*V), row statistics (B, H + 2, L_out)), the
    ``_posatt_tf`` custom VJP; the statistics take no gradient. The forward
    saves its output and statistics on either device: the dscale entry
    point reads both. The backward runs the
    dscale entry point when ``scale`` needs a gradient (summing its
    per-sample (B, H) result over B) and the dv one when ``values`` does;
    ``dist`` and ``thr`` get none. CPU tensors take the plain versions."""

    @staticmethod
    def forward(ctx, dist, thr, scale, values):
        out, stats = _tf_forward(dist, thr, scale, values)
        ctx.save_for_backward(dist, thr, scale, values, out, stats)
        ctx.mark_non_differentiable(stats)
        return out, stats

    @staticmethod
    @once_differentiable
    def backward(ctx, g, _g_stats):
        dist, thr, scale, values, out, stats = ctx.saved_tensors
        g = g.contiguous()
        if dist.device.type != "cuda":
            dv, ds = posatt_tf_bwd_reference(dist, thr, scale, values, g)
        else:
            ds = (posatt_tf_bwd_dscale_cuda(dist, scale, values, out, g, stats)
                  if ctx.needs_input_grad[2] else None)
            dv = posatt_tf_bwd_dv_cuda(dist, scale, g, stats) if ctx.needs_input_grad[3] else None
        return (None, None, *_tf_grad_outputs(ctx, scale, ds, dv))


class PosAttTFCoord(torch.autograd.Function):
    """Kernel #11 with its backward #12: ``apply(mesh_q, mesh_k, scale,
    values, thr, starts, width)`` -> (B, L_out, H*V), the
    ``_posatt_tf_coord`` custom VJP; saved output and gradients as
    :class:`PosAttTF`'s."""

    @staticmethod
    def forward(ctx, mesh_q, mesh_k, scale, values, thr, starts, width):
        if mesh_q.device.type == "cuda":
            out, stats = posatt_tf_coord_cuda(mesh_q, mesh_k, scale, values, thr, starts,
                                              width=width, stats=True)
        else:
            _check_tf_coord(mesh_q, mesh_k, scale, values, thr, starts, width)
            out = posatt_tf_coord_reference(mesh_q, mesh_k, scale, values, thr, starts, width=width)
            stats = None
        ctx.save_for_backward(mesh_q, mesh_k, scale, values, thr, starts, out, stats)
        ctx.width = width
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        mesh_q, mesh_k, scale, values, thr, starts, out, stats = ctx.saved_tensors
        g = g.contiguous()
        w = dict(width=ctx.width)
        if mesh_q.device.type != "cuda":
            dv, ds = posatt_tf_coord_bwd_reference(mesh_q, mesh_k, scale, values, g, thr, starts, **w)
        else:
            ds = dv = None
            if ctx.needs_input_grad[2]:
                ds = posatt_tf_coord_bwd_dscale_cuda(mesh_q, mesh_k, scale, values, out, g, stats,
                                                     starts, **w)
            if ctx.needs_input_grad[3]:
                dv = posatt_tf_coord_bwd_dv_cuda(mesh_q, mesh_k, scale, g, stats, starts, **w)
        return (None, None, *_tf_grad_outputs(ctx, scale, ds, dv), None, None, None)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def position_attention_batched_dist(
    dist: torch.Tensor,
    scales: torch.Tensor,
    values: torch.Tensor,
    thr: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """TF-semantics position attention over pre-built per-sample distances
    (kernel #9): ``dist`` (B, L_out, L_in), ``scales`` (H, 1) >= 0 (r^2),
    per-head ``values`` (B, L_in, H*V) -> (B, L_out, H*V). ``thr`` (B,
    L_out, 1): locality thresholds on ``dist``; None keeps every column.
    Differentiable in ``scales`` and ``values`` through :class:`PosAttTF`;
    without a gradient only the forward kernel runs."""
    if dist.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dist.device}")
    if _needs_grad(scales, values):
        return PosAttTF.apply(dist, thr, scales, values)[0]
    if dist.device.type == "cuda":
        return posatt_tf_cuda(dist, thr, scales, values)
    _check_tf(dist, thr, scales, values)
    return posatt_tf_reference(dist, thr, scales, values)


def position_attention_dist(
    dist: torch.Tensor,
    lmda: torch.Tensor,
    u: torch.Tensor,
    locality: float,
    thr: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Torch-semantics position attention over materialized per-sample
    distances, through kernel #9 and, under autograd, #10: ``dist`` (B,
    L_out, L_in), ``lmda`` (H, 1, 1), values ``u`` (B, L_in, D) -> (B,
    L_out, H*D), the contract of ``ops.posatt.position_attention`` on a
    batched ``dist`` (the route of a batched non-lazy Geometry).

    ``thr`` (B, L_out, 1): per-row thresholds on ``dist``; with ``locality
    < 1`` and none given, the row quantile (``keep_mask``'s) is taken here
    first; with ``locality >= 1`` every column is kept and ``thr`` is not
    read. #9 and #10 take per-head values, so ``u`` is copied once per head
    (``[u | u | ...]``): autograd sums the copies' gradients into ``du``,
    and carries the batch-summed dScale to ``lmda`` through
    ``bandwidth_scale``. A row that keeps nothing (``thr`` below the row's
    least distance) gives the uniform mean of ``u``, as the reference's
    softmax over logits that are all ``-F32_MAX`` does; #9 writes 0 there,
    and the wrapper finds those rows from the least distance #9 writes
    among its row statistics. CPU tensors take the plain versions.
    """
    if dist.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dist.device}")
    if dist.ndim != 3 or u.ndim != 3:
        raise ValueError(
            f"dist must be (B, L_out, L_in) and u (B, L_in, D), got {tuple(dist.shape)} "
            f"and {tuple(u.shape)}"
        )
    H = lmda.shape[0]
    if locality >= 1.0:
        thr = None
    elif thr is None:
        thr = quantile_threshold(dist, locality)
    scales = bandwidth_scale(lmda).reshape(H, 1)
    values = u.repeat(1, 1, H)
    if _needs_grad(scales, values):
        out, stats = PosAttTF.apply(dist, thr, scales, values)
    else:
        out, stats = _tf_forward(dist, thr, scales, values)
    if thr is None:
        return out
    empty = (stats[:, 0] > stats[:, 1]).unsqueeze(-1)  # the least distance above thr
    return torch.where(empty, u.mean(dim=1, keepdim=True).repeat(1, 1, H), out)


def position_attention_batched_tf_coords(
    coords_q: torch.Tensor,
    coords_k: torch.Tensor,
    scales: torch.Tensor,
    values: torch.Tensor,
    thr: Optional[torch.Tensor] = None,
    band: Optional[BandSpec] = None,
) -> torch.Tensor:
    """TF-semantics position attention from point-cloud coordinates (kernel
    #11): the attention of :func:`position_attention_batched_dist` over
    the halved squared distances ``|q_i - k_j|^2 / 2`` of ``coords_q`` (B,
    L_out, d) and ``coords_k`` (B, L_in, d), which never reach device
    memory. ``thr`` (B, L_out, 1): thresholds on the halved distances;
    ``band``: a :class:`BandSpec` (needs ``thr``). The halving is folded
    into the scale (0.5 s) and the thresholds (2 thr), and the wrap margin
    appended to the keys and values, before :class:`PosAttTFCoord`, so
    that autograd chains the scale's gradient through the 0.5 and routes
    the duplicated value gradients back through the concat."""
    if coords_q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {coords_q.device}")
    if band is not None and thr is None:
        raise ValueError(
            "a band needs precomputed thresholds: its starts hold only for "
            "the thresholds they were computed from"
        )
    if band is not None and band.wrap:
        coords_k = torch.cat([coords_k, coords_k[:, : band.wrap]], dim=1)
        values = torch.cat([values, values[:, : band.wrap]], dim=1)
    scale = 0.5 * scales
    thr = None if thr is None else 2.0 * thr
    starts, width = (None, 0) if band is None else (band.starts, band.width)
    if _needs_grad(scale, values):
        return PosAttTFCoord.apply(coords_q, coords_k, scale, values, thr, starts, width)
    if coords_q.device.type == "cuda":
        return posatt_tf_coord_cuda(coords_q, coords_k, scale, values, thr, starts, width=width)
    _check_tf_coord(coords_q, coords_k, scale, values, thr, starts, width)
    return posatt_tf_coord_reference(coords_q, coords_k, scale, values, thr, starts, width=width)
