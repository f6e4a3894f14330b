"""Fixed-mesh TF-semantics position attention (#13): the CUDA kernels'
wrappers, their plain versions, and the autograd Function around them.

The JAX package computes this op on XLA, inside ``MultiHeadPosAtt``
(``models/pit_tf.py:129-160``): it has no Pallas kernel. It is every
attention op of the fixed-mesh TF family (burgers_tf, sod_tf, darcy_tf,
vorticity_tf, naca_tf). For head h of scale s (H scales of either sign),
over one (L_out, L_in) distance matrix ``dist`` that the whole batch
shares:

- ``t_hi``: the row's keep threshold, +inf without ``thr``; else for the
  ``tan_sin`` and ``square`` bandwidths ``thr[i, 0]`` (every head), and for
  ``tan`` ``s * thr[i, 0]`` where ``s >= 0``, else ``s * thr[i, 1]`` (the
  quantile at 1 - p: a negative scale reverses the order);
- ``keep_hij``: ``dist_ij <= t_hi``, or for ``tan`` ``s * dist_ij <= t_hi``
  (the two float32 products);
- ``att_hij = softmax_j(-s * dist_ij)`` over the kept entries, exactly 0
  elsewhere (JAX's float-max sentinel; a row that keeps nothing is uniform);
- ``out[b, i, h*V:(h+1)*V] = sum_j att_hij values[b, j, h*V:(h+1)*V]``.

Two hand-written sm_90a sources: ``csrc/posatt_tf_fixed_fwd.cu`` (the
forward, which also writes the row statistics m and l, (H, 2, L_out)) and
``csrc/posatt_tf_fixed_bwd.cu`` (the gradients of the scales, (H,) summed
over the batch, and of the values). Dispatch is by device: a CUDA tensor
launches the kernel or raises, a CPU tensor takes the plain version
(``*_reference``). There is no fallback and no switch.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from position_induced_transformer_torch.kernels.posatt_pallas import _check_tensors, _entry, _launch
from position_induced_transformer_torch.ops.locality import quantile_threshold

KINDS = {"tan_sin": 0, "square": 0, "tan": 1}  # bandwidth -> the kernels' keep mode
_BLOCK = 128  # rows and columns of the kernels' tiles
_FULL = 264  # two blocks a SM: a launch of fewer splits its reduction axis

# ------------------------------------------------------------ plain versions


def _mode(kind: str) -> int:
    try:
        return KINDS[kind]
    except KeyError:
        raise ValueError(f"unknown bandwidth kind {kind!r}; expected one of {sorted(KINDS)}") from None


def _scaled_keep(dist, thr, scale, mode):
    """``s * dist`` (H, L_out, L_in) and the keep mask (None: every entry)."""
    s = scale.reshape(-1, 1, 1)
    scaled = dist * s
    if thr is None:
        return scaled, None
    if mode == 0:
        return scaled, (dist <= thr[:, :1]).expand_as(scaled)
    t = torch.where(s >= 0, s * thr[:, :1], s * thr[:, 1:])
    return scaled, scaled <= t


def _attention(dist, thr, scale, mode):
    """The attention (H, L_out, L_in) as the JAX package computes it, and the
    keep mask (None: every entry)."""
    scaled, keep = _scaled_keep(dist, thr, scale, mode)
    if keep is not None:
        scaled = torch.where(keep, scaled, torch.finfo(torch.float32).max)
    return torch.softmax(-scaled, dim=-1), keep


def _apply(att, values):
    """Head h's weights on head h's value columns: (B, L_out, H*V)."""
    H, L_out, L_in = att.shape
    v = values.reshape(values.shape[0], L_in, H, -1)
    return torch.einsum("hij,bjhv->bihv", att, v).reshape(values.shape[0], L_out, -1)


def posatt_tf_fixed_reference(dist, thr, scale, values, mode):
    """Plain PyTorch version of the forward: (B, L_out, H*V) from ``dist``
    (L_out, L_in), ``thr`` (L_out, 2) or None, ``scale`` (H, 1) of either
    sign, ``values`` (B, L_in, H*V) and the keep ``mode`` (0: tan_sin and
    square, 1: tan)."""
    return _apply(_attention(dist, thr, scale, mode)[0], values)


def posatt_tf_fixed_stats_reference(dist, thr, scale, mode):
    """Plain version of the row statistics the forward kernel writes, (H,
    2, L_out): per head and row, m (the smallest kept ``s * dist``, +inf
    where the row keeps nothing) and l (the sum of ``exp(m - s * dist)``
    over the kept entries, ``L_in`` where it keeps nothing)."""
    scaled, keep = _scaled_keep(dist, thr, scale, mode)
    keep = torch.ones_like(scaled, dtype=torch.bool) if keep is None else keep
    inf = torch.tensor(float("inf"), device=dist.device)
    m = torch.where(keep, scaled, inf).amin(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(m - scaled), 0.0)
    empty = torch.isinf(m)
    l = torch.where(empty, float(dist.shape[1]), p.sum(dim=-1, keepdim=True))
    return torch.cat([m, l], dim=-1).transpose(1, 2).contiguous()


def posatt_tf_fixed_bwd_dv_reference(dist, thr, scale, g, mode):
    """Plain version of the dv entry point: (B, L_in, H*V) for a cotangent
    ``g`` (B, L_out, H*V) of the forward's output."""
    att, _ = _attention(dist, thr, scale, mode)
    H, L_out, L_in = att.shape
    gh = g.reshape(g.shape[0], L_out, H, -1)
    return torch.einsum("hij,bihv->bjhv", att, gh).reshape(g.shape[0], L_in, -1)


def posatt_tf_fixed_bwd_dscale_reference(dist, thr, scale, values, out, g, mode):
    """Plain version of the dscale entry point: (H,), summed over the batch.
    With ``T_hij = sum_bv g[b,i,h,v] values[b,j,h,v]`` and ``r_hi =
    sum_bv g[b,i,h,v] out[b,i,h,v]`` (``out`` the forward's output),
    ``ds_h = -sum_ij keep att (T - r) dist``: no gradient through the mask."""
    att, keep = _attention(dist, thr, scale, mode)
    H, L_out, L_in = att.shape
    B = g.shape[0]
    gh = g.reshape(B, L_out, H, -1)
    t = torch.einsum("bihv,bjhv->hij", gh, values.reshape(B, L_in, H, -1))
    r = torch.einsum("bihv,bihv->hi", gh, out.reshape(B, L_out, H, -1))
    d = dist if keep is None else torch.where(keep, dist, 0.0)
    return -(att * (t - r[..., None]) * d).sum(dim=(-1, -2))


# ------------------------------------------------------------ CUDA launchers


def _check_dist(dist, thr, scale) -> None:
    named = [("dist", dist), ("scale", scale)] + ([("thr", thr)] if thr is not None else [])
    _check_tensors(named, dist.device)
    if dist.ndim != 2:
        raise ValueError(f"dist must be (L_out, L_in), got {tuple(dist.shape)}")
    if scale.ndim != 2 or scale.shape[1] != 1 or scale.shape[0] < 1:
        raise ValueError(f"scale must be (H, 1), got {tuple(scale.shape)}")
    if thr is not None and tuple(thr.shape) != (dist.shape[0], 2):
        raise ValueError(f"thr must be ({dist.shape[0]}, 2), got {tuple(thr.shape)}")


def _check_heads(name, t, rows, H, device) -> None:
    """``t`` must be a float32 (B, rows, H*V) on ``device``."""
    _check_tensors([(name, t)], device)
    if t.ndim != 3 or t.shape[1] != rows or t.shape[2] % H:
        raise ValueError(f"{name} must be (B, {rows}, H*V) with H = {H}, got {tuple(t.shape)}")


def _check(dist, thr, scale, values) -> None:
    _check_dist(dist, thr, scale)
    _check_heads("values", values, dist.shape[1], scale.shape[0], dist.device)


def _check_cuda(name, t) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {t.device}")


def _check_bwd(name, dist, thr, scale, g, stats, values=None, out=None):
    """The backward launchers' arguments: (B, L_out, L_in, H, V)."""
    _check_dist(dist, thr, scale)
    _check_cuda(name, dist)
    L_out, L_in = dist.shape
    H = scale.shape[0]
    named = [("stats", stats)] + ([("values", values), ("out", out)] if values is not None else [])
    _check_tensors(named, dist.device)
    _check_heads("g", g, L_out, H, dist.device)
    B, HV = g.shape[0], g.shape[2]
    if values is not None and tuple(values.shape) != (B, L_in, HV):
        raise ValueError(f"values must be ({B}, {L_in}, {HV}), got {tuple(values.shape)}")
    if out is not None and out.shape != g.shape:
        raise ValueError(f"out must be {tuple(g.shape)} as g, got {tuple(out.shape)}")
    if tuple(stats.shape) != (H, 2, L_out):
        raise ValueError(f"stats must be ({H}, 2, {L_out}), got {tuple(stats.shape)}")
    return B, L_out, L_in, H, HV // H


def _split_plan(B, rows, K, H, V):
    """How the forward (rows L_out, reduction L_in) or dv (rows L_in,
    reduction L_out) splits its reduction axis: ``(splits, kchunk)``, as
    ``csrc/posatt_tf_fixed.cuh`` reads them. A launch of fewer than two
    blocks a SM takes up to enough splits to fill the card, each at least
    512 long (kchunk a multiple of the 8-deep step)."""
    bt = min(B, 8)
    cw = min(_BLOCK // bt, V)
    nct = -(-V // cw)
    blocks = -(-rows // _BLOCK) * -(-B // bt) * nct * H
    splits = max(1, min(-(-_FULL // blocks), K // 512))
    kchunk = -(-K // splits)
    kchunk = -(-kchunk // 8) * 8
    return -(-K // kchunk), kchunk


def _partials(splits, B, rows, HV, device):
    if splits == 1:
        return None
    return torch.empty((splits, B, rows, HV), dtype=torch.float32, device=device)


def posatt_tf_fixed_cuda(dist, thr, scale, values, mode):
    """Launch the forward on CUDA tensors: ``(out, stats)``, out (B, L_out,
    H*V) and the row statistics (H, 2, L_out) of
    :func:`posatt_tf_fixed_stats_reference`. Arguments as
    :func:`posatt_tf_fixed_reference`'s. Adds one to
    ``posatt_tf_fixed_cuda.launches`` for each launch."""
    _check(dist, thr, scale, values)
    _check_cuda("posatt_tf_fixed_cuda", dist)
    L_out, L_in = dist.shape
    B, H = values.shape[0], scale.shape[0]
    dev = dist.device
    out = torch.empty((B, L_out, values.shape[2]), dtype=torch.float32, device=dev)
    stats = torch.empty((H, 2, L_out), dtype=torch.float32, device=dev)
    V = values.shape[2] // H
    splits, kchunk = _split_plan(B, L_out, L_in, H, V)
    part = _partials(splits, B, L_out, H * V, dev)
    fn = _entry("posatt_tf_fixed_fwd", "posatt_tf_fixed_fwd", 7, 8)
    _launch(fn, "posatt_tf_fixed_fwd", dev, dist, thr, scale, values, out, stats, part,
            B, L_out, L_in, H, V, mode, splits, kchunk)
    posatt_tf_fixed_cuda.launches += 1
    return out, stats


def posatt_tf_fixed_bwd_dscale_cuda(dist, thr, scale, values, out, g, stats, mode):
    """Launch the dscale entry point: (H,), from the forward's inputs, its
    output ``out`` and row statistics and a cotangent ``g``. Deterministic:
    per-block partials summed per head in a fixed order. Adds one to
    ``posatt_tf_fixed_bwd_dscale_cuda.launches``."""
    B, L_out, L_in, H, V = _check_bwd("posatt_tf_fixed_bwd_dscale_cuda", dist, thr, scale, g,
                                      stats, values, out)
    dev = dist.device
    rvec = torch.empty((H, L_out), dtype=torch.float32, device=dev)
    blocks = -(-L_out // _BLOCK) * -(-L_in // _BLOCK)
    partial = torch.empty((H, blocks), dtype=torch.float32, device=dev)
    ds = torch.empty((H,), dtype=torch.float32, device=dev)
    fn = _entry("posatt_tf_fixed_bwd", "posatt_tf_fixed_bwd_dscale", 10, 6)
    _launch(fn, "posatt_tf_fixed_bwd_dscale", dev, dist, thr, scale, values, out, g, stats,
            rvec, partial, ds, B, L_out, L_in, H, V, mode)
    posatt_tf_fixed_bwd_dscale_cuda.launches += 1
    return ds


def posatt_tf_fixed_bwd_dv_cuda(dist, thr, scale, g, stats, mode):
    """Launch the dv entry point: (B, L_in, H*V). Adds one to
    ``posatt_tf_fixed_bwd_dv_cuda.launches``."""
    B, L_out, L_in, H, V = _check_bwd("posatt_tf_fixed_bwd_dv_cuda", dist, thr, scale, g, stats)
    dv = torch.empty((B, L_in, g.shape[2]), dtype=torch.float32, device=dist.device)
    splits, kchunk = _split_plan(B, L_in, L_out, H, V)
    part = _partials(splits, B, L_in, H * V, dist.device)
    fn = _entry("posatt_tf_fixed_bwd", "posatt_tf_fixed_bwd_dv", 7, 8)
    _launch(fn, "posatt_tf_fixed_bwd_dv", dist.device, dist, thr, scale, g, stats, dv, part,
            B, L_out, L_in, H, V, mode, splits, kchunk)
    posatt_tf_fixed_bwd_dv_cuda.launches += 1
    return dv


posatt_tf_fixed_cuda.launches = 0
posatt_tf_fixed_bwd_dscale_cuda.launches = 0
posatt_tf_fixed_bwd_dv_cuda.launches = 0


# ------------------------------------------------------------ autograd


class PosAttTFFixed(torch.autograd.Function):
    """The forward with its backward: ``apply(dist, thr, scale, values,
    mode)`` -> (B, L_out, H*V). The forward saves its output and row
    statistics; the backward runs the dscale entry point when ``scale``
    needs a gradient and the dv one when ``values`` does; ``dist`` and
    ``thr`` get none. CPU tensors take the plain versions."""

    @staticmethod
    def forward(ctx, dist, thr, scale, values, mode):
        if dist.device.type == "cuda":
            out, stats = posatt_tf_fixed_cuda(dist, thr, scale, values, mode)
        else:
            _check(dist, thr, scale, values)
            out, stats = posatt_tf_fixed_reference(dist, thr, scale, values, mode), None
        ctx.save_for_backward(dist, thr, scale, values, out, stats)
        ctx.mode = mode
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        dist, thr, scale, values, out, stats = ctx.saved_tensors
        g = g.contiguous()
        mode, cuda = ctx.mode, dist.device.type == "cuda"
        ds = dv = None
        if ctx.needs_input_grad[2]:
            ds = (posatt_tf_fixed_bwd_dscale_cuda(dist, thr, scale, values, out, g, stats, mode)
                  if cuda else
                  posatt_tf_fixed_bwd_dscale_reference(dist, thr, scale, values, out, g, mode))
            ds = ds.reshape(scale.shape)
        if ctx.needs_input_grad[3]:
            dv = (posatt_tf_fixed_bwd_dv_cuda(dist, thr, scale, g, stats, mode) if cuda
                  else posatt_tf_fixed_bwd_dv_reference(dist, thr, scale, g, mode))
        return None, None, ds, dv, None


def percentile_thresholds(dist: torch.Tensor, locality: float) -> Optional[torch.Tensor]:
    """The (L_out, 2) quantiles at p and 1 - p of each row of ``dist``, p =
    ``locality`` / 100; None for a global ``locality`` (above 100)."""
    if locality > 100:
        return None
    p = locality / 100.0
    return torch.cat([quantile_threshold(dist, p), quantile_threshold(dist, 1.0 - p)], dim=-1)


def position_attention_tf_fixed(
    dist: torch.Tensor,
    thr: Optional[torch.Tensor],
    scales: torch.Tensor,
    values: torch.Tensor,
    kind: str,
    locality: float,
) -> torch.Tensor:
    """TF-semantics position attention over one distance matrix the batch
    shares: ``dist`` (L_out, L_in), ``scales`` (H, 1) of either sign (the
    bandwidth of kind ``kind`` applied to r, outside, so that autograd
    chains through it), per-head ``values`` (B, L_in, H*V) -> (B, L_out,
    H*V). ``locality``: a percentile, above 100 global (``thr`` is then
    ignored); ``thr`` (L_out, 2): the quantiles at p and 1 - p of each row,
    computed here from ``dist`` where a local op has none (the JAX
    package's in-call quantile of the scaled distances, up to rounding).
    Differentiable in ``scales`` and ``values`` through
    :class:`PosAttTFFixed`; without a gradient only the forward kernel
    runs."""
    if dist.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dist.device}")
    mode = _mode(kind)
    if locality > 100:
        thr = None
    elif thr is None:
        thr = percentile_thresholds(dist, locality)
    if torch.is_grad_enabled() and (scales.requires_grad or values.requires_grad):
        return PosAttTFFixed.apply(dist, thr, scales, values, mode)
    if dist.device.type == "cuda":
        return posatt_tf_fixed_cuda(dist, thr, scales, values, mode)[0]
    _check(dist, thr, scales, values)
    return posatt_tf_fixed_reference(dist, thr, scales, values, mode)
