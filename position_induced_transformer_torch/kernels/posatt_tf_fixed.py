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

Two hand-written sm_90a sources: ``csrc/posatt_tf_fixed_fwd.cu`` (a
pre-pass that writes the row statistics m and l, (H, 2, L_out), and for a
local op the kept-step lists, then the forward) and
``csrc/posatt_tf_fixed_bwd.cu`` (the gradients of the scales, (H,) summed
over the batch, and of the values). The kernels contract over the listed
16-wide steps only (:class:`KeptSteps`). Dispatch is by device: a CUDA
tensor launches the kernel or raises, a CPU tensor takes the plain version
(``*_reference``). There is no fallback and no switch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.autograd.function import once_differentiable

from position_induced_transformer_torch.kernels.posatt_pallas import _check_tensors, _entry, _launch
from position_induced_transformer_torch.ops.locality import quantile_threshold

KINDS = {"tan_sin": 0, "square": 0, "tan": 1}  # bandwidth -> the kernels' keep mode
_BLOCK = 128  # rows and columns of the kernels' tiles
_STEP = 16  # depth of the kernels' steps, and the lists' granularity
_FULL = 264  # two blocks a SM: a launch of fewer splits its reduction axis


class KeptSteps(NamedTuple):
    """The kept-step lists of a local op, per head (``csrc/posatt_tf_fixed.cuh``):
    each list ascending, -1 after its count.

    - ``fwd_idx`` (H, nF, nT), ``fwd_cnt`` (H, nF): for each tile of
      ``fwd_tile`` rows (the forward's blocks), the 16-column steps holding
      a kept entry of one of its rows (every step where one of its rows
      keeps nothing);
    - ``dv_idx`` (H, nD, nU), ``dv_cnt`` (H, nD): for each tile of
      ``dv_tile`` columns (dv's blocks), the 16-row steps holding a kept
      entry in its columns or a row that keeps nothing;
    - ``tiles`` (H, nI, nJ): 1 where a 128 x 128 tile keeps an entry;

    nF = ceil(L_out / fwd_tile), nU = ceil(L_out / 16), nI = ceil(L_out /
    128); nD, nT and nJ the same of L_in. The tensors are int32."""

    fwd_idx: torch.Tensor
    fwd_cnt: torch.Tensor
    dv_idx: torch.Tensor
    dv_cnt: torch.Tensor
    tiles: torch.Tensor
    fwd_tile: int = _BLOCK
    dv_tile: int = _BLOCK

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


def _compact(flags):
    """Each row of the bool ``flags`` (..., n) as its true indices,
    ascending, -1 after them; and their counts."""
    n = flags.shape[-1]
    pos = torch.arange(n, dtype=torch.int32, device=flags.device).expand_as(flags)
    idx = torch.where(flags, pos, n).sort(dim=-1).values
    return torch.where(idx < n, idx, -1), flags.sum(-1, dtype=torch.int32)


def posatt_tf_fixed_lists_reference(dist, thr, scale, mode, fwd_tile=_BLOCK,
                                    dv_tile=_BLOCK) -> Optional[KeptSteps]:
    """Plain version of the kept-step lists that the forward's pre-pass
    writes (:class:`KeptSteps`) for blocks of ``fwd_tile`` rows and dv's
    of ``dv_tile`` columns (128, 64 or 32); None for a global op (``thr``
    None), which walks every step."""
    if thr is None:
        return None
    _, keep = _scaled_keep(dist, thr, scale, mode)
    H, L_out, L_in = keep.shape
    nU, nT = -(-L_out // _STEP), -(-L_in // _STEP)
    nI, nJ = -(-L_out // _BLOCK), -(-L_in // _BLOCK)
    empty = ~keep.any(-1)  # (H, L_out): rows that keep nothing
    pad = torch.zeros((H, nI * _BLOCK, nJ * _BLOCK), dtype=torch.bool, device=dist.device)
    pad[:, :L_out, :L_in] = keep
    blocks = pad.reshape(H, nI * 8, _STEP, nJ * 8, _STEP).any(-1).any(2)  # (H, 8 nI, 8 nJ)
    epad = torch.zeros((H, nI * _BLOCK), dtype=torch.bool, device=dist.device)
    epad[:, :L_out] = empty
    f, d = fwd_tile // _STEP, dv_tile // _STEP  # 16-wide blocks a tile
    nF, nD = -(-L_out // fwd_tile), -(-L_in // dv_tile)
    fwd = blocks.reshape(H, nI * 8 // f, f, nJ * 8).any(2)[:, :nF, :nT]
    fwd |= epad.reshape(H, nI * 8 // f, fwd_tile).any(-1, keepdim=True)[:, :nF]
    dv = blocks.reshape(H, nI * 8, nJ * 8 // d, d).any(-1)[:, :nU, :nD].transpose(1, 2)
    dv = dv | epad.reshape(H, nI * 8, _STEP).any(-1)[:, None, :nU]
    tiles = blocks.reshape(H, nI, 8, nJ, 8).any(-1).any(2)
    fwd_idx, fwd_cnt = _compact(fwd)
    dv_idx, dv_cnt = _compact(dv)
    return KeptSteps(fwd_idx, fwd_cnt, dv_idx, dv_cnt, tiles.to(torch.int32), fwd_tile, dv_tile)


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


def _col_plan(B, V):
    """``col_plan`` of ``csrc/posatt_tf_fixed.cuh``: samples and value
    columns of a column tile, the tiles of a head and of a row block."""
    bt = min(B, 8)
    cw = min(_BLOCK // bt, V)
    nct = -(-V // cw)
    cw = -(-V // nct)
    return bt, cw, nct, -(-B // bt) * nct


def _row_tile(B, rows, H, V):
    """Rows a forward block owns (columns a dv block): 128, or 64 or 32
    where 128-row blocks would be fewer than two a SM. Each output still
    sums its terms in one thread, in order: the tile changes no bit."""
    tiles = _col_plan(B, V)[3] * H
    return next((bm for bm in (128, 64) if -(-rows // bm) * tiles >= _FULL), 32)


def _split_plan(B, rows, K, H, V):
    """How the forward (rows L_out, reduction ``K`` = L_in) or dv (rows L_in,
    reduction L_out) cuts its reduction: ``(splits, chunk)``, ranges of
    ``chunk`` 16-wide steps, each block walking the listed steps of its
    range. A launch of fewer than two blocks a SM takes up to enough splits
    to fill the card, each at least 512 long (a shorter reduction is left
    whole: a split changes the order of its sums)."""
    blocks = -(-rows // _BLOCK) * _col_plan(B, V)[3] * H
    splits = max(1, min(-(-_FULL // blocks), K // 512))
    chunk = -(-(-(-K // splits)) // _STEP)  # ceil(ceil(K / splits) / 16) steps
    return -(-K // (chunk * _STEP)), chunk


def _dscale_plan(B, L_out, L_in, H, V):
    """``(splits, kchunk)``: the B*V contraction of dscale cut into ranges
    of ``kchunk`` (a multiple of 16, at least 64) until a launch has two
    blocks a SM."""
    K = B * V
    blocks = -(-L_out // _BLOCK) * -(-L_in // _BLOCK) * H
    splits = max(1, min(-(-_FULL // blocks), -(-K // 64)))
    kchunk = -(-K // splits)
    kchunk = -(-kchunk // _STEP) * _STEP
    return -(-K // kchunk), kchunk


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _vec_cols(B, V, *ts) -> int:
    """Whether value (or cotangent) columns go in 16-byte fours."""
    return int(V % 4 == 0 and _col_plan(B, V)[1] % 4 == 0 and _aligned(*ts))


def _partials(splits, B, rows, HV, device):
    if splits == 1:
        return None
    return torch.empty((splits, B, rows, HV), dtype=torch.float32, device=device)


def _lists_cuda(dist, thr, scale, mode, fwd_tile, dv_tile):
    """The forward's pre-pass: ``(stats, steps)``, the row statistics (H,
    2, L_out) of :func:`posatt_tf_fixed_stats_reference` and the
    :class:`KeptSteps` of :func:`posatt_tf_fixed_lists_reference` for its
    own and dv's tiles (None for a global op)."""
    L_out, L_in = dist.shape
    H, dev = scale.shape[0], dist.device
    stats = torch.empty((H, 2, L_out), dtype=torch.float32, device=dev)
    steps = bits = None
    if thr is not None:
        nU, nT = -(-L_out // _STEP), -(-L_in // _STEP)
        nI, nJ = -(-L_out // _BLOCK), -(-L_in // _BLOCK)
        nF, nD = -(-L_out // fwd_tile), -(-L_in // dv_tile)
        ints = lambda *shape: torch.empty(shape, dtype=torch.int32, device=dev)
        bits = ints(H, nU, -(-nT // 32))
        steps = KeptSteps(ints(H, nF, nT), ints(H, nF), ints(H, nD, nU), ints(H, nD),
                          ints(H, nI, nJ), fwd_tile, dv_tile)
    fn = _entry("posatt_tf_fixed_fwd", "posatt_tf_fixed_plan", 10, 6)
    _launch(fn, "posatt_tf_fixed_plan", dev, dist, thr, scale, stats, bits,
            *(steps[:5] if steps else (None,) * 5), L_out, L_in, H, mode, fwd_tile, dv_tile)
    return stats, steps


def posatt_tf_fixed_cuda(dist, thr, scale, values, mode):
    """Launch the forward on CUDA tensors: ``(out, stats, steps)``, out (B,
    L_out, H*V), the row statistics (H, 2, L_out) of
    :func:`posatt_tf_fixed_stats_reference` and the :class:`KeptSteps` it
    walked (None for a global op), which the backward entry points take. Arguments as
    :func:`posatt_tf_fixed_reference`'s. Adds one to
    ``posatt_tf_fixed_cuda.launches`` for each launch."""
    _check(dist, thr, scale, values)
    _check_cuda("posatt_tf_fixed_cuda", dist)
    L_out, L_in = dist.shape
    B, H = values.shape[0], scale.shape[0]
    dev = dist.device
    V = values.shape[2] // H
    tile = _row_tile(B, L_out, H, V)
    stats, steps = _lists_cuda(dist, thr, scale, mode, tile, _row_tile(B, L_in, H, V))
    out = torch.empty((B, L_out, values.shape[2]), dtype=torch.float32, device=dev)
    splits, chunk = _split_plan(B, L_out, L_in, H, V)
    part = _partials(splits, B, L_out, H * V, dev)
    fn = _entry("posatt_tf_fixed_fwd", "posatt_tf_fixed_fwd", 9, 11)
    _launch(fn, "posatt_tf_fixed_fwd", dev, dist, thr, scale, values, stats,
            *(steps[:2] if steps else (None, None)), out, part, B, L_out, L_in, H, V, mode,
            tile, splits, chunk, int(L_in % 4 == 0 and _aligned(dist)), _vec_cols(B, V, values))
    posatt_tf_fixed_cuda.launches += 1
    return out, stats, steps


def posatt_tf_fixed_bwd_dscale_cuda(dist, thr, scale, values, out, g, stats, mode, steps=None):
    """Launch the dscale entry point: (H,), from the forward's inputs, its
    output ``out``, row statistics and lists ``steps`` (None: every tile,
    the same bits) and a cotangent ``g``. Deterministic: per-block partials
    summed per head in a fixed order. Adds one to
    ``posatt_tf_fixed_bwd_dscale_cuda.launches``."""
    B, L_out, L_in, H, V = _check_bwd("posatt_tf_fixed_bwd_dscale_cuda", dist, thr, scale, g,
                                      stats, values, out)
    dev = dist.device
    splits, kchunk = _dscale_plan(B, L_out, L_in, H, V)
    rvec = torch.empty((H, L_out), dtype=torch.float32, device=dev)
    blocks = -(-L_out // _BLOCK) * -(-L_in // _BLOCK)
    partial = torch.empty((H, splits * blocks), dtype=torch.float32, device=dev)
    ds = torch.empty((H,), dtype=torch.float32, device=dev)
    fn = _entry("posatt_tf_fixed_bwd", "posatt_tf_fixed_bwd_dscale", 11, 8)
    _launch(fn, "posatt_tf_fixed_bwd_dscale", dev, dist, thr, scale, values, out, g, stats,
            steps.tiles if steps else None, rvec, partial, ds, B, L_out, L_in, H, V, mode,
            splits, kchunk)
    posatt_tf_fixed_bwd_dscale_cuda.launches += 1
    return ds


def posatt_tf_fixed_bwd_dv_cuda(dist, thr, scale, g, stats, mode, steps=None):
    """Launch the dv entry point: (B, L_in, H*V), from the forward's row
    statistics and lists ``steps`` (None: every step, the same bits). Adds
    one to ``posatt_tf_fixed_bwd_dv_cuda.launches``."""
    B, L_out, L_in, H, V = _check_bwd("posatt_tf_fixed_bwd_dv_cuda", dist, thr, scale, g, stats)
    tile = _row_tile(B, L_in, H, V)
    if steps is not None and steps.dv_tile != tile:
        raise ValueError(f"steps are cut to {steps.dv_tile}-column tiles, dv runs {tile}")
    dev = dist.device
    dv = torch.empty((B, L_in, g.shape[2]), dtype=torch.float32, device=dev)
    splits, chunk = _split_plan(B, L_in, L_out, H, V)
    part = _partials(splits, B, L_in, H * V, dev)
    fn = _entry("posatt_tf_fixed_bwd", "posatt_tf_fixed_bwd_dv", 9, 11)
    _launch(fn, "posatt_tf_fixed_bwd_dv", dev, dist, thr, scale, g, stats,
            *(steps[2:4] if steps else (None, None)), dv, part, B, L_out, L_in, H, V, mode,
            tile, splits, chunk, int(L_in % 4 == 0 and _aligned(dist)), _vec_cols(B, V, g))
    posatt_tf_fixed_bwd_dv_cuda.launches += 1
    return dv


posatt_tf_fixed_cuda.launches = 0
posatt_tf_fixed_bwd_dscale_cuda.launches = 0
posatt_tf_fixed_bwd_dv_cuda.launches = 0


# ------------------------------------------------------------ autograd


class PosAttTFFixed(torch.autograd.Function):
    """The forward with its backward: ``apply(dist, thr, scale, values,
    mode)`` -> (B, L_out, H*V). The forward saves its output, row
    statistics and kept-step lists; the backward runs the dscale entry point when ``scale``
    needs a gradient and the dv one when ``values`` does; ``dist`` and
    ``thr`` get none. CPU tensors take the plain versions."""

    @staticmethod
    def forward(ctx, dist, thr, scale, values, mode):
        steps = None
        if dist.device.type == "cuda":
            out, stats, steps = posatt_tf_fixed_cuda(dist, thr, scale, values, mode)
        else:
            _check(dist, thr, scale, values)
            out, stats = posatt_tf_fixed_reference(dist, thr, scale, values, mode), None
        ctx.save_for_backward(dist, thr, scale, values, out, stats)
        ctx.mode, ctx.steps = mode, steps
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        dist, thr, scale, values, out, stats = ctx.saved_tensors
        g = g.contiguous()
        mode, cuda = ctx.mode, dist.device.type == "cuda"
        ds = dv = None
        if ctx.needs_input_grad[2]:
            ds = (posatt_tf_fixed_bwd_dscale_cuda(dist, thr, scale, values, out, g, stats, mode,
                                                  ctx.steps)
                  if cuda else
                  posatt_tf_fixed_bwd_dscale_reference(dist, thr, scale, values, out, g, mode))
            ds = ds.reshape(scale.shape)
        if ctx.needs_input_grad[3]:
            dv = (posatt_tf_fixed_bwd_dv_cuda(dist, thr, scale, g, stats, mode, ctx.steps) if cuda
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
