"""Dot-product attention (#14): the CUDA kernels' wrappers, their plain
versions, and the autograd Function around them.

The JAX package computes this attention on XLA, inside
``MultiHeadSelfAtt`` (``models/pit_tf.py:163-196``) and
``SelfMultiHeadPosAtt`` (``:198-267``): it has no Pallas kernel. It is
every ``self`` and ``hybrid`` attention op of the TF family's ablation
variants (``lite``, ``transformer``, ``selfpit``). For head h, with
``q``, ``k``, ``v`` (B, L, H, V) and ``sd`` the float32 square root of V:

- ``x_ij = (q_i . k_j) / sd`` (``self``), the division rounded as JAX's;
- ``hybrid``: minus ``s_ij = dist_ij * scale_h`` of one (L, L) distance
  matrix the batch shares; with thresholds ``thr`` (H, L), an entry with
  ``s_ij > thr[h, i]`` takes the logit ``-f32 max`` (JAX subtracts its f32
  max sentinel): weight 0, and a row that keeps nothing is uniform;
- ``out[b, i, h*V:(h+1)*V] = sum_j softmax_j(x) v_j``, (B, L, H*V): JAX's
  ``transpose(0, 2, 1, 3).reshape(B, L, hid)``.

Two hand-written sm_90a sources: ``csrc/dotatt_fwd.cu`` (the forward,
writing each row's max m and sum l, (2, B, H, L)) and
``csrc/dotatt_bwd.cu`` (dq with each row's ``delta = sum g * out`` and,
hybrid, dscale (H,); then dk and dv, which read delta). Their products run
on the tensor cores as 3xTF32 (``mma.sync`` with each float32 operand split
into two TF32 halves; ``csrc/dotatt.cuh``). Dispatch is by
device: a CUDA tensor launches the kernel or raises, a CPU tensor takes the
plain version (``*_reference``). There is no fallback and no switch.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from position_induced_transformer_torch.kernels import _build
from position_induced_transformer_torch.kernels.posatt_pallas import _check_tensors, _launch

_WIDTHS = (16, 32, 64, 128, 256)  # the kernels' padded head widths
_F32_MAX = torch.finfo(torch.float32).max


def head_scale(V: int) -> float:
    """The float32 square root of the head width, by which JAX divides
    the logits (``v_dim ** 0.5`` rounded once to float32)."""
    return float(np.float32(math.sqrt(V)))


# ------------------------------------------------------------ plain versions


def _logits(q, k, dist, thr, scale):
    """The logits (B, H, L, L) and the keep mask (H, L, L; None: every
    entry), as the JAX package computes them."""
    V = q.shape[-1]
    x = torch.einsum("bihd,bjhd->bhij", q, k) / torch.tensor(head_scale(V), dtype=q.dtype,
                                                             device=q.device)
    if dist is None:
        return x, None
    scaled = dist * scale.reshape(-1, 1, 1)
    keep = None
    if thr is not None:
        keep = scaled <= thr[:, :, None]
        scaled = torch.where(keep, scaled, _F32_MAX)
    return x - scaled[None], keep


def _weights(q, k, dist, thr, scale):
    x, keep = _logits(q, k, dist, thr, scale)
    return torch.softmax(x, dim=-1), keep


def _heads_out(att, v):
    """(B, H, L, L) weights on (B, L, H, V) values -> (B, L, H*V)."""
    B, L, H, V = v.shape
    return torch.einsum("bhij,bjhd->bihd", att, v).reshape(B, L, H * V)


def dotatt_reference(q, k, v, dist=None, thr=None, scale=None):
    """Plain PyTorch version of the forward: (B, L, H*V) from ``q``, ``k``,
    ``v`` (B, L, H, V); hybrid with ``dist`` (L, L) and ``scale`` (H,),
    local with ``thr`` (H, L)."""
    return _heads_out(_weights(q, k, dist, thr, scale)[0], v)


def dotatt_stats_reference(q, k, dist=None, thr=None, scale=None):
    """Plain version of the row statistics the forward writes, (2, B, H,
    L): each row's largest logit m and ``sum_j exp(x_ij - m)``."""
    x, _ = _logits(q, k, dist, thr, scale)
    m = x.amax(dim=-1)
    return torch.stack([m, torch.exp(x - m[..., None]).sum(-1)])


def _ds(q, k, v, g, dist, thr, scale):
    """The logits' gradient (B, H, L, L), its weights and keep mask."""
    B, L, H, V = v.shape
    att, keep = _weights(q, k, dist, thr, scale)
    gh = g.reshape(B, L, H, V)
    dp = torch.einsum("bihd,bjhd->bhij", gh, v)
    delta = (gh * _heads_out(att, v).reshape(B, L, H, V)).sum(-1).transpose(1, 2)  # (B, H, L)
    return att * (dp - delta[..., None]), att, keep


def dotatt_bwd_delta_reference(out, g, H):
    """Plain version of the rows' ``delta = sum_c g out``, (B, H, L), which
    the dq kernel writes for dk and dv."""
    B, L, HV = out.shape
    return (g.reshape(B, L, H, -1) * out.reshape(B, L, H, -1)).sum(-1).transpose(1, 2).contiguous()


def dotatt_bwd_dq_reference(q, k, v, g, dist=None, thr=None, scale=None):
    """Plain version of dq, (B, L, H*V), for a cotangent ``g`` (B, L,
    H*V) of the forward's output."""
    B, L, H, V = q.shape
    ds, _, _ = _ds(q, k, v, g, dist, thr, scale)
    return (torch.einsum("bhij,bjhd->bihd", ds, k) / head_scale(V)).reshape(B, L, H * V)


def dotatt_bwd_dk_reference(q, k, v, g, dist=None, thr=None, scale=None):
    """Plain version of dk, (B, L, H*V)."""
    B, L, H, V = q.shape
    ds, _, _ = _ds(q, k, v, g, dist, thr, scale)
    return (torch.einsum("bhij,bihd->bjhd", ds, q) / head_scale(V)).reshape(B, L, H * V)


def dotatt_bwd_dv_reference(q, k, v, g, dist=None, thr=None, scale=None):
    """Plain version of dv, (B, L, H*V)."""
    B, L, H, V = q.shape
    att, _ = _weights(q, k, dist, thr, scale)
    return torch.einsum("bhij,bihd->bjhd", att, g.reshape(B, L, H, V)).reshape(B, L, H * V)


def dotatt_bwd_dscale_reference(q, k, v, g, dist, thr=None, scale=None):
    """Plain version of the hybrid's dscale, (H,): ``-sum ds dist`` over
    the kept entries and the batch (the mask gets no gradient)."""
    ds, _, keep = _ds(q, k, v, g, dist, thr, scale)
    d = dist if keep is None else torch.where(keep, dist, 0.0)
    return -(ds * d).sum(dim=(0, 2, 3))


def dotatt_bwd_term_sizes(q, k, v, g, dist=None, thr=None, scale=None):
    """The size of the terms each of dq, dk and dv sums, (B, L, H*V) each:
    the plain backward with every term taken by its magnitude (``|ds|``,
    ``|q|``, ``|k|``, ``|g|``). Their float32 rounding scales with these,
    not with the (cancelled) sums: the bound a kernel is held to."""
    B, L, H, V = q.shape
    att, _ = _weights(q, k, dist, thr, scale)
    gh = g.reshape(B, L, H, V)
    dp = torch.einsum("bihd,bjhd->bhij", gh, v)
    delta = (gh * _heads_out(att, v).reshape(B, L, H, V)).sum(-1).transpose(1, 2)
    ds = att * (dp - delta[..., None]).abs()
    sd = head_scale(V)
    return ((torch.einsum("bhij,bjhd->bihd", ds, k.abs()) / sd).reshape(B, L, H * V),
            (torch.einsum("bhij,bihd->bjhd", ds, q.abs()) / sd).reshape(B, L, H * V),
            torch.einsum("bhij,bihd->bjhd", att, gh.abs()).reshape(B, L, H * V))


# ------------------------------------------------------------ CUDA launchers


def _entry(name: str, n_ptr: int, n_int: int):
    """A C entry point of the #14 libraries: ``n_ptr`` pointers, ``n_int``
    ints, the float ``sd``, then the stream; built and loaded at first
    use."""
    lib = "dotatt_fwd" if name == "dotatt_fwd" else "dotatt_bwd"
    fn = getattr(_build.load(lib), name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _width(V: int) -> int:
    for vp in _WIDTHS:
        if V <= vp:
            return vp
    raise ValueError(f"head width {V} is above the kernels' largest, {_WIDTHS[-1]}")


def _check(q, k, v, dist, thr, scale) -> Tuple[int, int, int, int]:
    """The arguments' shapes and types: (B, L, H, V)."""
    named = [("q", q), ("k", k), ("v", v)]
    named += [(n, t) for n, t in (("dist", dist), ("thr", thr), ("scale", scale)) if t is not None]
    _check_tensors(named, q.device)
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k and v must be (B, L, H, V) alike, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    B, L, H, V = q.shape
    if dist is None:
        if thr is not None or scale is not None:
            raise ValueError("thr and scale need dist (hybrid attention)")
        return B, L, H, V
    if tuple(dist.shape) != (L, L):
        raise ValueError(f"dist must be ({L}, {L}), got {tuple(dist.shape)}")
    if scale is None or tuple(scale.shape) != (H,):
        raise ValueError(f"scale must be ({H},), got {None if scale is None else tuple(scale.shape)}")
    if thr is not None and tuple(thr.shape) != (H, L):
        raise ValueError(f"thr must be ({H}, {L}), got {tuple(thr.shape)}")
    return B, L, H, V


def _check_cuda(name, t) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {t.device}")


def _vec(*ts) -> int:
    """16-byte copies: every tensor 16-byte aligned and V % 4 == 0."""
    return int(ts[0].shape[-1] % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in ts))


def dotatt_cuda(q, k, v, dist=None, thr=None, scale=None):
    """Launch the forward on CUDA tensors: ``(out, stats)``, out (B, L,
    H*V) and the row statistics (2, B, H, L) of
    :func:`dotatt_stats_reference`. Arguments as :func:`dotatt_reference`'s.
    Adds one to ``dotatt_cuda.launches``."""
    B, L, H, V = _check(q, k, v, dist, thr, scale)
    _check_cuda("dotatt_cuda", q)
    dev = q.device
    out = torch.empty((B, L, H * V), dtype=torch.float32, device=dev)
    stats = torch.empty((2, B, H, L), dtype=torch.float32, device=dev)
    _launch(_entry("dotatt_fwd", 8, 6), "dotatt_fwd", dev, q, k, v, dist, thr, scale, out, stats,
            B, L, H, V, _width(V), _vec(q, k, v), head_scale(V))
    dotatt_cuda.launches += 1
    return out, stats


def _check_bwd(name, q, k, v, g, stats, dist, thr, scale, out=None, delta=None):
    B, L, H, V = _check(q, k, v, dist, thr, scale)
    _check_cuda(name, q)
    named = [("g", g), ("stats", stats)] + [(n, t) for n, t in (("out", out), ("delta", delta))
                                            if t is not None]
    _check_tensors(named, q.device)
    if tuple(g.shape) != (B, L, H * V) or (out is not None and out.shape != g.shape):
        raise ValueError(f"g and out must be ({B}, {L}, {H * V}), got {tuple(g.shape)}")
    if tuple(stats.shape) != (2, B, H, L):
        raise ValueError(f"stats must be (2, {B}, {H}, {L}), got {tuple(stats.shape)}")
    if delta is not None and tuple(delta.shape) != (B, H, L):
        raise ValueError(f"delta must be ({B}, {H}, {L}), got {tuple(delta.shape)}")
    return B, L, H, V


def dotatt_bwd_dq_cuda(q, k, v, out, g, stats, dist=None, thr=None, scale=None):
    """Launch the dq entry point: ``(dq, delta, dscale)`` from the
    forward's inputs, output ``out`` and row statistics, and a cotangent
    ``g`` (B, L, H*V): dq (B, L, H*V), the rows' delta (B, H, L) that
    :func:`dotatt_bwd_dkdv_cuda` reads, and for hybrid attention dscale
    (H,) (else None), summed over the batch in a fixed order. Adds one to
    ``dotatt_bwd_dq_cuda.launches``."""
    B, L, H, V = _check_bwd("dotatt_bwd_dq_cuda", q, k, v, g, stats, dist, thr, scale, out=out)
    dev, vp = q.device, _width(V)
    dq = torch.empty((B, L, H * V), dtype=torch.float32, device=dev)
    delta = torch.empty((B, H, L), dtype=torch.float32, device=dev)
    partial = ds = None
    if dist is not None:
        rows = _bwd_rows(vp)
        partial = torch.empty((H, -(-L // rows) * B), dtype=torch.float32, device=dev)
        ds = torch.empty((H,), dtype=torch.float32, device=dev)
    _launch(_entry("dotatt_bwd_dq", 13, 6), "dotatt_bwd_dq", dev, q, k, v, out, g, stats, dist,
            thr, scale, dq, delta, partial, ds, B, L, H, V, vp, _vec(q, k, v, out, g),
            head_scale(V))
    dotatt_bwd_dq_cuda.launches += 1
    return dq, delta, ds


def _bwd_rows(vp: int) -> int:
    """The fewest query rows a dq block owns: sizes dscale's partials."""
    fn = getattr(_build.load("dotatt_bwd"), "dotatt_bwd_rows")
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(vp)


def dotatt_split(L: int, H: int, B: int, V: int) -> Tuple[int, int, int]:
    """The splits the forward, dq and dk/dv take at this shape on the
    current card, from the library: 1 (four warps, each owning 16 rows of a
    64-row block and reading every streamed row), 2 (eight warps, two on
    each 16 rows, each reading half of every streamed tile) or 4 (few
    blocks: four warps owning the same 16 rows, each reading a quarter)."""
    fn = getattr(_build.load("dotatt_fwd"), "dotatt_split")
    fn.argtypes, fn.restype = [ctypes.c_int] * 5, ctypes.c_int
    return tuple(fn(L, H, B, _width(V), entry) for entry in range(3))


def dotatt_bwd_dkdv_cuda(q, k, v, g, stats, delta, dist=None, thr=None, scale=None):
    """Launch the dk/dv entry point: ``(dk, dv)``, each (B, L, H*V), from
    the forward's row statistics and the delta that
    :func:`dotatt_bwd_dq_cuda` wrote. Adds one to
    ``dotatt_bwd_dkdv_cuda.launches``."""
    B, L, H, V = _check_bwd("dotatt_bwd_dkdv_cuda", q, k, v, g, stats, dist, thr, scale,
                            delta=delta)
    dev = q.device
    dk = torch.empty((B, L, H * V), dtype=torch.float32, device=dev)
    dv = torch.empty_like(dk)
    _launch(_entry("dotatt_bwd_dkdv", 11, 6), "dotatt_bwd_dkdv", dev, q, k, v, g, stats, delta,
            dist, thr, scale, dk, dv, B, L, H, V, _width(V), _vec(q, k, v, g), head_scale(V))
    dotatt_bwd_dkdv_cuda.launches += 1
    return dk, dv


dotatt_cuda.launches = 0
dotatt_bwd_dq_cuda.launches = 0
dotatt_bwd_dkdv_cuda.launches = 0


# ------------------------------------------------------------ autograd


class DotAtt(torch.autograd.Function):
    """The forward with its backward: ``apply(q, k, v, dist, thr, scale)``
    -> (B, L, H*V). The forward saves its output and row statistics; the
    backward runs the dq entry point (which also gives delta and, hybrid,
    dscale), then the dk/dv one where ``k`` or ``v`` need a gradient.
    ``dist`` and ``thr`` get none. CPU tensors take the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, dist, thr, scale):
        if q.device.type == "cuda":
            out, stats = dotatt_cuda(q, k, v, dist, thr, scale)
        else:
            _check(q, k, v, dist, thr, scale)
            out, stats = dotatt_reference(q, k, v, dist, thr, scale), None
        ctx.save_for_backward(q, k, v, dist, thr, scale, out, stats)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, dist, thr, scale, out, stats = ctx.saved_tensors
        g = g.contiguous()
        need_q, need_k, need_v, _, _, need_s = ctx.needs_input_grad
        dq = dk = dv = ds = None
        if q.device.type == "cuda":
            dq, delta, ds = dotatt_bwd_dq_cuda(q, k, v, out, g, stats, dist, thr, scale)
            if need_k or need_v:
                dk, dv = dotatt_bwd_dkdv_cuda(q, k, v, g, stats, delta, dist, thr, scale)
        else:
            args = (q, k, v, g, dist, thr, scale)
            dq = dotatt_bwd_dq_reference(*args) if need_q else None
            dk = dotatt_bwd_dk_reference(*args) if need_k else None
            dv = dotatt_bwd_dv_reference(*args) if need_v else None
            ds = dotatt_bwd_dscale_reference(*args) if need_s else None
        shape = q.shape
        grad = lambda t, need: t.reshape(shape) if need and t is not None else None
        return (grad(dq, need_q), grad(dk, need_k), grad(dv, need_v), None, None,
                ds if need_s else None)


def dot_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dist: Optional[torch.Tensor] = None,
    thr: Optional[torch.Tensor] = None,
    scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dot-product attention of the TF family: ``q``, ``k``, ``v`` (B, L,
    H, V) -> (B, L, H*V). ``self`` without ``dist``; ``hybrid`` with the
    (L, L) distances ``dist`` and the heads' scales ``scale`` (H,) (tan r,
    applied outside so that autograd chains through it), local with the
    per-head row thresholds ``thr`` (H, L) on ``dist * scale``.
    Differentiable in q, k, v and scale through :class:`DotAtt`; without a
    gradient only the forward kernel runs."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {q.device}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (q, k, v, scale)):
        return DotAtt.apply(q, k, v, dist, thr, scale)
    if q.device.type == "cuda":
        return dotatt_cuda(q, k, v, dist, thr, scale)[0]
    _check(q, k, v, dist, thr, scale)
    return dotatt_reference(q, k, v, dist, thr, scale)
