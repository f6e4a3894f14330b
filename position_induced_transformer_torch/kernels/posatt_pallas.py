"""Fixed-mesh position attention: the CUDA kernels' wrappers, their plain
versions, and the autograd Function around them.

Counterpart of the JAX package's ``kernels/posatt_pallas.py`` (the module
keeps that name so that a reader finds it). Six hand-written sm_90a
kernels, each the port of one TPU kernel:

- ``csrc/posatt_fixed_fwd.cu``: the forward under the three schedules of
  the JAX ``version`` option, one entry point each and one kernel body
  for all three: ``posatt_fixed_fwd`` (version 3,
  ``_make_posatt_kernel_v3``), ``posatt_fixed_fwd_v2``
  (``_posatt_kernel_v2``) and ``posatt_fixed_fwd_v1`` (``_posatt_kernel``),
  each of which also writes the row statistics when asked; and the row
  statistics ``_posatt_stats`` alone (``posatt_stats``: version 3's kernel
  without the contraction, which no path launches);
- ``csrc/posatt_fixed_bwd.cu``: the bandwidth gradient
  ``_posatt_bwd_dscale`` and the value gradient ``_posatt_bwd_du``.

Each source says what bounds it and how. The three versions compute one
function and differ only in what a block owns (a group of up to 8 heads,
one head, or one head and one sample), so on the CPU every version takes
the one plain
version, :func:`posatt_fixed_reference`. :class:`PosAttFixed` mirrors the
``_posatt_fixed`` custom VJP with its fused backward: the forward runs the
chosen version's kernel, which writes the row statistics M and L beside
its output, and saves M, L and its output; the backward recomputes the
attention weights from (M, L), and its bandwidth gradient reads the output,
so that it needs no second pass over the rows. The JAX ``fused_bwd=False`` recompute path and
``interpret`` switch have no counterpart here.

Dispatch is by the device of the tensors: a CUDA tensor launches the
kernel or raises, a CPU tensor takes the plain version (``*_reference``).
There is no fallback from one to the other and no switch. Every plain
version takes the port's layouts: the output cotangent ``g`` is
(B, L_out, H*D), the values ``u`` (B, L_in, D), and M, L are (H, L_out, 1).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from position_induced_transformer_torch.kernels import _build
from position_induced_transformer_torch.ops.locality import quantile_threshold
from position_induced_transformer_torch.ops.posatt import bandwidth_scale

_NEG = -1e38  # mask sentinel: finite, so the online max never meets inf - inf
VERSIONS = (1, 2, 3)  # the forward's schedules, as the JAX ``version``


def _keep(dist, thr):
    return (dist <= thr) & (dist < float("inf"))


def _logits(dist, thr, scale):
    """The masked logits (H, L_out, L_in): -scale * dist where kept, else
    the finite -1e38."""
    return torch.where(_keep(dist, thr), -dist[None] * scale[:, :, None], _NEG)


def _row_stats(logits):
    M = logits.amax(dim=-1, keepdim=True)
    return M, torch.exp(logits - M).sum(dim=-1, keepdim=True)


def posatt_fixed_reference(dist, thr, scale, u, stats=False):
    """Plain PyTorch version of the forward kernel: (H, B, L_out, D), and
    with ``stats`` also the row statistics M, L of the same logits, as the
    kernel writes them: ``(out, M, L)``.

    ``dist`` (L_out, L_in), ``thr`` (L_out, 1), ``scale`` (H, 1),
    ``u`` (B, L_in, D). A row that keeps no entry has the softmax of -1e38
    everywhere: uniform weights, M = -1e38, L = L_in.
    """
    logits = _logits(dist, thr, scale)
    att = torch.softmax(logits, dim=-1)  # (H, L_out, L_in)
    out = torch.einsum("hnj,bjd->hbnd", att, u)
    return (out, *_row_stats(logits)) if stats else out


def posatt_stats_reference(dist, thr, scale):
    """Plain version of the stats kernel: the final softmax row max ``M``
    and normaliser ``L`` of the masked logits, (H, L_out, 1) each."""
    return _row_stats(_logits(dist, thr, scale))


def _weights(dist, thr, scale, M, L):
    """Attention weights (H, L_out, L_in) recomputed from (M, L); exactly 0
    on masked entries (``where`` keeps ``inf * 0`` of padded or global rows
    out), and the keep mask."""
    keep = _keep(dist, thr)
    p = torch.where(keep, torch.exp(-dist[None] * scale[:, :, None] - M), 0.0) / L
    return p, keep


def posatt_bwd_dscale_reference(dist, thr, scale, M, L, g, u, out):
    """Plain version of the dscale kernel: d(loss)/d(scale), (H, 1).

    With T = G U^T per head, r = sum_j P T, v = sum_j P (-d) and
    w = sum_j P T (-d) per row, ``ds_h = sum_i (w_i - r_i v_i)``. The
    kernel's closed form, computed here too: r_i = G_h[i] . O_h[i] with
    ``out`` = O, the forward's output (B, L_out, H*D), so that
    ``ds_h = sum_{i,n} G_h[i,n] (Y_h[i,n] - v_h[i] O_h[i,n])`` with
    Y_h = W_h U and W_h = P_h (-d).
    """
    H = scale.shape[0]
    B, L_out, _ = g.shape
    D = u.shape[-1]
    p, keep = _weights(dist, thr, scale, M, L)
    w = p * torch.where(keep, -dist, 0.0)  # (H, L_out, L_in)
    v = w.sum(-1)  # (H, L_out)
    y = torch.einsum("hij,bjk->bihk", w, u) - v.T[None, :, :, None] * out.reshape(B, L_out, H, D)
    return (g.reshape(B, L_out, H, D) * y).sum((0, 1, 3)).reshape(H, 1)


def posatt_bwd_du_reference(dist, thr, scale, M, L, g):
    """Plain version of the du kernel: d(loss)/d(values) = sum_h P_h^T G_h,
    (B, L_in, D)."""
    H = scale.shape[0]
    B, L_out, HD = g.shape
    p, _ = _weights(dist, thr, scale, M, L)
    return torch.einsum("hij,bihk->bjk", p, g.reshape(B, L_out, H, HD // H))


def _check_tensors(named, device) -> None:
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device} but dist is on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check(dist, thr, scale, u) -> None:
    _check_tensors((("dist", dist), ("thr", thr), ("scale", scale), ("inputs", u)), dist.device)
    if dist.ndim != 2:
        raise ValueError(f"dist must be (L_out, L_in), got {tuple(dist.shape)}")
    L_out, L_in = dist.shape
    if u.ndim != 3 or u.shape[1] != L_in:
        raise ValueError(
            f"inputs must be (B, {L_in}, D), got {tuple(u.shape)}"
        )
    if tuple(thr.shape) != (L_out, 1):
        raise ValueError(f"thr must be ({L_out}, 1), got {tuple(thr.shape)}")
    if scale.ndim != 2 or scale.shape[1] != 1:
        raise ValueError(f"scale must be (H, 1), got {tuple(scale.shape)}")


def _check_version(version) -> None:
    if version not in VERSIONS:
        raise ValueError(f"unknown kernel version {version!r}; expected 1, 2 or 3")


def _check_cuda(name, dist) -> None:
    if dist.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dist.device}")


def _check_bwd(name, dist, scale, M, L, g, B, D, u=None) -> None:
    """The backward launchers' inputs: the forward's (already valid) dist,
    thr, scale and values, its row statistics, and a cotangent of its
    output."""
    named = (("M", M), ("L", L), ("g", g)) + ((("u", u),) if u is not None else ())
    _check_tensors(named, dist.device)
    _check_cuda(name, dist)
    H, L_out = scale.shape[0], dist.shape[0]
    for stat, t in (("M", M), ("L", L)):
        if tuple(t.shape) != (H, L_out, 1):
            raise ValueError(f"{stat} must be ({H}, {L_out}, 1), got {tuple(t.shape)}")
    if tuple(g.shape) != (B, L_out, H * D):
        raise ValueError(f"g must be ({B}, {L_out}, {H * D}), got {tuple(g.shape)}")


@functools.cache
def _entry(lib: str, name: str, n_ptr: int, n_int: int):
    """A C entry point of a kernel library, built and loaded at first use:
    ``n_ptr`` pointers, ``n_int`` ints, then the stream; typed once."""
    fn = getattr(_build.load(lib), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(fn, name, device, *args) -> None:
    """Call a C entry point on ``device``'s current stream; tensors pass
    as pointers. Raises when the launch was refused."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*(a.data_ptr() if torch.is_tensor(a) else a for a in args), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")


class FwdPlan(NamedTuple):
    """How one forward or stats launch cuts its work: the floats of split
    records and the tile counters it needs (both 0 up to 8 splits), the
    splits of L_in and the warps a block."""

    floats: int
    tiles: int
    splits: int
    warps: int


@functools.lru_cache(maxsize=256)
def _fwd_plan(out: bool, H: int, B: int, L_out: int, L_in: int, D: int, version: int = 3):
    """How one forward of ``version`` (``out`` True) or stats launch (its
    plan is version 3's) cuts its work at this shape, from the library."""
    fn = getattr(_build.load("posatt_fixed_fwd"), "posatt_fwd_plan")
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_longlong)] * 2 + [
        ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    floats, tiles = ctypes.c_longlong(0), ctypes.c_longlong(0)
    splits, warps = ctypes.c_int(0), ctypes.c_int(0)
    rc = fn(int(out), version, H, B, L_out, L_in, D, ctypes.byref(floats), ctypes.byref(tiles),
            ctypes.byref(splits), ctypes.byref(warps))
    if rc != 0:
        raise ValueError(f"posatt_fwd_plan refused version={version} H={H} B={B} "
                         f"L_out={L_out} L_in={L_in} D={D}")
    return FwdPlan(floats.value, tiles.value, splits.value, warps.value)


# (device, stream) -> the launch counters of the forwards and #2 (one a
# tile; a launch of any version takes as many as its own plan has) and of
# dscale (one): int32 zeros, left zero by every launch, grown (as new
# zeros) when a launch needs more; kept, not made per call, so that a
# launch needs no memset
_COUNTERS: dict = {}


def _counters(device, n: int):
    """At least ``n`` counters for ``device``'s current stream. Launches on
    one stream run one after another and share them; another stream gets
    its own."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(n, dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


def _split_scratch(out, dist, H, B, L_out, L_in, D, version=3):
    """The split records and tile counters one launch needs (None, None up
    to 8 splits, where the splits combine inside a cluster)."""
    floats, tiles, _, _ = _fwd_plan(out, H, B, L_out, L_in, D, version)
    if not floats:
        return None, None
    scratch = torch.empty(floats, dtype=torch.float32, device=dist.device)
    return scratch, _counters(dist.device, tiles)


# the forwards' C entry points, by version
_FWD_ENTRIES = {1: "posatt_fixed_fwd_v1", 2: "posatt_fixed_fwd_v2", 3: "posatt_fixed_fwd"}


def _launch_forward(version, dist, thr, scale, u, stats):
    """Launch the forward of ``version`` on CUDA tensors: (B, L_out, H*D),
    and with ``stats`` also M and L (H, L_out, 1) from the same launch."""
    name = _FWD_ENTRIES[version]
    _check(dist, thr, scale, u)
    _check_cuda(name, dist)
    H = scale.shape[0]
    B, L_in, D = u.shape
    L_out = dist.shape[0]
    out = torch.empty((B, L_out, H * D), dtype=torch.float32, device=dist.device)
    M = L = None
    if stats:
        M = torch.empty((H, L_out, 1), dtype=torch.float32, device=dist.device)
        L = torch.empty_like(M)
    scratch, counters = _split_scratch(True, dist, H, B, L_out, L_in, D, version)
    _launch(_entry("posatt_fixed_fwd", name, 9, 5), name, dist.device,
            dist, thr, scale, u, out, M, L, scratch, counters, H, B, L_out, L_in, D)
    return (out, M, L) if stats else out


def posatt_fixed_cuda(dist, thr, scale, u, stats=False):
    """Launch the forward kernel (version 3: a block owns a group of up to
    8 heads, a column tile and a split of L_in) on CUDA tensors:
    (B, L_out, H*D), head-concat, any head count; with ``stats`` the same
    launch also writes the row statistics: ``(out, M, L)``, M and L
    (H, L_out, 1) each, the bits :func:`posatt_stats_cuda` writes at this
    shape.

    Same arguments as :func:`posatt_fixed_reference`. Deterministic. Adds
    one to ``posatt_fixed_cuda.launches`` for each launch.
    """
    got = _launch_forward(3, dist, thr, scale, u, stats)
    posatt_fixed_cuda.launches += 1
    return got


def posatt_fixed_v2_cuda(dist, thr, scale, u, stats=False):
    """Launch the version-2 forward (a block owns one head, a tile of the
    batch-folded columns and a split of L_in; version 3's kernel, or its
    row walk where B*D is 32 or less) on CUDA tensors: (B, L_out, H*D), any
    head count; with ``stats`` ``(out, M, L)`` from the same launch, on
    this version's own plan (where its blocks have version 3's warps,
    rounds and splits, version 3's bits). Adds one to
    ``posatt_fixed_v2_cuda.launches`` for each launch."""
    got = _launch_forward(2, dist, thr, scale, u, stats)
    posatt_fixed_v2_cuda.launches += 1
    return got


def posatt_fixed_v1_cuda(dist, thr, scale, u, stats=False):
    """Launch the version-1 forward (a block owns one head, one sample's
    columns and a split of L_in; version 3's kernel: at D up to 64 its row
    walk or four warps sharing the keys, as the plan picks) on CUDA
    tensors: (B, L_out, H*D), any head count; with ``stats`` as
    :func:`posatt_fixed_v2_cuda`. Adds one to
    ``posatt_fixed_v1_cuda.launches`` for each launch."""
    got = _launch_forward(1, dist, thr, scale, u, stats)
    posatt_fixed_v1_cuda.launches += 1
    return got


def posatt_stats_cuda(dist, thr, scale, B, D):
    """Launch the stats kernel on CUDA tensors: (M, L), (H, L_out, 1) each.

    It is the version-3 forward's kernel without the contraction, on the
    plan of a forward of ``B`` samples of ``D`` value columns: it writes
    the bits of M and L that :func:`posatt_fixed_cuda` writes with
    ``stats`` at that shape. No path launches it (every forward writes M
    and L); it stays as the port of ``_posatt_stats``. Adds one to
    ``posatt_stats_cuda.launches`` for each launch."""
    _check_tensors((("dist", dist), ("thr", thr), ("scale", scale)), dist.device)
    _check_cuda("posatt_stats_cuda", dist)
    H = scale.shape[0]
    L_out, L_in = dist.shape
    M = torch.empty((H, L_out, 1), dtype=torch.float32, device=dist.device)
    L = torch.empty_like(M)
    scratch, counters = _split_scratch(False, dist, H, B, L_out, L_in, D)
    fn = _entry("posatt_fixed_fwd", "posatt_stats", 7, 5)
    _launch(fn, "posatt_stats", dist.device, dist, thr, scale, M, L, scratch, counters,
            H, B, L_out, L_in, D)
    posatt_stats_cuda.launches += 1
    return M, L


@functools.lru_cache(maxsize=256)
def _bwd_plan(du: bool, H: int, B: int, L_out: int, L_in: int, D: int):
    """How one dscale (``du`` False) or du launch cuts its work at this
    shape, from the library: (floats of partials dscale needs, the number
    of splits of its streamed index); du needs no scratch."""
    fn = getattr(_build.load("posatt_fixed_bwd"), "posatt_bwd_plan")
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong),
                                        ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    floats, splits = ctypes.c_longlong(0), ctypes.c_int(0)
    rc = fn(int(du), H, B, L_out, L_in, D, ctypes.byref(floats), ctypes.byref(splits))
    if rc != 0:
        raise ValueError(f"posatt_bwd_plan refused H={H} B={B} L_out={L_out} L_in={L_in} D={D}")
    return floats.value, splits.value


def posatt_bwd_dscale_cuda(dist, thr, scale, M, L, g, u, out):
    """Launch the dscale kernel on CUDA tensors: (H, 1). ``out`` is the
    forward's output (B, L_out, H*D). One launch; deterministic: the
    blocks' partials are summed in a fixed order by the last block to
    finish. Adds one to ``posatt_bwd_dscale_cuda.launches`` for each
    launch."""
    B, L_in, D = u.shape
    _check_bwd("posatt_bwd_dscale_cuda", dist, scale, M, L, g, B, D, u)
    _check_tensors((("out", out),), dist.device)
    if out.shape != g.shape:
        raise ValueError(f"out must be {tuple(g.shape)}, got {tuple(out.shape)}")
    H = scale.shape[0]
    L_out = dist.shape[0]
    floats, _ = _bwd_plan(False, H, B, L_out, L_in, D)
    partial = torch.empty(floats, dtype=torch.float32, device=dist.device)
    ds = torch.empty((H, 1), dtype=torch.float32, device=dist.device)
    fn = _entry("posatt_fixed_bwd", "posatt_bwd_dscale", 11, 5)
    _launch(fn, "posatt_bwd_dscale", dist.device, dist, thr, scale, M, L, g, u, out,
            partial, _counters(dist.device, 1), ds, H, B, L_out, L_in, D)
    posatt_bwd_dscale_cuda.launches += 1
    return ds


def posatt_bwd_du_cuda(dist, thr, scale, M, L, g):
    """Launch the du kernel on CUDA tensors: (B, L_in, D). One launch;
    deterministic: where the rows are split over blocks, the blocks of a
    tile form one cluster and sum their tiles in a fixed order. Adds one to
    ``posatt_bwd_du_cuda.launches`` for each launch."""
    H = scale.shape[0]
    B, L_out, HD = g.shape
    D = HD // H
    _check_bwd("posatt_bwd_du_cuda", dist, scale, M, L, g, B, D)
    L_in = dist.shape[1]
    du = torch.empty((B, L_in, D), dtype=torch.float32, device=dist.device)
    fn = _entry("posatt_fixed_bwd", "posatt_bwd_du", 7, 5)
    _launch(fn, "posatt_bwd_du", dist.device,
            dist, thr, scale, M, L, g, du, H, B, L_out, L_in, D)
    posatt_bwd_du_cuda.launches += 1
    return du


posatt_fixed_cuda.launches = 0
posatt_fixed_v2_cuda.launches = 0
posatt_fixed_v1_cuda.launches = 0
posatt_stats_cuda.launches = 0
posatt_bwd_dscale_cuda.launches = 0
posatt_bwd_du_cuda.launches = 0


_FORWARDS = {1: posatt_fixed_v1_cuda, 2: posatt_fixed_v2_cuda, 3: posatt_fixed_cuda}


def _forward(dist, thr, scale, u, version=3, stats=False):
    """The forward on either device: (B, L_out, H*D), or with ``stats``
    ``(out, M, L)`` with the row statistics (H, L_out, 1): on the card the
    version's one launch writes them; on the CPU the plain version, which
    serves every version, gives them from its own logits. The inputs are
    validated once, by the launcher or here before the plain version."""
    _check_version(version)
    if dist.device.type == "cuda":
        return _FORWARDS[version](dist, thr, scale, u, stats=stats)
    _check(dist, thr, scale, u)
    B, _, D = u.shape
    got = posatt_fixed_reference(dist, thr, scale, u, stats=stats)
    out = got[0] if stats else got  # (H, B, L_out, D)
    out = out.permute(1, 2, 0, 3).reshape(B, dist.shape[0], -1)
    return (out, *got[1:]) if stats else out


class PosAttFixed(torch.autograd.Function):
    """Fixed-mesh position attention with the fused backward:
    ``apply(dist, thr, scale, u, version=3)`` -> (B, L_out, H*D).

    The forward runs the chosen version's forward kernel, which writes the
    row statistics M and L beside its output, and saves (dist, thr, scale,
    u, M, L, out); the backward runs the dscale kernel, which reads the forward's output, when ``scale``
    needs a gradient and the du kernel when ``u`` does, whatever the
    version. ``dist``, ``thr`` and ``version`` get none. CPU tensors take
    the plain versions of the same four functions, so the CPU tests run
    this backward's closed form.
    """

    @staticmethod
    def forward(ctx, dist, thr, scale, u, version=3):
        out, M, L = _forward(dist, thr, scale, u, version, stats=True)
        ctx.save_for_backward(dist, thr, scale, u, M, L, out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        dist, thr, scale, u, M, L, out = ctx.saved_tensors
        g = g.contiguous()  # the residual concat hands over a strided slice
        cuda = dist.device.type == "cuda"
        dscale = du = None
        if ctx.needs_input_grad[2]:
            dscale = (posatt_bwd_dscale_cuda if cuda else posatt_bwd_dscale_reference)(
                dist, thr, scale, M, L, g, u, out
            )
        if ctx.needs_input_grad[3]:
            du = (posatt_bwd_du_cuda if cuda else posatt_bwd_du_reference)(
                dist, thr, scale, M, L, g
            )
        return None, None, dscale, du, None


def position_attention_fixed(dist, lmda, inputs, locality: float, thr=None, *, version=3):
    """Fixed-mesh position attention: (B, L_out, H*D).

    Same contract as ``ops.posatt.position_attention`` for a 2-D ``dist``.
    ``thr`` is the optional per-row threshold (L_out, 1): ``+inf`` when
    ``locality >= 1``, else computed by quantile when missing. ``version``
    picks the forward kernel's schedule, as in the JAX package: 3 (the
    default) = a group of up to 8 heads and a tile of the batch-folded
    columns a block, 2
    = one head and a tile of the batch-folded columns, 1 = one head and one
    sample; another value raises ``ValueError`` before anything runs. When
    a gradient is needed the call goes through :class:`PosAttFixed`
    (the forward kernel of any version writes the row statistics too); otherwise, as under
    ``torch.inference_mode``, it launches the forward kernel only. The
    gradient with respect to ``lmda`` flows through ``bandwidth_scale``
    outside the Function.
    """
    _check_version(version)
    if dist.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dist.device}")
    H = lmda.shape[0]
    L_out = dist.shape[0]
    if locality >= 1.0:
        thr = torch.full(
            (L_out, 1), float("inf"), dtype=torch.float32, device=dist.device
        )
    elif thr is None:
        thr = quantile_threshold(dist, locality)
    scale = bandwidth_scale(lmda).reshape(H, 1)
    if torch.is_grad_enabled() and (scale.requires_grad or inputs.requires_grad):
        return PosAttFixed.apply(dist, thr, scale, inputs, version)
    return _forward(dist, thr, scale, inputs, version)
