"""Fixed-mesh position attention: the CUDA kernels' wrappers, their plain
versions, and the autograd Function around them.

Counterpart of the JAX package's ``kernels/posatt_pallas.py`` (the module
keeps that name so that a reader finds it). Four hand-written sm_90a
kernels, each the port of one TPU kernel:

- ``csrc/posatt_fixed_fwd.cu``: the forward, ``_make_posatt_kernel_v3``;
- ``csrc/posatt_fixed_bwd.cu``: the row statistics ``_posatt_stats``, the
  bandwidth gradient ``_posatt_bwd_dscale`` and the value gradient
  ``_posatt_bwd_du``.

Each source says what bounds it and how. :class:`PosAttFixed` mirrors the
``_posatt_fixed`` custom VJP with its fused backward: the forward saves
only the row statistics (M, L), and the backward recomputes the attention
weights from them. The JAX ``fused_bwd=False`` recompute path is a switch
of the JAX package and has no counterpart here.

Dispatch is by the device of the tensors: a CUDA tensor launches the
kernel or raises, a CPU tensor takes the plain version (``*_reference``).
There is no fallback from one to the other and no switch. Every plain
version takes the port's layouts: the output cotangent ``g`` is
(B, L_out, H*D), the values ``u`` (B, L_in, D), and M, L are (H, L_out, 1).
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from position_induced_transformer_torch.kernels import _build
from position_induced_transformer_torch.ops.locality import quantile_threshold
from position_induced_transformer_torch.ops.posatt import bandwidth_scale

_NEG = -1e38  # mask sentinel: finite, so the online max never meets inf - inf
CUDA_HEADS = (1, 2, 4, 8)  # head counts the kernels are instantiated for


def _keep(dist, thr):
    return (dist <= thr) & (dist < float("inf"))


def posatt_fixed_reference(dist, thr, scale, u):
    """Plain PyTorch version of the forward kernel: (H, B, L_out, D).

    ``dist`` (L_out, L_in), ``thr`` (L_out, 1), ``scale`` (H, 1),
    ``u`` (B, L_in, D).
    """
    logits = torch.where(_keep(dist, thr), -dist[None] * scale[:, :, None], _NEG)
    att = torch.softmax(logits, dim=-1)  # (H, L_out, L_in)
    return torch.einsum("hnj,bjd->hbnd", att, u)


def posatt_stats_reference(dist, thr, scale):
    """Plain version of the stats kernel: the final softmax row max ``M``
    and normaliser ``L`` of the masked logits, (H, L_out, 1) each."""
    logits = torch.where(_keep(dist, thr), -dist[None] * scale[:, :, None], _NEG)
    M = logits.amax(dim=-1, keepdim=True)
    return M, torch.exp(logits - M).sum(dim=-1, keepdim=True)


def _weights(dist, thr, scale, M, L):
    """Attention weights (H, L_out, L_in) recomputed from (M, L); exactly 0
    on masked entries (``where`` keeps ``inf * 0`` of padded or global rows
    out), and the keep mask."""
    keep = _keep(dist, thr)
    p = torch.where(keep, torch.exp(-dist[None] * scale[:, :, None] - M), 0.0) / L
    return p, keep


def posatt_bwd_dscale_reference(dist, thr, scale, M, L, g, u):
    """Plain version of the dscale kernel: d(loss)/d(scale), (H, 1).

    With T = G U^T per head, r = sum_j P T, v = sum_j P (-d) and
    w = sum_j P T (-d) per row: ``ds_h = sum_i (w_i - r_i v_i)``.
    """
    H = scale.shape[0]
    B, L_out, _ = g.shape
    p, keep = _weights(dist, thr, scale, M, L)
    t = torch.einsum("bihk,bjk->hij", g.reshape(B, L_out, H, u.shape[-1]), u)
    nd = torch.where(keep, -dist, 0.0)
    r = (p * t).sum(-1)
    v = (p * nd).sum(-1)
    w = (p * t * nd).sum(-1)
    return (w - r * v).sum(-1, keepdim=True)


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


def _check_cuda(name, dist, scale) -> None:
    if dist.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dist.device}")
    if scale.shape[0] not in CUDA_HEADS:
        raise ValueError(f"the kernels support {CUDA_HEADS} heads, got {scale.shape[0]}")


def _check_bwd(name, dist, scale, M, L, g, B, D, u=None) -> None:
    """The backward launchers' inputs: the forward's (already valid) dist,
    thr, scale and values, its row statistics, and a cotangent of its
    output."""
    named = (("M", M), ("L", L), ("g", g)) + ((("u", u),) if u is not None else ())
    _check_tensors(named, dist.device)
    _check_cuda(name, dist, scale)
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


def posatt_fixed_cuda(dist, thr, scale, u):
    """Launch the forward kernel on CUDA tensors: (B, L_out, H*D),
    head-concat.

    Same arguments as :func:`posatt_fixed_reference`. Adds one to
    ``posatt_fixed_cuda.launches`` for each launch.
    """
    _check(dist, thr, scale, u)
    _check_cuda("posatt_fixed_cuda", dist, scale)
    H = scale.shape[0]
    B, L_in, D = u.shape
    L_out = dist.shape[0]
    out = torch.empty((B, L_out, H * D), dtype=torch.float32, device=dist.device)
    fn = _entry("posatt_fixed_fwd", "posatt_fixed_fwd", 5, 5)
    _launch(fn, "posatt_fixed_fwd", dist.device,
            dist, thr, scale, u, out, H, B, L_out, L_in, D)
    posatt_fixed_cuda.launches += 1
    return out


def posatt_stats_cuda(dist, thr, scale):
    """Launch the stats kernel on CUDA tensors: (M, L), (H, L_out, 1) each.
    Adds one to ``posatt_stats_cuda.launches`` for each launch."""
    _check_tensors((("dist", dist), ("thr", thr), ("scale", scale)), dist.device)
    _check_cuda("posatt_stats_cuda", dist, scale)
    H = scale.shape[0]
    L_out, L_in = dist.shape
    M = torch.empty((H, L_out, 1), dtype=torch.float32, device=dist.device)
    L = torch.empty_like(M)
    fn = _entry("posatt_fixed_bwd", "posatt_stats", 5, 3)
    _launch(fn, "posatt_stats", dist.device, dist, thr, scale, M, L, H, L_out, L_in)
    posatt_stats_cuda.launches += 1
    return M, L


def posatt_bwd_dscale_cuda(dist, thr, scale, M, L, g, u):
    """Launch the dscale kernel on CUDA tensors: (H, 1). Deterministic:
    per-block partials summed in a fixed order inside the library. Adds one
    to ``posatt_bwd_dscale_cuda.launches`` for each launch."""
    B, L_in, D = u.shape
    _check_bwd("posatt_bwd_dscale_cuda", dist, scale, M, L, g, B, D, u)
    H = scale.shape[0]
    L_out = dist.shape[0]
    # an upper bound on the kernel's block count: its narrowest tiles are
    # 8 rows by 32 columns
    partial = torch.empty(
        (-(-L_out // 8) * -(-(B * D) // 32), H), dtype=torch.float32, device=dist.device
    )
    ds = torch.empty((H, 1), dtype=torch.float32, device=dist.device)
    fn = _entry("posatt_fixed_bwd", "posatt_bwd_dscale", 9, 5)
    _launch(fn, "posatt_bwd_dscale", dist.device,
            dist, thr, scale, M, L, g, u, partial, ds, H, B, L_out, L_in, D)
    posatt_bwd_dscale_cuda.launches += 1
    return ds


def posatt_bwd_du_cuda(dist, thr, scale, M, L, g):
    """Launch the du kernel on CUDA tensors: (B, L_in, D). Adds one to
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
posatt_stats_cuda.launches = 0
posatt_bwd_dscale_cuda.launches = 0
posatt_bwd_du_cuda.launches = 0


def _forward(dist, thr, scale, u):
    """The forward on either device; the inputs are validated once, by the
    launcher or here before the plain version."""
    if dist.device.type == "cuda":
        return posatt_fixed_cuda(dist, thr, scale, u)
    _check(dist, thr, scale, u)
    B, _, D = u.shape
    out = posatt_fixed_reference(dist, thr, scale, u)  # (H, B, L_out, D)
    return out.permute(1, 2, 0, 3).reshape(B, dist.shape[0], -1)


class PosAttFixed(torch.autograd.Function):
    """Fixed-mesh position attention with the fused backward:
    ``apply(dist, thr, scale, u)`` -> (B, L_out, H*D).

    The forward runs the forward kernel and the stats kernel and saves
    (dist, thr, scale, u, M, L); the backward runs the dscale kernel when
    ``scale`` needs a gradient and the du kernel when ``u`` does. ``dist``
    and ``thr`` get none. CPU tensors take the plain versions of the same
    four functions, so the CPU tests run this backward's closed form.
    """

    @staticmethod
    def forward(ctx, dist, thr, scale, u):
        out = _forward(dist, thr, scale, u)
        if dist.device.type == "cuda":
            M, L = posatt_stats_cuda(dist, thr, scale)
        else:
            M, L = posatt_stats_reference(dist, thr, scale)
        ctx.save_for_backward(dist, thr, scale, u, M, L)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        dist, thr, scale, u, M, L = ctx.saved_tensors
        g = g.contiguous()  # the residual concat hands over a strided slice
        cuda = dist.device.type == "cuda"
        dscale = du = None
        if ctx.needs_input_grad[2]:
            dscale = (posatt_bwd_dscale_cuda if cuda else posatt_bwd_dscale_reference)(
                dist, thr, scale, M, L, g, u
            )
        if ctx.needs_input_grad[3]:
            du = (posatt_bwd_du_cuda if cuda else posatt_bwd_du_reference)(
                dist, thr, scale, M, L, g
            )
        return None, None, dscale, du


def position_attention_fixed(dist, lmda, inputs, locality: float, thr=None):
    """Fixed-mesh position attention: (B, L_out, H*D).

    Same contract as ``ops.posatt.position_attention`` for a 2-D ``dist``.
    ``thr`` is the optional per-row threshold (L_out, 1): ``+inf`` when
    ``locality >= 1``, else computed by quantile when missing. When a
    gradient is needed the call goes through :class:`PosAttFixed` (forward
    and stats kernels); otherwise, as under ``torch.inference_mode``, it
    launches the forward kernel only. The gradient with respect to ``lmda``
    flows through ``bandwidth_scale`` outside the Function.
    """
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
        return PosAttFixed.apply(dist, thr, scale, inputs)
    return _forward(dist, thr, scale, inputs)
