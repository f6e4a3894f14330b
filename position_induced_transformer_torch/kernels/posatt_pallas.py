"""Fixed-mesh position attention: the CUDA kernel's wrapper and its plain
version.

Counterpart of the JAX package's ``kernels/posatt_pallas.py`` (the module
keeps that name so that a reader finds it). The kernel is
``csrc/posatt_fixed_fwd.cu``, a hand-written sm_90a port of the TPU kernel
``_make_posatt_kernel_v3``; its source says what bounds it and how.

Dispatch is by the device of the tensors: a CUDA tensor launches the kernel
or raises, a CPU tensor takes the plain version :func:`posatt_fixed_reference`.
There is no fallback from one to the other and no switch.

Only the forward exists. The backward kernels land with the training slice;
until then a CUDA call that would need a gradient raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from position_induced_transformer_torch.kernels import _build
from position_induced_transformer_torch.ops.locality import quantile_threshold
from position_induced_transformer_torch.ops.posatt import bandwidth_scale

_NEG = -1e38  # mask sentinel: finite, so the online max never meets inf - inf
CUDA_HEADS = (1, 2, 4, 8)  # head counts the kernel is instantiated for


def posatt_fixed_reference(dist, thr, scale, u):
    """Plain PyTorch version of the kernel: (H, B, L_out, D).

    ``dist`` (L_out, L_in), ``thr`` (L_out, 1), ``scale`` (H, 1),
    ``u`` (B, L_in, D).
    """
    keep = (dist <= thr) & (dist < float("inf"))
    logits = torch.where(keep, -dist[None] * scale[:, :, None], _NEG)
    att = torch.softmax(logits, dim=-1)  # (H, L_out, L_in)
    return torch.einsum("hnj,bjd->hbnd", att, u)


def _check(dist, thr, scale, u) -> None:
    named = (("dist", dist), ("thr", thr), ("scale", scale), ("inputs", u))
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != dist.device:
            raise ValueError(
                f"{name} is on {t.device} but dist is on {dist.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
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


@functools.cache
def _kernel():
    """The C entry point, built and loaded at first use; typed once."""
    fn = _build.load("posatt_fixed_fwd").posatt_fixed_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def posatt_fixed_cuda(dist, thr, scale, u):
    """Launch the kernel on CUDA tensors: (B, L_out, H*D), head-concat.

    Same arguments as :func:`posatt_fixed_reference`. Adds one to
    ``posatt_fixed_cuda.launches`` for each launch.
    """
    _check(dist, thr, scale, u)
    if dist.device.type != "cuda":
        raise ValueError(f"posatt_fixed_cuda needs CUDA tensors, got {dist.device}")
    H = scale.shape[0]
    if H not in CUDA_HEADS:
        raise ValueError(f"the kernel supports {CUDA_HEADS} heads, got {H}")
    B, L_in, D = u.shape
    L_out = dist.shape[0]
    out = torch.empty((B, L_out, H * D), dtype=torch.float32, device=dist.device)
    fn = _kernel()
    with torch.cuda.device(dist.device):
        stream = torch.cuda.current_stream(dist.device).cuda_stream
        rc = fn(
            dist.data_ptr(), thr.data_ptr(), scale.data_ptr(), u.data_ptr(),
            out.data_ptr(), H, B, L_out, L_in, D, stream,
        )
    if rc != 0:
        raise RuntimeError(f"posatt_fixed_fwd launch failed with CUDA error {rc}")
    posatt_fixed_cuda.launches += 1
    return out


posatt_fixed_cuda.launches = 0


def position_attention_fixed(dist, lmda, inputs, locality: float, thr=None):
    """Fixed-mesh position attention: (B, L_out, H*D).

    Same contract as ``ops.posatt.position_attention`` for a 2-D ``dist``.
    ``thr`` is the optional per-row threshold (L_out, 1): ``+inf`` when
    ``locality >= 1``, else computed by quantile when missing. The inputs
    are validated once, by the launcher or before the plain version.
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
    if dist.device.type == "cuda":
        if torch.is_grad_enabled() and any(
            t.requires_grad for t in (dist, thr, scale, inputs)
        ):
            raise NotImplementedError(
                "position_attention_fixed on CUDA has no backward yet: the "
                "backward kernels land with the training slice. Run under "
                "torch.no_grad() or torch.inference_mode()."
            )
        return posatt_fixed_cuda(dist, thr, scale, inputs)
    _check(dist, thr, scale, inputs)
    B, _, D = inputs.shape
    out = posatt_fixed_reference(dist, thr, scale, inputs)  # (H, B, L_out, D)
    return out.permute(1, 2, 0, 3).reshape(B, L_out, H * D)
