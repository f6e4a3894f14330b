"""Normalization: per-pixel statistics with resolution transfer, and
instance normalization over the mesh axis."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _linear_resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of ``jax.image.resize(method="linear")``
    along one axis, as JAX's ``scale_and_translate`` defines them: sample
    points at half-pixel centres, a triangle kernel widened by 1 / scale
    when shrinking (antialiasing), each output's weights renormalised to
    sum 1 (which matters at the edges), and zero where the sample point
    lies outside the input."""
    f32 = np.float32
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = f32(max(inv_scale, 1.0))
    # one rounding of (i + 1/2) / scale - 1/2, as the compiled JAX
    # function computes it (a fused multiply-add): at 43 -> 421 a sample
    # point rounded twice moves a weight by 2e-6
    half = np.arange(n_out, dtype=f32) + f32(0.5)
    sample = (half.astype(np.float64) * np.float64(f32(inv_scale)) - 0.5).astype(f32)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        w / np.where(total != 0, total, f32(1.0)),
        f32(0.0),
    )
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def linear_resize(t: torch.Tensor, shape) -> torch.Tensor:
    """``jax.image.resize(t, shape, method="linear")``: each axis whose size
    changes is contracted with its (n_in, n_out) weights, built on the host
    and applied as one small product per axis. Unlike
    ``F.interpolate(mode="bilinear")`` this antialiases when it shrinks."""
    shape = tuple(shape)
    if len(shape) != t.ndim:
        raise ValueError(f"resize to {shape}: the tensor has {t.ndim} axes")
    for d, (n_in, n_out) in enumerate(zip(t.shape, shape)):
        if n_in == n_out:
            continue
        w = torch.from_numpy(_linear_resize_weights(n_in, n_out)).to(t.device, t.dtype)
        t = torch.movedim(torch.tensordot(t, w, dims=([d], [0])), -1, d)
    return t


@dataclasses.dataclass
class PixelWiseNormalizer:
    """Per-pixel (per-location) normalization with resolution transfer.

    ``mean`` and ``std`` are (1, h, w, C) (or (1, L, C)) statistics over the
    samples of a training array. ``normalize`` and ``denormalize`` take
    tensors of any spatial resolution: where it differs from the
    statistics', they are resized as ``jax.image.resize(method="linear")``
    resizes them, the mechanism that lets statistics fitted on the 43^2
    Darcy grid normalize 421^2 zero-shot super-resolution inputs and
    outputs. Resized statistics are kept per (shape, device).
    """

    mean: torch.Tensor
    std: torch.Tensor
    eps: float = 1e-5
    _cache: dict = dataclasses.field(default_factory=dict, init=False, repr=False, compare=False)

    def __post_init__(self):
        self.mean = torch.as_tensor(self.mean, dtype=torch.float32)
        self.std = torch.as_tensor(self.std, dtype=torch.float32)
        self.eps = float(self.eps)

    @classmethod
    def fit(cls, x: torch.Tensor, eps: float = 1e-5) -> "PixelWiseNormalizer":
        """Mean and unbiased standard deviation (ddof 1) over axis 0."""
        x = torch.as_tensor(x)
        return cls(
            mean=torch.mean(x, dim=0, keepdim=True),
            std=torch.std(x, dim=0, keepdim=True, correction=1),
            eps=eps,
        )

    def _stats_for(self, x: torch.Tensor):
        key = (tuple(x.shape[1:]), x.device)
        if key not in self._cache:
            mean, std = self.mean, self.std
            if tuple(x.shape[1:]) != tuple(mean.shape[1:]):
                target = (1,) + tuple(x.shape[1:])
                mean, std = linear_resize(mean, target), linear_resize(std, target)
            self._cache[key] = (mean.to(x.device), std.to(x.device))
        return self._cache[key]

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        mean, std = self._stats_for(x)
        return (x - mean) / (std + self.eps)

    def denormalize(self, x: torch.Tensor) -> torch.Tensor:
        mean, std = self._stats_for(x)
        return x * (std + self.eps) + mean

    def state(self) -> dict:
        """The statistics a checkpoint carries: CPU tensors and eps."""
        return {"mean": self.mean.detach().cpu(), "std": self.std.detach().cpu(),
                "eps": torch.tensor(self.eps, dtype=torch.float64)}


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm over the mesh axis of a (B, L, C) tensor: per (sample,
    channel) statistics over L, biased variance, no affine parameters.
    The statistics and the normalisation are float32 whatever ``x``'s
    dtype; the result comes back in ``x``'s dtype."""
    x32 = x.float()
    mean = torch.mean(x32, dim=1, keepdim=True)
    var = torch.var(x32, dim=1, keepdim=True, unbiased=False)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)
