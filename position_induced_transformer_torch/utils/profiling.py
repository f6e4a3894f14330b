"""Tracing, profiling and numerics checks.

- :func:`trace`: a context manager around ``torch.profiler`` that writes
  a Chrome trace (host ops and, on a card, its kernels) into a directory;
  open ``trace.json`` in ``chrome://tracing`` or Perfetto.
- :class:`StepTimer`: wall-clock statistics of steady-state steps.
- :func:`posatt_flops`, :func:`pit_forward_flops`: analytic FLOP counts.
- :func:`debug_nans`: the training step raises ``FloatingPointError`` on
  the first non-finite loss or gradient. Off by default; off, the step
  reads nothing back from the device for it.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List, Optional

import torch

_DEBUG_NANS = False


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is present) and write ``logdir/trace.json``.
    The block must wait for its device work (read a result back) for the
    kernels to fall inside the trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def debug_nans(enable: bool = True) -> None:
    """Make every training step check its loss and gradients and raise
    ``FloatingPointError`` on the first non-finite one (a read-back of one
    flag per step while on)."""
    global _DEBUG_NANS
    _DEBUG_NANS = bool(enable)


def debug_nans_enabled() -> bool:
    return _DEBUG_NANS


def check_finite(loss: torch.Tensor, parameters: dict) -> None:
    """Raise ``FloatingPointError`` when ``loss`` or a gradient of the
    named ``parameters`` holds a NaN or an infinity, naming the first such
    tensor."""
    if not bool(torch.isfinite(loss).all()):
        raise FloatingPointError(f"non-finite training loss {loss.detach().cpu().tolist()}")
    for name, p in parameters.items():
        if p.grad is not None and not bool(torch.isfinite(p.grad).all()):
            raise FloatingPointError(f"non-finite gradient of parameter {name!r}")


class StepTimer:
    """Wall-clock step statistics, the first ``skip_first`` steps (warm-up,
    kernel builds) left out."""

    def __init__(self, skip_first: int = 1):
        self.skip_first = skip_first
        self.samples: List[float] = []
        self._seen = 0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen > self.skip_first:
            self.samples.append(dt)
        return False

    def stats(self) -> dict:
        if not self.samples:
            return {"n": 0}
        s = sorted(self.samples)
        n = len(s)
        return {
            "n": n,
            "mean_s": sum(s) / n,
            "p50_s": s[n // 2],
            "p95_s": s[min(n - 1, int(0.95 * n))],
            "min_s": s[0],
        }


def posatt_flops(L_out: int, L_in: int, n_head: int, d: int, batch: int) -> int:
    """FLOPs of one position-attention op: distance matrix + softmax
    (~7 flops/entry) + value contraction (2*B*H*Lo*Li*D)."""
    per_entry = 7 * n_head * L_out * L_in
    contraction = 2 * batch * n_head * L_out * L_in * d
    return per_entry + contraction


def pit_forward_flops(
    L_in: int,
    L_ltt: int,
    L_out: int,
    hid: int,
    n_head: int,
    n_blocks: int,
    in_dim: int,
    out_dim: int,
    batch: int,
) -> int:
    """Analytic forward-FLOP estimate for a PiT (encoder + processor +
    decoder, attention + MLPs)."""
    H = n_head
    f = posatt_flops(L_ltt, L_in, H, in_dim, batch)  # down
    f += 2 * batch * L_ltt * (H * in_dim * hid + hid * hid)  # en_layer
    for _ in range(n_blocks):
        f += posatt_flops(L_ltt, L_ltt, H, hid, batch)
        f += 2 * batch * L_ltt * ((1 + H) * hid * hid + hid * hid)
    f += posatt_flops(L_out, L_ltt, H, hid, batch)  # up
    f += 2 * batch * L_out * (H * hid * hid + hid * out_dim)  # de
    return f
