"""Arithmetic the per-layer readers share. Each reader (``metrics/<name>.py``)
returns None where its window holds nothing to read; a share of a roofline
or of a peak is never made up as 0."""

from __future__ import annotations

from portbench import peaks


def has_device(w) -> bool:
    return w is not None and w.trace is not None and bool(w.trace.device)


def per_unit(w, seconds: float):
    """``seconds`` of the traced window per unit of work, ms."""
    return 1e3 * seconds / w.units if w.units > 0 else None


def mfu(w):
    """The model's operations in the untraced window over its length at the
    float32 peak, %."""
    if w is None or w.flops <= 0 or w.untraced_s <= 0:
        return None
    return 100.0 * w.flops / (w.untraced_s * peaks.PEAK_F32_FLOPS)


def roofline(w, names) -> float | None:
    """The summed roofline bound of the traced window's position attention
    ops over the device time of the kernels named by ``names``, %."""
    if not has_device(w) or w.posatt_bound_s <= 0:
        return None
    t = w.trace.seconds(w.trace.matching(names))
    return 100.0 * w.posatt_bound_s / t if t > 0 else None


def idle(w):
    """The share of the traced window in which no operation ran on the
    device, %."""
    if not has_device(w):
        return None
    return 100.0 * (1.0 - w.trace.busy_s() / w.trace.window_s)
