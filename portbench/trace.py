"""The device trace of a traced window, read from torch.profiler's raw
records, and the host spans the benchmark opens around its calls into the
program's layers.

``trace_events`` and the busy union are frozen copies of what
``chip_smoke.py`` measured the port with (its ``trace_events`` and
``profile_device``); ``GEMM_NAMES`` is its list of what a library matrix
product's kernel name holds. A later change to the program or to that
script does not move them.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses

import torch

# what a library matrix product's kernel name holds (cuBLAS, cuBLASLt and
# its nvJet kernels, CUTLASS)
GEMM_NAMES = ("gemm", "cutlass", "xmma", "cublas", "nvjet")
WINDOW = "portbench.window"


def trace_events(result):
    """(device type, start us, end us, name, user annotation) of each event
    of a finished profiler's results, read from its raw records, without
    building their tree of CPU parents and children (which takes seconds a
    trace)."""
    from torch.autograd.profiler_util import _filter_name, _rewrite_name

    t0 = result.trace_start_ns()
    return [(e.device_type(), (e.start_ns() - t0) / 1e3, (e.end_ns() - t0) / 1e3,
             _rewrite_name(e.name(), with_wildcard=True), e.is_user_annotation())
            for e in result.events()
            if not _filter_name(e.name()) and not getattr(e, "is_hidden_event", bool)()]


def span(name: str):
    """A host span (a profiler user annotation) around a call into a layer;
    a no-op when no profiler records."""
    return torch.profiler.record_function(name)


class OpenSpan:
    """A host span opened in one hook and closed in another."""

    def __init__(self, name: str):
        self.name, self._rf = name, None

    def open(self, *_):
        self.close()
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()

    def close(self, *_):
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None


def union(intervals) -> float:
    """Length covered by (start, end) intervals sorted by start."""
    busy, cur_s, cur_e = 0.0, None, None
    for s0, e0 in intervals:
        if cur_e is None:
            cur_s, cur_e = s0, e0
        elif s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    return busy + (cur_e - cur_s if cur_e is not None else 0.0)


def gaps(intervals, lo: float, hi: float):
    """(start, end) stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for s0, e0 in intervals:
        if s0 > cur:
            out.append((cur, min(s0, hi)))
        cur = max(cur, e0)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


@dataclasses.dataclass
class Trace:
    """Device events (start us, end us, name) clipped to the window, the
    host spans (start us, end us, name), and the window (lo, hi) us."""

    device: list
    spans: list
    lo: float
    hi: float

    @classmethod
    def from_events(cls, events):
        """From :func:`trace_events`: device work only (a user annotation
        on the device's timeline spans the gaps between its kernels), and
        the benchmark's host spans."""
        cuda = torch.autograd.DeviceType.CUDA
        win = [(s, e) for kind, s, e, n, _ in events if kind != cuda and n == WINDOW]
        if not win:
            raise ValueError("the trace holds no window span")
        lo, hi = win[0]
        device = sorted((max(s, lo), min(e, hi), n) for kind, s, e, n, user in events
                        if kind == cuda and not user and e > lo and s < hi)
        spans = sorted((s, e, n) for kind, s, e, n, user in events
                       if kind != cuda and user and n.startswith("portbench.") and n != WINDOW)
        return cls(device, spans, lo, hi)

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    def kernels(self):
        return [d for d in self.device if not d[2].startswith(("Memcpy", "Memset"))]

    def memcpys(self):
        return [d for d in self.device if d[2].startswith("Memcpy")]

    def busy_s(self) -> float:
        return union((s, e) for s, e, _ in self.device) / 1e6

    def seconds(self, events) -> float:
        return sum(e - s for s, e, _ in events) / 1e6

    def matching(self, needles) -> list:
        return [d for d in self.kernels() if any(n in d[2] for n in needles)]

    def gemms(self):
        return [d for d in self.kernels() if any(g in d[2].lower() for g in GEMM_NAMES)]

    def open_span(self, t: float) -> str:
        """The innermost host span open at ``t`` (the latest started that
        has not ended), or ``outside_spans``."""
        i = bisect.bisect_right(self.spans, (t, float("inf"), "")) - 1
        for j in range(i, max(i - 4096, -1), -1):
            s, e, n = self.spans[j]
            if s <= t < e:
                return n
        return "outside_spans"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took the most time, and the idle time
        of the device summed by the host span open when each gap began."""
        by_name: dict = {}
        for s, e, n in self.device:
            by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
        idle: dict = {}
        for a, b in gaps([(s, e) for s, e, _ in self.device], self.lo, self.hi):
            n = self.open_span(a)
            idle[n] = idle.get(n, 0.0) + (b - a) / 1e6
        rank = lambda d: sorted(([k[:160], v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]
        return {"device_ops": rank(by_name), "idle_gaps": rank(idle)}


class Recording:
    """The profiler's results once the block of :func:`profiled` ended."""

    result = None


@contextlib.contextmanager
def profiled(enabled: bool):
    """The profiler over the block when enabled, yielding a
    :class:`Recording` (else None). It records the device's activity and,
    on the host, only the benchmark's own spans (user annotations): not
    every operator the host dispatches, which would slow the host's
    dispatch to the point of pacing the device."""
    if not enabled:
        yield None
        return
    from torch._C._profiler import (
        ProfilerActivity, ProfilerConfig, ProfilerState, RecordScope, _ExperimentalConfig)
    from torch.autograd import _disable_profiler, _enable_profiler, _prepare_profiler

    acts = {ProfilerActivity.CPU}
    if torch.cuda.is_available():
        acts.add(ProfilerActivity.CUDA)
    config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                            _ExperimentalConfig())
    _prepare_profiler(config, acts)
    _enable_profiler(config, acts, {RecordScope.USER_SCOPE})
    rec = Recording()
    try:
        yield rec
    finally:
        rec.result = _disable_profiler()


@dataclasses.dataclass
class Window:
    """What a traced run measured, for the per-layer readers. A traced run
    has two windows of ``--seconds`` each: first an untraced one, as in a
    run without tracing, then a traced one. ``trace``: the traced window's
    device trace (None where it holds no device activity); ``units``: the
    units of work it did (steps or device batches); ``posatt_bound_s``: the
    summed roofline bound of its position attention ops; ``flops``: the
    model's operations in the untraced window, ``untraced_s`` its length
    by the host's clock."""

    trace: Trace | None
    units: int
    posatt_bound_s: float
    flops: float
    untraced_s: float
