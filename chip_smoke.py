#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py        # from the repository root; needs one GPU

Phases, each of which fails the run (non-zero exit, no result line):

1. environment: the card's name and power limit (nvidia-smi), torch, CUDA
   and nvcc versions; TF32 is switched off for matmuls and cuDNN, so the
   plain versions run in full float32;
2. build: every kernel of the port, from the sources in this checkout;
3. geometry: the Burgers geometry built on the card and on the CPU keep
   the same entries (21 per encoder row, 6 or 7 per decoder row, where the
   cut falls inside a tie);
4. kernels: each kernel's launcher against its plain PyTorch version, and
   its public wrapper (the call the model makes) against the model-level
   oracle, on the card, at the three Burgers shapes and at ragged shapes
   with 1 to 8 heads; times from CUDA events, the bound from the H100's
   published peaks and the work this run's inputs need, and one PyTorch
   library call computing the same function as a yardstick;
5. backward kernels: the stats, dscale and du kernels against their plain
   versions at the Burgers training shapes (dU is not needed at the
   encoder) and at ragged shapes with 1 to 8 heads, timed and bounded as
   in phase 4; the autograd Function's gradients against torch.autograd of
   the plain oracle, with one forward + backward launching each of the
   four kernels exactly once;
6. serve: a full-width Burgers model (random weights from a seeded
   generator) behind the port's HTTP server on the card, answering 1, 8
   and 13 samples, then 4 concurrent requests, then warm requests; every
   reply must be 200 and agree with the same model run with the plain
   attention on the card and with a CPU run; the forward kernel must have
   launched exactly 7 times per device batch and no backward kernel at all;
7. train: ``runner.train`` on full-width, full-depth Burgers on the card
   (synthetic data, 64 training and 16 test samples, 2 epochs of 8 steps);
   exactly 7/7/7/6 launches of the forward/stats/dscale/du kernels per
   step and 7 forward launches per eval batch; the per-step losses and the
   final weights agree with the same training with the plain attention on
   the card and with a CPU run; then the wall time per step, steps/s and
   the device's busy share of warm steps;
8. batched kernels: the per-sample-mesh forward (kernel #7) against its
   plain version at the full elasticity shapes (encoder 972 x (972 + 384)
   with its circular band, D 44; processor 972 x 972, all kept, D 256;
   decoder, band, D 256; the band-less serving encoder and decoder), with
   bands and thresholds from ``setup_elasticity`` on synthetic clouds, and
   at ragged shapes (1 to 8 heads, D 4 to 44, the kernel's own keep count,
   seam-crossing bands, L_out not a multiple of 256); the public wrapper
   against ``ops.posatt.position_attention`` on materialized distances;
   times, bounds and the SDPA yardstick as in phase 4;
9. batched backward: kernel #8's dscale and du entry points against their
   plain versions at the elasticity training shapes and the ragged ones,
   timed and bounded; dscale twice gives the same bits; the autograd
   Function's gradients against torch.autograd of the oracle, one forward
   + backward launching the forward and dscale once and du once where the
   values need a gradient;
10. elasticity serve: ``make_server("elasticity")`` on the card with a
    seeded random-weight checkpoint; ``.mat`` bodies holding ``x`` and
    ``mesh`` (1, 10, 13 samples, 4 concurrent, 20 warm); every reply 200
    and in agreement with a plain-attention card run and a CPU run; exactly
    6 launches of kernel #7 per device batch and no other kernel; a bare
    ``.npy`` gets 400;
11. elasticity train: ``runner.train("elasticity")`` at full width (80
    training and 20 test samples, 2 epochs of 8 steps at batch 10); exactly
    6/6/5 launches of the batched forward/dscale/du per step and 6 forward
    launches per eval batch; losses and weights against a plain-attention
    card run and a CPU run; the time per step, steps/s and the device's
    busy share.

The last line is ``{"ok": true, "device": {...}}``; the line before it the
``kernels`` record (six kernels: #1-#4 and the per-sample-mesh #7, #8),
and before that the ``elasticity_train``, ``elasticity_serve``, ``train``
and ``serve`` records.
"""

from __future__ import annotations

import io
import itertools
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from contextlib import nullcontext
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parent

# the H100 SXM's published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3

# kernel vs plain version, one op: both float32, sums in another order
OP_RTOL, OP_ATOL = 2e-5, 2e-6
# whole model: the op-level differences compound through 7 attention
# layers and 7 MLPs (the CPU tests hold the port to the JAX package here)
MODEL_RTOL, MODEL_ATOL = 1e-4, 1e-5
# the bandwidth gradient is a cancelling sum of L_out * B * D terms: held
# on terms normalised to unit size, at the bound tests/test_pallas.py holds
# the JAX fused backward to
DS_RTOL, DS_ATOL = 5e-4, 5e-6
# 16 Adam steps: each step divides a gradient by its own running magnitude,
# so a rounding difference in a near-zero gradient moves its weight by up to
# lr; the CPU tests hold the port's trajectory to the JAX package's here
# (tests/test_training_parity.py's bounds). Measured on the CPU, the
# closed-form backward and autograd of the oracle part by at most 8.2e-7
# over these 16 steps.
LOSS_RTOL = 2e-4
PARAM_RTOL, PARAM_ATOL = 5e-3, 2e-5

BURGERS_B = 8  # the serving batch
SLEEP_CYCLES = 10_000_000  # ~5 ms of spinning: longer than enqueueing 10 calls


def log(*args):
    print(*args, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check_close(name, got, want, rtol, atol, size=None):
    """Max abs error; fails when any element exceeds atol + rtol * size.
    ``size`` defaults to |want|; for a sum of signed terms pass the sum of
    their magnitudes: the rounding of a float32 sum scales with those, not
    with its (cancelled) result."""
    import torch

    got, want = got.double().cpu(), want.double().cpu()
    size = want.abs() if size is None else size.double().cpu()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite values")
    err = (got - want).abs()
    bad = err > atol + rtol * size
    if bad.any():
        fail(f"{name}: {int(bad.sum())} elements outside rtol {rtol} atol {atol}; "
             f"max abs err {err.max().item():.3e}")
    return err.max().item()


def cuda_ms(fn, reps=20, per_rep=10, warmup=5):
    """Median device time of one call, from CUDA events around ``per_rep``
    back-to-back calls. A spin kernel (``torch.cuda._sleep``) holds the
    stream while the host enqueues them, so the events time the device's
    work and not the host's launch overhead."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(per_rep):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_rep)
    return statistics.median(times)


def profile_device(fn, unit, reps=5):
    """Wall time and device busy time of warm calls of ``fn``, from
    torch.profiler: the union of the CUDA activity intervals over the
    host's wall clock, and device time by kernel, per call. None where the
    trace holds no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    # device work only: a user annotation (the optimizer's step range)
    # spans the gaps between its kernels
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation
    )
    if not spans:
        return {f"wall_ms_per_{unit}": wall_ms, f"device_busy_ms_per_{unit}": None}
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    by_name: dict = {}
    for s0, e0, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (e0 - s0)
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    busy_ms = busy / 1e3 / reps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {
        f"wall_ms_per_{unit}": wall_ms,
        f"device_busy_ms_per_{unit}": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        f"device_ms_per_{unit}_by_kernel": {n[:80]: t / 1e3 / reps for n, t in top},
    }


def environment():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    log(smi[0])
    from position_induced_transformer_torch.kernels import _build

    nvcc = subprocess.run(
        [_build.nvcc_path(), "--version"], capture_output=True, text=True,
        check=True, timeout=60,
    ).stdout.strip().splitlines()[-1]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc: {nvcc}")
    log(f"device: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    log("tf32: matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}")
    return smi[0]


def build():
    from position_induced_transformer_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()  # one nvcc per source, all at once
    for name in _build.KERNELS:
        _build.load(name)
    log(f"build: {len(_build.KERNELS)} kernel source(s) in {time.perf_counter() - t0:.2f} s "
        f"into {_build.BUILD_DIR.relative_to(REPO)}")


def burgers_geometry(device):
    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.data import meshes
    from position_induced_transformer_torch.models import build_geometry

    cfg = configs.BURGERS
    mesh = meshes.grid_1d(cfg.grid[0])
    ltt = meshes.grid_1d(cfg.latent_grid[0])
    return build_geometry(
        mesh, ltt, mesh, metric=cfg.metric, en_loc=cfg.model.en_loc,
        de_loc=cfg.model.de_loc, device=device,
    )


def geometry_phase():
    import torch

    gg, gc = burgers_geometry("cuda"), burgers_geometry("cpu")
    torch.cuda.synchronize()
    report = {}
    for name in ("dist_down", "dist_proc", "dist_up", "thr_down", "thr_up"):
        report[f"max_abs_diff_{name}"] = (
            (getattr(gg, name).cpu() - getattr(gc, name)).abs().max().item()
        )
    for side in ("down", "up"):
        kg = (getattr(gg, f"dist_{side}") <= getattr(gg, f"thr_{side}")).cpu()
        kc = getattr(gc, f"dist_{side}") <= getattr(gc, f"thr_{side}")
        n_diff = int((kg != kc).any(dim=1).sum())
        report[f"rows_kept_differently_{side}"] = n_diff
        if n_diff:
            fail(f"geometry: {n_diff} {side} rows keep other entries on CUDA than on the CPU")
        counts = kg.sum(dim=1)
        report[f"kept_per_row_{side}"] = sorted(set(counts.tolist()))
    if report["kept_per_row_down"] != [21]:
        fail(f"geometry: encoder rows keep {report['kept_per_row_down']}, expected 21")
    if report["kept_per_row_up"] != [6, 7]:
        fail(f"geometry: decoder rows keep {report['kept_per_row_up']}, expected 6 or 7")
    log("geometry " + json.dumps(report))
    return gg


def roofline(flops, nbytes):
    """Least time in ms for ``flops`` f32 operations and ``nbytes`` bytes of
    device memory traffic, and which of the two bounds it."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def kept_entries(dist, thr):
    return int(((dist <= thr) & (dist < float("inf"))).sum())


def bound(dist, thr, H, B, D):
    """Least time for the forward on these inputs: each input read once,
    the output written once, and 2*H*B*D operations per kept entry (a
    masked weight is exactly 0, so a masked entry needs none)."""
    Lo, Li = dist.shape
    kept = kept_entries(dist, thr)
    flops = 2 * H * B * D * kept
    nbytes = 4 * (Lo * Li + Lo + Li * B * D + H * Lo * B * D)
    return (*roofline(flops, nbytes), flops, nbytes, kept)


def bound_bwd(kernel, dist, thr, H, B, D):
    """Least time for a backward kernel on these inputs, counted as
    :func:`bound` counts the forward. All read dist, thr and scale. Stats
    writes M and L, 5*H operations per kept entry (scale, max, subtract,
    exp, add). dscale and du read M, L and the (B, L_out, H*D) cotangent;
    dscale reads the values and writes H numbers, du writes dU; both do
    2*H*B*D operations per kept entry."""
    Lo, Li = dist.shape
    kept = kept_entries(dist, thr)
    base = Lo * Li + Lo + H
    if kernel == "posatt_stats":
        flops, words = 5 * H * kept, base + 2 * H * Lo
    else:
        flops = 2 * H * B * D * kept
        words = base + 2 * H * Lo + B * Lo * H * D + B * Li * D
        words += H if kernel == "posatt_bwd_dscale" else 0
    return (*roofline(flops, 4 * words), flops, 4 * words, kept)


RAGGED = [  # L not a multiple of any tile; 1, 2, 4 and 8 heads; N = B*D
    # ragged, on both sides of the kernels' B*D <= 32 tile choice
    ("ragged_h1_masked", 97, 1000, 3, 1, 5, 0.02),
    ("ragged_h8_global", 1000, 97, 2, 8, 33, 1.0),
    ("ragged_h8_masked", 33, 65, 1, 8, 64, 0.1),
    ("ragged_h2_wide", 70, 300, 8, 2, 100, 0.3),
    ("ragged_h8_narrow", 50, 300, 4, 8, 4, 0.2),
    ("ragged_h4_narrow", 300, 50, 3, 4, 9, 1.0),
]


def ragged_dist(rng, Lo, Li):
    import numpy as np
    import torch

    from position_induced_transformer_torch.ops import distances

    to = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()
    return distances.euclidean_sq(to(rng.random((Lo, 2))), to(rng.random((Li, 2))))


def kernel_phase(geom):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.kernels import posatt_pallas as kp
    from position_induced_transformer_torch.ops import locality, posatt

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    hid, H = configs.BURGERS.model.hid_dim, configs.BURGERS.model.n_head
    in_dim = configs.BURGERS.model.in_dim + configs.BURGERS.model.space_dim

    def case(dist, loc, thr, H, B, D):
        """Inputs of one call: the wrapper's (dist, lmda, u, loc, thr) and
        the launcher's (dist, thr, scale, u), with thr and scale prepared
        as the wrapper prepares them."""
        Lo, Li = dist.shape
        lmda = torch.from_numpy(rng.random((H, 1, 1)).astype(np.float32)).to(dev)
        u = torch.from_numpy(rng.standard_normal((B, Li, D)).astype(np.float32)).to(dev)
        if loc >= 1:
            full_thr = torch.full((Lo, 1), float("inf"), device=dev)
        else:
            full_thr = thr if thr is not None else locality.quantile_threshold(dist, loc)
        scale = posatt.bandwidth_scale(lmda).reshape(H, 1)
        return (dist, lmda, u, loc, thr), (dist, full_thr, scale, u)

    def plain_concat(dist, thr, scale, u):
        B, _, D = u.shape
        out = kp.posatt_fixed_reference(dist, thr, scale, u)
        return out.permute(1, 2, 0, 3).reshape(B, dist.shape[0], -1)

    def compare(name, wrapper_args, args):
        """The launcher against the kernel's plain version, and the public
        wrapper against the model-level oracle; the larger error."""
        got = kp.posatt_fixed_cuda(*args)
        torch.cuda.synchronize()
        want = plain_concat(*args)
        torch.cuda.synchronize()
        err = check_close(name, got, want, OP_RTOL, OP_ATOL)
        dist, lmda, u, loc, thr = wrapper_args
        before = kp.posatt_fixed_cuda.launches
        got = kp.position_attention_fixed(dist, lmda, u, loc, thr=thr)
        torch.cuda.synchronize()
        if kp.posatt_fixed_cuda.launches != before + 1:
            fail(f"{name}: position_attention_fixed did not launch the kernel once")
        want = posatt.position_attention(dist, lmda, u, loc, thr=thr)
        torch.cuda.synchronize()
        return max(err, check_close(f"{name} (wrapper)", got, want, OP_RTOL, OP_ATOL))

    m = configs.BURGERS.model
    burgers = {
        # name: (wrapper args, launcher args, launches per forward)
        "encoder": (*case(geom.dist_down, m.en_loc, geom.thr_down, H, BURGERS_B, in_dim), 1),
        "processor": (*case(geom.dist_proc, 1.0, None, H, BURGERS_B, hid), m.n_blocks),
        "decoder": (*case(geom.dist_up, m.de_loc, geom.thr_up, H, BURGERS_B, hid), 1),
    }
    errs = []
    shapes = []
    for name, (wrapper_args, args, per_forward) in burgers.items():
        dist, thr, scale, u = args
        Lo, Li = dist.shape
        B, _, D = u.shape
        err = compare(name, wrapper_args, args)
        errs.append(err)
        ms = cuda_ms(lambda: kp.posatt_fixed_cuda(*args))
        plain_ms = cuda_ms(lambda: plain_concat(*args))
        # yardstick: one SDPA call with zero q and k, so that softmax(mask)
        # @ v is the same function; the logits are built outside the timing
        keep = (dist <= thr) & (dist < float("inf"))
        logits = torch.where(keep, -dist[None] * scale[:, :, None], -1e38)[None]
        q = torch.zeros((B, H, Lo, D), device=dev)
        k = torch.zeros((B, H, Li, D), device=dev)
        v = u[:, None].expand(B, H, Li, D).contiguous()
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=logits)
        # reported, not held: the yardstick is not part of the port
        lib_err = (
            sdpa().permute(0, 2, 1, 3).reshape(B, Lo, H * D) - plain_concat(*args)
        ).abs().max().item()
        library_ms = cuda_ms(sdpa)
        bound_ms, bound_by, flops, nbytes, kept = bound(dist, thr, H, B, D)
        shapes.append({
            "shape": name, "H": H, "L_out": Lo, "L_in": Li, "B": B, "D": D,
            "kept_entries": kept,
            "launches_per_forward": per_forward, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_max_abs_err": lib_err, "bound_ms": bound_ms,
            "bound_by": bound_by, "flops": flops, "bytes": nbytes,
        })
        log(f"kernel {name}: {json.dumps(shapes[-1])}")

    for name, Lo, Li, B, Hr, D, loc in RAGGED:
        dist = ragged_dist(rng, Lo, Li)
        # thr missing: the wrapper computes the quantile itself
        err = compare(name, *case(dist, loc, None, Hr, B, D))
        errs.append(err)
        log(f"kernel {name}: H={Hr} L_out={Lo} L_in={Li} B={B} D={D} max_abs_err={err:.3e}")
    return shapes, max(errs)


BWD_KERNELS = ("posatt_stats", "posatt_bwd_dscale", "posatt_bwd_du")


FIXED_KERNELS = ("posatt_fixed_fwd",) + BWD_KERNELS
BATCHED_KERNELS = ("posatt_batched_fwd", "posatt_batched_bwd_dscale", "posatt_batched_bwd_du")


def launchers():
    """The seven launchers, by kernel entry point; each counts its launches."""
    from position_induced_transformer_torch.kernels import posatt_batched as kb
    from position_induced_transformer_torch.kernels import posatt_pallas as kp

    return {
        "posatt_fixed_fwd": kp.posatt_fixed_cuda,
        "posatt_stats": kp.posatt_stats_cuda,
        "posatt_bwd_dscale": kp.posatt_bwd_dscale_cuda,
        "posatt_bwd_du": kp.posatt_bwd_du_cuda,
        "posatt_batched_fwd": kb.posatt_batched_cuda,
        "posatt_batched_bwd_dscale": kb.posatt_batched_bwd_dscale_cuda,
        "posatt_batched_bwd_du": kb.posatt_batched_bwd_du_cuda,
    }


def counts():
    return {name: fn.launches for name, fn in launchers().items()}


def zero_counts():
    for fn in launchers().values():
        fn.launches = 0


def backward_kernel_phase(geom):
    """Each backward kernel against its plain version, timed and bounded at
    the Burgers training shapes; at ragged shapes; and the autograd
    Function's gradients against torch.autograd of the plain oracle."""
    import numpy as np
    import torch

    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.kernels import posatt_pallas as kp
    from position_induced_transformer_torch.ops import locality, posatt

    rng = np.random.default_rng(1)
    dev = torch.device("cuda")
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    m = configs.BURGERS.model
    H, B = m.n_head, BURGERS_B

    def inputs(dist, thr, H, B, D):
        lmda = to(rng.random((H, 1, 1)))
        u = to(rng.standard_normal((B, dist.shape[1], D)))
        g = to(rng.standard_normal((B, dist.shape[0], H * D)))
        return lmda, u, g, posatt.bandwidth_scale(lmda).reshape(H, 1)

    def compare(name, dist, thr, scale, u, g, with_du=True):
        """Each launcher against its plain version; max abs error by kernel."""
        M, L = kp.posatt_stats_cuda(dist, thr, scale)
        Mp, Lp = kp.posatt_stats_reference(dist, thr, scale)
        torch.cuda.synchronize()
        errs = {"posatt_stats": max(
            check_close(f"{name} stats M", M, Mp, OP_RTOL, OP_ATOL),
            check_close(f"{name} stats L", L, Lp, OP_RTOL, OP_ATOL),
        )}
        ds = kp.posatt_bwd_dscale_cuda(dist, thr, scale, M, L, g, u)
        again = kp.posatt_bwd_dscale_cuda(dist, thr, scale, M, L, g, u)
        torch.cuda.synchronize()
        if not torch.equal(ds, again):
            fail(f"{name}: two dscale runs on the same inputs differ")
        want = kp.posatt_bwd_dscale_reference(dist, thr, scale, Mp, Lp, g, u)
        # the size of the summed terms, per head: sum_i |w_i| + |r_i v_i|
        keep = (dist <= thr) & (dist < float("inf"))
        p = torch.where(keep, torch.exp(-dist[None] * scale[:, :, None] - Mp), 0.0) / Lp
        Bq, Lo, HD = g.shape
        t = torch.einsum("bihk,bjk->hij", g.reshape(Bq, Lo, -1, u.shape[-1]), u)
        d = torch.where(keep, dist, 0.0)
        size = ((p * t * d).sum(-1).abs()
                + (p * t).sum(-1).abs() * (p * d).sum(-1)).sum(-1, keepdim=True)
        check_close(f"{name} dscale (normalised)", ds / size, want / size, DS_RTOL, DS_ATOL)
        errs["posatt_bwd_dscale"] = (ds - want).abs().max().item()
        if with_du:
            du = kp.posatt_bwd_du_cuda(dist, thr, scale, M, L, g)
            torch.cuda.synchronize()
            want = kp.posatt_bwd_du_reference(dist, thr, scale, Mp, Lp, g)
            size = kp.posatt_bwd_du_reference(dist, thr, scale, Mp, Lp, g.abs())
            errs["posatt_bwd_du"] = check_close(f"{name} du", du, want, OP_RTOL, OP_ATOL, size)
        return errs, (M, L)

    def function_check(name, dist, lmda, u, loc, thr):
        """One forward + backward through position_attention_fixed launches
        each kernel once, and its gradients match autograd of the oracle."""
        w = to(rng.standard_normal((u.shape[0], dist.shape[0], lmda.shape[0] * u.shape[-1])))

        def grads(fn, w):
            lm = lmda.clone().requires_grad_(True)
            x = u.clone().requires_grad_(True)
            out = fn(dist, lm, x, loc, thr=thr)
            (out * w).sum().backward()
            return out.detach(), lm.grad, x.grad

        before = counts()
        got = grads(kp.position_attention_fixed, w)
        torch.cuda.synchronize()
        after = counts()
        if any(after[k] - before[k] != (k in FIXED_KERNELS) for k in after):
            fail(f"{name}: one forward + backward launched "
                 f"{ {k: after[k] - before[k] for k in after} }, expected 1 each")
        oracle = lambda *a, thr=None: posatt.position_attention(*a, thr=thr)
        want = grads(oracle, w)
        size_u = grads(oracle, w.abs())[2]
        return max(
            check_close(f"{name} Function out", got[0], want[0], OP_RTOL, OP_ATOL),
            check_close(f"{name} Function d lmda", got[1], want[1], DS_RTOL,
                        DS_ATOL * want[1].abs().max().item()),
            check_close(f"{name} Function d u", got[2], want[2], OP_RTOL, OP_ATOL, size_u),
        )

    in_dim = m.in_dim + m.space_dim
    inf = lambda Lo: torch.full((Lo, 1), float("inf"), device=dev)
    burgers = [
        # name, dist, thr, D, launches per step of stats/dscale, of du
        ("encoder", geom.dist_down, geom.thr_down, in_dim, 1, 0),
        ("processor", geom.dist_proc, inf(geom.dist_proc.shape[0]), m.hid_dim, m.n_blocks, m.n_blocks),
        ("decoder", geom.dist_up, geom.thr_up, m.hid_dim, 1, 1),
    ]
    rows = {k: [] for k in BWD_KERNELS}
    errs = {k: 0.0 for k in BWD_KERNELS}
    fn_err = 0.0
    for name, dist, thr, D, n23, n4 in burgers:
        lmda, u, g, scale = inputs(dist, thr, H, B, D)
        e, (M, L) = compare(name, dist, thr, scale, u, g, with_du=n4 > 0)
        for k, v in e.items():
            errs[k] = max(errs[k], v)
        calls = {
            "posatt_stats": (lambda: kp.posatt_stats_cuda(dist, thr, scale),
                             lambda: kp.posatt_stats_reference(dist, thr, scale), n23),
            "posatt_bwd_dscale": (lambda: kp.posatt_bwd_dscale_cuda(dist, thr, scale, M, L, g, u),
                                  lambda: kp.posatt_bwd_dscale_reference(dist, thr, scale, M, L, g, u), n23),
            "posatt_bwd_du": (lambda: kp.posatt_bwd_du_cuda(dist, thr, scale, M, L, g),
                              lambda: kp.posatt_bwd_du_reference(dist, thr, scale, M, L, g), n4),
        }
        for kernel, (launch, plain, per_step) in calls.items():
            if not per_step:
                continue
            bound_ms, bound_by, flops, nbytes, kept = bound_bwd(kernel, dist, thr, H, B, D)
            rows[kernel].append({
                "shape": name, "H": H, "L_out": dist.shape[0], "L_in": dist.shape[1],
                "B": B, "D": D, "kept_entries": kept, "launches_per_step": per_step,
                "max_abs_err": e[kernel], "ms": cuda_ms(launch), "plain_ms": cuda_ms(plain),
                # no one PyTorch call computes any of these three functions
                "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
                "flops": flops, "bytes": nbytes,
            })
            log(f"kernel {kernel} {name}: {json.dumps(rows[kernel][-1])}")
        if name != "encoder":  # the encoder's values need no gradient
            loc = m.de_loc if name == "decoder" else 1.0
            fn_err = max(fn_err, function_check(
                name, dist, lmda, u, loc, None if loc >= 1 else thr))

    for name, Lo, Li, Bq, Hr, D, loc in RAGGED:
        dist = ragged_dist(rng, Lo, Li)
        thr = inf(Lo) if loc >= 1 else locality.quantile_threshold(dist, loc)
        lmda, u, g, scale = inputs(dist, thr, Hr, Bq, D)
        e, _ = compare(name, dist, thr, scale, u, g)
        for k, v in e.items():
            errs[k] = max(errs[k], v)
        fn_err = max(fn_err, function_check(name, dist, lmda, u, loc, None))
        log(f"backward {name}: H={Hr} L_out={Lo} L_in={Li} B={Bq} D={D} "
            f"max_abs_err={json.dumps(e)}")
    log(f"Function: gradients match autograd of the oracle, max abs err {fn_err:.3e}")
    return rows, errs


def train_phase():
    """runner.train on full-width Burgers on the card, with the kernels;
    again with the plain attention on the card, and on the CPU; then the
    time per step and the device's busy share of warm steps."""
    import numpy as np
    import torch

    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.models import pit
    from position_induced_transformer_torch.ops.posatt import position_attention

    cfg = configs.BURGERS
    epochs, ntrain, ntest = 2, 64, 16
    plain = lambda dist, lmda, inputs, locality, thr=None: position_attention(
        dist, lmda, inputs, locality, thr=thr)

    problem, state, history, losses, weights, launched, seconds = run_training(
        cfg, "cuda", epochs, ntrain, ntest)
    steps = state.step
    eval_batches = epochs * -(-ntest // cfg.batch_size)
    per_step = {"posatt_fixed_fwd": 7, "posatt_stats": 7, "posatt_bwd_dscale": 7, "posatt_bwd_du": 6}
    expected = {k: per_step.get(k, 0) * steps for k in launchers()}
    expected["posatt_fixed_fwd"] += 7 * eval_batches
    if steps != epochs * ntrain // cfg.batch_size or launched != expected:
        fail(f"train: {steps} steps, {eval_batches} eval batches launched {launched}; "
             f"expected {expected} (7/7/7/6 per step, 7 forward per eval batch)")
    if not torch.isfinite(losses).all() or not all(
        np.isfinite(v) for row in history for v in row.values()
    ):
        fail(f"train: non-finite losses or metrics: {history}")

    report = {
        "config": cfg.name, "epochs": epochs, "ntrain": ntrain, "ntest": ntest,
        "steps": steps, "eval_batches": eval_batches, "launches": launched,
        "seconds_whole_run_cuda": seconds, "history": history,
        "step_losses_first_last": [losses[0].item(), losses[-1].item()],
    }
    patch = mock.patch.object(pit, "position_attention_fixed", plain)
    for device, p, label in (("cuda", patch, "plain_cuda"), ("cpu", None, "cpu")):
        _, _, _, ref_losses, ref_weights, ref_launched, ref_s = run_training(
            cfg, device, epochs, ntrain, ntest, p)
        if any(ref_launched.values()):
            fail(f"train: the {label} run launched kernels: {ref_launched}")
        report[f"max_abs_err_step_loss_vs_{label}"] = check_close(
            f"train losses vs {label}", losses, ref_losses, LOSS_RTOL, 0.0)
        report[f"max_abs_err_weights_vs_{label}"] = max(
            check_close(f"train weight {k} vs {label}", v, ref_weights[k], PARAM_RTOL, PARAM_ATOL)
            for k, v in weights.items())
        report[f"seconds_whole_run_{label}"] = ref_s
    report.update(step_timing(problem, state, cfg.batch_size, ntrain, cfg.lr))
    return report


def post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def npy(a):
    import numpy as np

    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def serve_phase():
    import numpy as np
    import torch

    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.data import synthetic
    from position_induced_transformer_torch.kernels import posatt_pallas as kp
    from position_induced_transformer_torch.models import pit
    from position_induced_transformer_torch.ops.posatt import position_attention
    from position_induced_transformer_torch.train import benchmarks, checkpoint
    from position_induced_transformer_torch.train.evaluate import Predictor
    from position_induced_transformer_torch.train.serve import make_server

    cfg = configs.BURGERS
    model = benchmarks._make_model(cfg, torch.Generator().manual_seed(0))
    ckpt = checkpoint.save(
        str(REPO / "build" / "chip_smoke" / "burgers.pt"), model.state_dict(), cfg.name
    )
    server = make_server(cfg.name, ckpt, host="127.0.0.1", port=0, verbose=False, device="cuda")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/predict"
    x, _ = synthetic.burgers(n=48, L=cfg.grid[0], seed=1)
    sent = []  # (input, reply)

    def ask(a):
        code, body = post(url, npy(a))
        if code != 200:
            fail(f"serve: HTTP {code} for {a.shape[0]} samples: {body[:500]!r}")
        out = np.load(io.BytesIO(body))
        sent.append((a, out))
        return out

    try:
        zero_counts()
        calls0 = server.batcher.n_calls
        t0 = time.perf_counter()
        ask(x[:1])
        first_ms = (time.perf_counter() - t0) * 1e3
        ask(x[1:9])
        ask(x[9:22])  # 13 samples: one full and one padded batch
        threads = [
            threading.Thread(target=ask, args=(x[22 + 3 * i : 25 + 3 * i],))
            for i in range(4)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if any(t.is_alive() for t in threads) or len(sent) != 7:
            fail("serve: concurrent requests did not all complete")
        warm = []
        for i in range(20):
            a = x[8 * (i % 6) : 8 * (i % 6) + 8]
            t0 = time.perf_counter()
            ask(a)
            warm.append((time.perf_counter() - t0) * 1e3)
        launched = counts()
        launches = launched["posatt_fixed_fwd"]
        device_calls = server.batcher.n_calls - calls0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)

    if launches != 7 * device_calls or device_calls < 25:
        fail(f"serve: {launches} kernel launches for {device_calls} device batches "
             "(expected exactly 7 per batch)")
    if any(launched[k] for k in launched if k != "posatt_fixed_fwd"):
        fail(f"serve: other kernels than the forward launched while serving: {launched}")

    # the same model with the plain attention on the card, and on the CPU
    predictor = server.predictor

    def plain_attention(dist, lmda, inputs, locality, thr=None):
        return position_attention(dist, lmda, inputs, locality, thr=thr)

    cpu = Predictor(cfg.name, ckpt, device="cpu")
    err_plain = err_cpu = 0.0
    with mock.patch.object(pit, "position_attention_fixed", plain_attention):
        for a, out in sent:
            before = kp.posatt_fixed_cuda.launches
            ref = torch.from_numpy(predictor.predict_array({"x": a}))
            if kp.posatt_fixed_cuda.launches != before:
                fail("serve: the plain comparison run launched the kernel")
            got = torch.from_numpy(out)
            if got.shape != (a.shape[0], cfg.grid[0], cfg.model.out_dim):
                fail(f"serve: reply shape {tuple(got.shape)}")
            err_plain = max(err_plain, check_close("serve vs plain on CUDA", got, ref, MODEL_RTOL, MODEL_ATOL))
            ref_cpu = torch.from_numpy(cpu.predict_array({"x": a}))
            err_cpu = max(err_cpu, check_close("serve vs CPU", got, ref_cpu, MODEL_RTOL, MODEL_ATOL))
    report = {
        "profile_8_samples": profile_device(
            lambda: predictor.predict_array({"x": x[:BURGERS_B]}), "forward"
        ),
        "requests": len(sent), "samples": int(sum(a.shape[0] for a, _ in sent)),
        "device_batches": device_calls, "kernel_launches": launches,
        "first_request_ms": first_ms, "warm_median_ms": statistics.median(warm),
        "warm_requests": len(warm), "warm_samples_per_request": 8,
        "max_abs_err_vs_plain_cuda": err_plain, "max_abs_err_vs_cpu": err_cpu,
    }
    return report


# ------------------------------------------------ elasticity: kernels #7, #8

ELASTICITY_B = 10  # the training and serving batch

RAGGED_BATCHED = [  # B, L_q, L_k, H, D, locality, thresholds: "none" (the
    # kernel's own keep count, or global), "robust" (precomputed) or "ring"
    # (an angle-sorted ring with a circular band)
    ("b_h2_keep7", 2, 64, 64, 2, 8, 0.1, "none"),
    ("b_h1_global", 2, 64, 64, 1, 8, 1.0, "none"),
    ("b_h2_d19", 3, 37, 53, 2, 19, 0.1, "none"),
    ("b_h1_keep3", 2, 300, 120, 1, 4, 0.02, "none"),
    ("b_h4_d44", 2, 300, 120, 4, 44, 0.1, "robust"),
    ("b_h8_d19", 1, 97, 1000, 8, 19, 0.02, "robust"),
    ("b_ring_seam", 2, 900, 700, 2, 8, 0.02, "ring"),
    ("b_ring_h8_lout1000", 2, 1000, 800, 8, 33, 0.02, "ring"),
]


def ring_cloud(rng, B, L):
    import numpy as np

    th = np.sort(rng.uniform(0, 2 * np.pi, (B, L)), axis=1)
    rad = 1.0 + 0.1 * rng.random((B, 1))
    return np.stack([rad * np.cos(th), rad * np.sin(th)], -1).astype(np.float32)


def batched_case(rng, mq, mk, u, loc, thr, band, H):
    """Inputs of one batched call: the launcher's (mq, mk, scale, u, thr,
    starts, keep_count, width) on the extended key axis, prepared as the
    wrapper prepares them, and the wrapper's (mq, mk, lmda, u, loc, thr,
    band)."""
    import numpy as np
    import torch

    from position_induced_transformer_torch.ops import locality, posatt

    lmda = torch.from_numpy(rng.random((H, 1, 1)).astype(np.float32)).to(mq.device)
    scale = posatt.bandwidth_scale(lmda).reshape(H, 1)
    mk_e, u_e = mk, u
    if band is not None and band.wrap:
        mk_e = torch.cat([mk, mk[:, : band.wrap]], 1)
        u_e = torch.cat([u, u[:, : band.wrap]], 1)
    launch = (mq, mk_e, scale, u_e, thr, None if band is None else band.starts,
              locality.topk_keep_count(mk.shape[1], loc), 0 if band is None else band.width)
    return launch, (mq, mk, lmda, u, loc, thr, band)


def ragged_batched(rng, B, Lq, Lk, H, D, loc, kind):
    import numpy as np
    import torch

    from position_induced_transformer_torch.kernels import posatt_batched as kb
    from position_induced_transformer_torch.ops import locality

    to = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()
    if kind == "ring":
        mq, mk = to(ring_cloud(rng, B, Lq)), to(ring_cloud(rng, B, Lk))
    else:
        mq, mk = to(rng.random((B, Lq, 2))), to(rng.random((B, Lk, 2)))
    u = to(rng.random((B, Lk, D)))
    thr = band = None
    if kind != "none":
        thr = locality.batched_topk_thresholds(mq, mk, loc)
    if kind == "ring":
        starts, width, wrap = locality.batched_band_starts(
            mq, mk, thr, kb.band_tile_rows(Lq), circular=True)
        if not (starts.numpy() + width > Lk).any():
            fail(f"ring case {B}x{Lq}x{Lk}: no band crosses the seam")
        band = kb.BandSpec(starts.cuda(), width, wrap)
    return batched_case(rng, mq, mk, u, loc, thr, band, H)


def batched_oracle(mq, mk, lmda, u, loc, thr=None, band=None):
    """ops.posatt.position_attention on materialized distances: the band
    holds every kept column, so the oracle needs none."""
    from position_induced_transformer_torch.ops import distances, locality, posatt

    dist = distances.euclidean_sq(mq, mk)
    if thr is None and loc < 1:
        thr = locality.topk_threshold(dist, loc)
    return posatt.position_attention(dist, lmda, u, loc, thr=thr)


def elasticity_shapes(rng):
    """The attention calls of full-width elasticity on its first training
    batch as setup_elasticity prepares it (angle-sorted synthetic clouds,
    thresholds, circular band starts), and of a served batch (thresholds
    from robust_topk_threshold, no band): name -> (launcher args, wrapper
    args, launches per forward)."""
    import numpy as np
    import torch

    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.ops import distances, locality
    from position_induced_transformer_torch.train import benchmarks

    cfg = configs.ELASTICITY
    m = cfg.model
    problem = benchmarks.setup_elasticity(cfg, ntrain=ELASTICITY_B, ntest=2, device="cuda")
    batch = {k: torch.from_numpy(v).cuda() for k, v in problem.train_data.items()}
    geom = problem.task.geom_fn(batch)
    mesh, x, band = batch["mesh"], batch["x"], geom.band_down
    hid = torch.from_numpy(rng.standard_normal((ELASTICITY_B, mesh.shape[1], m.hid_dim))
                           .astype(np.float32)).cuda()
    serve_thr = locality.robust_topk_threshold(distances.euclidean_sq(mesh, mesh), m.en_loc)
    H = m.n_head
    shapes = {
        "encoder": (*batched_case(rng, mesh, mesh, x, m.en_loc, geom.thr_down, band, H), 1),
        "processor": (*batched_case(rng, mesh, mesh, hid, 1.0, None, None, H), m.n_blocks),
        "decoder": (*batched_case(rng, mesh, mesh, hid, m.de_loc, geom.thr_up, geom.band_up, H), 1),
        "serve_encoder": (*batched_case(rng, mesh, mesh, x, m.en_loc, serve_thr, None, H), 1),
        "serve_decoder": (*batched_case(rng, mesh, mesh, hid, m.de_loc, serve_thr, None, H), 1),
    }
    info = {"band_width": band.width, "band_wrap": band.wrap,
            "band_starts_sample0": band.starts[0].tolist()}
    return shapes, info


def batched_work(args, keep=None):
    """What the forward must do on these inputs: the distances it inspects
    (every column of each row's window), the kept entries, and the bytes it
    must move (coordinates, thresholds, starts, values, output, each once)."""
    from position_induced_transformer_torch.kernels import posatt_batched as kb

    mq, mk, scale, u, thr, starts, kc, width = args
    B, Lo, d = mq.shape
    Li, D = u.shape[1:]
    if keep is None:
        keep = kb._rows(mq, mk, thr, starts, kc, width)[1]
    win = kb._window(starts, width, Lo, Li, mq.device)
    inspected = B * Lo * Li if win is None else int(win.sum())
    words = B * Lo * d + B * Li * d + B * Li * D + B * Lo * scale.shape[0] * D
    words += (B * Lo if thr is not None else 0) + (starts.numel() if starts is not None else 0)
    return inspected, int(keep.sum()), 4 * words


def batched_kernel_phase():
    """Kernel #7 against its plain version at the elasticity shapes and at
    ragged ones, the public wrapper against the oracle on materialized
    distances; times, bounds and the SDPA yardstick at the elasticity
    shapes."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from position_induced_transformer_torch.kernels import posatt_batched as kb

    rng = np.random.default_rng(3)

    def compare(name, args, wargs):
        mq, mk, scale, u, thr, starts, kc, width = args
        kw = dict(keep_count=kc, width=width)
        got = kb.posatt_batched_cuda(mq, mk, scale, u, thr, starts, **kw)
        torch.cuda.synchronize()
        want = kb.posatt_batched_reference(mq, mk, scale, u, thr, starts, **kw)
        torch.cuda.synchronize()
        err = check_close(name, got, want, OP_RTOL, OP_ATOL)
        before = kb.posatt_batched_cuda.launches
        with torch.no_grad():
            got = kb.position_attention_batched(*wargs)
        torch.cuda.synchronize()
        if kb.posatt_batched_cuda.launches != before + 1:
            fail(f"{name}: position_attention_batched did not launch the kernel once")
        want = batched_oracle(*wargs)
        return max(err, check_close(f"{name} (wrapper)", got, want, OP_RTOL, OP_ATOL)), want

    shapes, info = elasticity_shapes(rng)
    log("elasticity band " + json.dumps(info))
    rows, errs = [], []
    for name, (args, wargs, per_forward) in shapes.items():
        mq, mk, scale, u, thr, starts, kc, width = args
        B, Lo, _ = mq.shape
        Li, D = u.shape[1:]
        H = scale.shape[0]
        err, want = compare(name, args, wargs)
        errs.append(err)
        kw = dict(keep_count=kc, width=width)
        ms = cuda_ms(lambda: kb.posatt_batched_cuda(mq, mk, scale, u, thr, starts, **kw))
        plain_ms = cuda_ms(lambda: kb.posatt_batched_reference(mq, mk, scale, u, thr, starts, **kw))
        # yardstick: one SDPA call with zero q and k and the masked logits
        # as attn_mask (built outside the timing) computes the same function
        dist, keep, _, _ = kb._rows(mq, mk, thr, starts, kc, width)
        logits = torch.where(keep[:, None], -dist[:, None] * scale.reshape(1, H, 1, 1), -1e38)
        q = torch.zeros((B, H, Lo, D), device=mq.device)
        k = torch.zeros((B, H, Li, D), device=mq.device)
        v = u[:, None].expand(B, H, Li, D).contiguous()
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=logits)
        lib_err = (sdpa().permute(0, 2, 1, 3).reshape(B, Lo, H * D) - want).abs().max().item()
        library_ms = cuda_ms(sdpa)
        del dist, logits, q, k, v
        inspected, kept, nbytes = batched_work(args, keep)
        flops = 3 * mq.shape[-1] * inspected + 2 * H * D * kept
        bound_ms, bound_by = roofline(flops, nbytes)
        rows.append({
            "shape": name, "H": H, "B": B, "L_out": Lo, "L_in": Li, "D": D,
            "band_width": width, "inspected": inspected, "kept_entries": kept,
            "launches_per_forward": per_forward, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "library_max_abs_err": lib_err,
            "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
        })
        log(f"kernel posatt_batched_fwd {name}: {json.dumps(rows[-1])}")
    for name, *shape in RAGGED_BATCHED:
        args, wargs = ragged_batched(rng, *shape)
        err, _ = compare(name, args, wargs)
        errs.append(err)
        log(f"kernel posatt_batched_fwd {name}: {shape} max_abs_err={err:.3e}")
    return shapes, rows, max(errs)


def batched_backward_phase(shapes):
    """Kernel #8's entry points against their plain versions at the
    elasticity training shapes and at ragged ones, timed and bounded; the
    Function's gradients against torch.autograd of the oracle, with the
    stated launches per forward + backward; dscale twice, the same bits."""
    import numpy as np
    import torch

    from position_induced_transformer_torch.kernels import posatt_batched as kb

    rng = np.random.default_rng(4)

    def compare(name, args, g, with_du=True):
        mq, mk, scale, u, thr, starts, kc, width = args
        _, stats = kb.posatt_batched_cuda(mq, mk, scale, u, thr, starts, keep_count=kc,
                                          width=width, stats=True)
        want_stats = kb.posatt_batched_stats_reference(mq, mk, scale, thr, starts,
                                                       keep_count=kc, width=width)
        torch.cuda.synchronize()
        # the row minimum and the keep threshold (+inf for a global row) come
        # from bit-equal distances
        if not torch.equal(stats[:, :2], want_stats[:, :2]):
            fail(f"{name}: the forward's row minimum or keep threshold differs from the plain version")
        errs = {"stats": check_close(f"{name} stats", stats[:, 2:], want_stats[:, 2:], OP_RTOL, 0.0)}
        w = dict(width=width)
        ds = kb.posatt_batched_bwd_dscale_cuda(mq, mk, scale, u, g, stats, starts, **w)
        again = kb.posatt_batched_bwd_dscale_cuda(mq, mk, scale, u, g, stats, starts, **w)
        torch.cuda.synchronize()
        if not torch.equal(ds, again):
            fail(f"{name}: two dscale runs on the same inputs differ")
        want = kb.posatt_batched_bwd_dscale_reference(mq, mk, scale, u, g, stats, starts, **w)
        # the size of the summed terms per sample and head: sum_i |w_i| + |r_i v_i|
        att, keep, dist = kb._weights_from_stats(mq, mk, scale, stats, starts, width)
        B, Lo, HD = g.shape
        t = torch.einsum("bihd,bjd->bhij", g.reshape(B, Lo, scale.shape[0], -1), u)
        nd = torch.where(keep, dist, 0.0)[:, None]
        size = ((att * t * nd).sum(-1).abs() + (att * t).sum(-1).abs() * (att * nd).sum(-1)).sum(-1)
        del att, t, nd, dist
        check_close(f"{name} dscale (normalised)", ds / size, want / size, DS_RTOL, DS_ATOL)
        errs["posatt_batched_bwd_dscale"] = (ds - want).abs().max().item()
        if with_du:
            du = kb.posatt_batched_bwd_du_cuda(mq, mk, scale, g, stats, starts, **w)
            torch.cuda.synchronize()
            want = kb.posatt_batched_bwd_du_reference(mq, mk, scale, g, stats, starts, **w)
            size = kb.posatt_batched_bwd_du_reference(mq, mk, scale, g.abs(), stats, starts, **w)
            errs["posatt_batched_bwd_du"] = check_close(f"{name} du", du, want, OP_RTOL, OP_ATOL, size)
        return errs, stats, keep

    def function_check(name, wargs, need_du):
        """One forward + backward through position_attention_batched launches
        the forward and dscale once and du once when the values need a
        gradient; its gradients match autograd of the oracle."""
        mq, mk, lmda, u, loc, thr, band = wargs
        H, D = lmda.shape[0], u.shape[-1]
        w = torch.from_numpy(rng.standard_normal((u.shape[0], mq.shape[1], H * D))
                             .astype(np.float32)).cuda()

        def grads(fn, w):
            lm = lmda.clone().requires_grad_(True)
            x = u.clone().requires_grad_(need_du)
            out = fn(mq, mk, lm, x, loc, thr, band)
            (out * w).sum().backward()
            return out.detach(), lm.grad, x.grad

        before = counts()
        got = grads(kb.position_attention_batched, w)
        torch.cuda.synchronize()
        after = counts()
        expect = {"posatt_batched_fwd": 1, "posatt_batched_bwd_dscale": 1,
                  "posatt_batched_bwd_du": int(need_du)}
        diff = {k: after[k] - before[k] for k in after}
        if diff != {k: expect.get(k, 0) for k in after}:
            fail(f"{name}: one forward + backward launched {diff}, expected {expect}")
        want = grads(batched_oracle, w)
        err = max(
            check_close(f"{name} Function out", got[0], want[0], OP_RTOL, OP_ATOL),
            check_close(f"{name} Function d lmda", got[1], want[1], DS_RTOL,
                        DS_ATOL * want[1].abs().max().item()),
        )
        if need_du:
            size_u = grads(batched_oracle, w.abs())[2]
            err = max(err, check_close(f"{name} Function d u", got[2], want[2], OP_RTOL, OP_ATOL, size_u))
        return err

    # launches per training step of dscale and du: the encoder's values are
    # the model input, which needs no gradient
    per_step = {"encoder": (1, 0), "processor": (4, 4), "decoder": (1, 1)}
    rows = {k: [] for k in BATCHED_KERNELS[1:]}
    errs = {k: 0.0 for k in ("stats",) + BATCHED_KERNELS[1:]}
    fn_err = 0.0
    for name, (n_ds, n_du) in per_step.items():
        args, wargs, _ = shapes[name]
        mq, mk, scale, u, thr, starts, kc, width = args
        H = scale.shape[0]
        B, Lo, d = mq.shape
        Li, D = u.shape[1:]
        g = torch.from_numpy(rng.standard_normal((B, Lo, H * D)).astype(np.float32)).cuda()
        e, stats, keep = compare(name, args, g, with_du=n_du > 0)
        for k, v in e.items():
            errs[k] = max(errs[k], v)
        inspected, kept, _ = batched_work(args, keep)
        flops = 3 * d * inspected + 2 * H * D * kept
        # coordinates, starts, statistics and the cotangent; dscale reads
        # the values and writes (B, H), du writes dU
        words = B * Lo * d + B * Li * d + B * (H + 2) * Lo + B * Lo * H * D
        words += starts.numel() if starts is not None else 0
        w = dict(width=width)
        calls = {
            "posatt_batched_bwd_dscale": (
                lambda: kb.posatt_batched_bwd_dscale_cuda(mq, mk, scale, u, g, stats, starts, **w),
                lambda: kb.posatt_batched_bwd_dscale_reference(mq, mk, scale, u, g, stats, starts, **w),
                n_ds, words + B * Li * D + B * H),
            "posatt_batched_bwd_du": (
                lambda: kb.posatt_batched_bwd_du_cuda(mq, mk, scale, g, stats, starts, **w),
                lambda: kb.posatt_batched_bwd_du_reference(mq, mk, scale, g, stats, starts, **w),
                n_du, words + B * Li * D),
        }
        for kernel, (launch, plain, n, nwords) in calls.items():
            if not n:
                continue
            bound_ms, bound_by = roofline(flops, 4 * nwords)
            rows[kernel].append({
                "shape": name, "H": H, "B": B, "L_out": Lo, "L_in": Li, "D": D,
                "band_width": width, "inspected": inspected, "kept_entries": kept,
                "launches_per_step": n, "max_abs_err": e[kernel], "ms": cuda_ms(launch),
                "plain_ms": cuda_ms(plain, reps=10, per_rep=3),
                # no one PyTorch call computes either function
                "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
                "flops": flops, "bytes": 4 * nwords,
            })
            log(f"kernel {kernel} {name}: {json.dumps(rows[kernel][-1])}")
        fn_err = max(fn_err, function_check(name, wargs, need_du=n_du > 0))
    for name, *shape in RAGGED_BATCHED:
        args, wargs = ragged_batched(rng, *shape)
        B, Lo = args[0].shape[:2]
        HD = args[2].shape[0] * args[3].shape[-1]
        g = torch.from_numpy(rng.standard_normal((B, Lo, HD)).astype(np.float32)).cuda()
        e, _, _ = compare(name, args, g)
        for k, v in e.items():
            errs[k] = max(errs[k], v)
        fn_err = max(fn_err, function_check(name, wargs, need_du=True))
        log(f"backward {name}: {shape} max_abs_err={json.dumps(e)}")
    log(f"PosAttBatched: gradients match autograd of the oracle, max abs err {fn_err:.3e}")
    return rows, errs


def mat_bytes(**arrays):
    from scipy.io import savemat

    buf = io.BytesIO()
    savemat(buf, arrays)
    return buf.getvalue()


def plain_batched(mesh_q, mesh_k, lmda, inputs, locality, thr=None, band=None):
    return batched_oracle(mesh_q, mesh_k, lmda, inputs, locality, thr)


def elasticity_serve_phase():
    """make_server("elasticity") with a seeded random-weight checkpoint on
    the card: .mat bodies holding x and mesh, 1, 10 and 13 samples, 4
    concurrent requests, then 20 warm ones; every reply 200 and in
    agreement with a plain-attention card run and a CPU run; exactly 6
    launches of the batched forward per device batch and no other kernel;
    a bare .npy gets 400."""
    import numpy as np
    import torch

    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.data import synthetic
    from position_induced_transformer_torch.models import pit
    from position_induced_transformer_torch.train import benchmarks, checkpoint
    from position_induced_transformer_torch.train.evaluate import Predictor
    from position_induced_transformer_torch.train.serve import make_server

    cfg = configs.ELASTICITY
    model = benchmarks._make_model(cfg, torch.Generator().manual_seed(0))
    ckpt = checkpoint.save(
        str(REPO / "build" / "chip_smoke" / "elasticity.pt"), model.state_dict(), cfg.name
    )
    t0 = time.perf_counter()
    server = make_server(cfg.name, ckpt, host="127.0.0.1", port=0, verbose=False, device="cuda")
    startup_s = time.perf_counter() - t0
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/predict"
    X, ext, _ = synthetic.elasticity(n=50, seed=1)
    sent = []  # (x, mesh, reply)

    def ask(i, j):
        code, body = post(url, mat_bytes(x=X[i:j], mesh=ext[i:j]))
        if code != 200:
            fail(f"elasticity serve: HTTP {code} for {j - i} samples: {body[:500]!r}")
        out = np.load(io.BytesIO(body))
        sent.append((X[i:j], ext[i:j], out))
        return out

    try:
        zero_counts()
        calls0 = server.batcher.n_calls
        t0 = time.perf_counter()
        ask(0, 1)
        first_ms = (time.perf_counter() - t0) * 1e3
        ask(1, 11)
        ask(11, 24)  # 13 samples: one full and one padded batch
        threads = [threading.Thread(target=ask, args=(24 + 3 * i, 27 + 3 * i)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if any(t.is_alive() for t in threads) or len(sent) != 7:
            fail("elasticity serve: concurrent requests did not all complete")
        warm = []
        for i in range(20):
            t0 = time.perf_counter()
            ask(10 * (i % 5), 10 * (i % 5) + 10)
            warm.append((time.perf_counter() - t0) * 1e3)
        launched = counts()
        device_calls = server.batcher.n_calls - calls0
        code, body = post(url, npy(X[:2]))  # x alone: the clouds are missing
        if code != 400 or b"mesh" not in body:
            fail(f"elasticity serve: a bare .npy got HTTP {code}: {body[:300]!r}")
        if counts() != launched:
            fail("elasticity serve: the refused request launched kernels")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)

    expected = {k: 6 * device_calls if k == "posatt_batched_fwd" else 0 for k in launched}
    if launched != expected or device_calls < 25:
        fail(f"elasticity serve: {launched} for {device_calls} device batches "
             "(expected 6 batched forward launches per batch and nothing else)")

    predictor = server.predictor
    cpu = Predictor(cfg.name, ckpt, device="cpu")
    err_plain = err_cpu = 0.0
    with mock.patch.object(pit, "position_attention_batched", plain_batched):
        for a, m, out in sent:
            before = counts()
            ref = torch.from_numpy(predictor.predict_array({"x": a, "mesh": m}))
            if counts() != before:
                fail("elasticity serve: the plain comparison run launched a kernel")
            got = torch.from_numpy(out)
            if got.shape != (a.shape[0], a.shape[1], cfg.model.out_dim):
                fail(f"elasticity serve: reply shape {tuple(got.shape)}")
            err_plain = max(err_plain, check_close(
                "elasticity serve vs plain on CUDA", got, ref, MODEL_RTOL, MODEL_ATOL))
    for a, m, out in sent:
        ref_cpu = torch.from_numpy(cpu.predict_array({"x": a, "mesh": m}))
        err_cpu = max(err_cpu, check_close(
            "elasticity serve vs CPU", torch.from_numpy(out), ref_cpu, MODEL_RTOL, MODEL_ATOL))
    return {
        "config": cfg.name, "startup_s": startup_s,
        "profile_10_samples": profile_device(
            lambda: predictor.predict_array({"x": X[:ELASTICITY_B], "mesh": ext[:ELASTICITY_B]}),
            "forward"),
        "requests": len(sent), "samples": int(sum(a.shape[0] for a, _, _ in sent)),
        "device_batches": device_calls, "launches": launched,
        "first_request_ms": first_ms, "warm_median_ms": statistics.median(warm),
        "warm_requests": len(warm), "warm_samples_per_request": ELASTICITY_B,
        "max_abs_err_vs_plain_cuda": err_plain, "max_abs_err_vs_cpu": err_cpu,
    }


def run_training(cfg, device, epochs, ntrain, ntest, patch=None):
    """runner.train with the launch counts zeroed first; returns the
    problem, state, history, per-step losses, final weights, launches and
    seconds. ``patch``: a context manager around the run."""
    import torch

    from position_induced_transformer_torch.train import runner

    step_losses = []
    make = runner.make_train_epoch

    def capturing(*a, **kw):  # keeps each epoch's per-step losses
        epoch = make(*a, **kw)

        def train_epoch(*b):
            state, losses = epoch(*b)
            step_losses.append(losses)
            return state, losses
        return train_epoch

    zero_counts()
    t0 = time.perf_counter()
    with mock.patch.object(runner, "make_train_epoch", capturing), patch or nullcontext():
        problem, state, history = runner.train(
            cfg, epochs=epochs, ntrain=ntrain, ntest=ntest, seed=0, verbose=False, device=device,
        )
    seconds = time.perf_counter() - t0
    launched = counts()
    weights = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    return problem, state, history, torch.cat(step_losses).cpu(), weights, launched, seconds


def step_timing(problem, state, batch_size, n_rows, lr):
    """Wall time of synchronised training steps on the trained state at a
    constant learning rate, steps/s, and the device's busy share."""
    import torch

    from position_induced_transformer_torch.train import loop

    dev = torch.device("cuda")
    data = {k: torch.from_numpy(v).to(dev) for k, v in problem.train_data.items()}
    perm = loop.epoch_permutation(0, 99, n_rows, batch_size).to(dev)
    train_epoch = loop.make_train_epoch(problem.task, lambda step: lr)
    rows = itertools.cycle(range(perm.shape[0]))

    def one_step():
        i = next(rows)
        train_epoch(state, problem.geom, data, perm[i:i + 1])

    for _ in range(5):
        one_step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(30):
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    epoch_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        train_epoch(state, problem.geom, data, perm)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t0)
    return {
        "wall_ms_per_step_median": statistics.median(walls),
        "steps_per_s_synchronised_steps": 1e3 / statistics.median(walls),
        "steps_per_s_back_to_back_epoch": perm.shape[0] / statistics.median(epoch_s),
        "profile_warm_steps": profile_device(one_step, "step"),
        "batch": batch_size,
    }


def elasticity_train_phase():
    """runner.train on full-width elasticity on the card (synthetic data,
    80 training and 20 test samples, 2 epochs of 8 steps at batch 10):
    exactly 6/6/5 launches of the batched forward/dscale/du per step and 6
    forward launches per eval batch; losses and weights against a
    plain-attention card run and a CPU run; then the time per step."""
    import numpy as np
    import torch

    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.models import pit

    cfg = configs.ELASTICITY
    epochs, ntrain, ntest = 2, 80, 20
    problem, state, history, losses, weights, launched, seconds = run_training(
        cfg, "cuda", epochs, ntrain, ntest)
    steps = state.step
    eval_batches = epochs * -(-ntest // cfg.batch_size)
    per_step = {"posatt_batched_fwd": 6, "posatt_batched_bwd_dscale": 6, "posatt_batched_bwd_du": 5}
    expected = {k: per_step.get(k, 0) * steps for k in launched}
    expected["posatt_batched_fwd"] += 6 * eval_batches
    if steps != epochs * (ntrain // cfg.batch_size) or launched != expected:
        fail(f"elasticity train: {steps} steps, {eval_batches} eval batches launched {launched}; "
             f"expected {expected} (6/6/5 per step, 6 forward per eval batch)")
    if not torch.isfinite(losses).all() or not all(
        np.isfinite(v) for row in history for v in row.values()
    ):
        fail(f"elasticity train: non-finite losses or metrics: {history}")
    report = {
        "config": cfg.name, "epochs": epochs, "ntrain": ntrain, "ntest": ntest,
        "steps": steps, "eval_batches": eval_batches, "launches": launched,
        "seconds_whole_run_cuda": seconds, "history": history,
        "step_losses_first_last": [losses[0].item(), losses[-1].item()],
    }
    patch = mock.patch.object(pit, "position_attention_batched", plain_batched)
    for device, p, label in (("cuda", patch, "plain_cuda"), ("cpu", None, "cpu")):
        _, _, _, ref_losses, ref_weights, ref_launched, ref_s = run_training(
            cfg, device, epochs, ntrain, ntest, p)
        if any(ref_launched.values()):
            fail(f"elasticity train: the {label} run launched kernels: {ref_launched}")
        report[f"max_abs_err_step_loss_vs_{label}"] = check_close(
            f"elasticity train losses vs {label}", losses, ref_losses, LOSS_RTOL, 0.0)
        report[f"max_abs_err_weights_vs_{label}"] = max(
            check_close(f"elasticity train weight {k} vs {label}", v, ref_weights[k],
                        PARAM_RTOL, PARAM_ATOL)
            for k, v in weights.items())
        report[f"seconds_whole_run_{label}"] = ref_s
    report.update(step_timing(problem, state, cfg.batch_size, ntrain, cfg.lr))
    return report


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import position_induced_transformer_torch as port  # fails outside the repo

    if Path(port.__file__).resolve().parents[1] != REPO:
        fail(f"the port was imported from {port.__file__}, not from this checkout")

    environment()
    build()
    geom = geometry_phase()
    shapes, max_err = kernel_phase(geom)
    bwd_rows, bwd_errs = backward_kernel_phase(geom)
    serve = serve_phase()
    log("serve " + json.dumps(serve))
    train = train_phase()
    log("train " + json.dumps(train))
    b_shapes, b_rows, b_err = batched_kernel_phase()
    b_bwd_rows, b_bwd_errs = batched_backward_phase(b_shapes)
    e_serve = elasticity_serve_phase()
    log("elasticity_serve " + json.dumps(e_serve))
    e_train = elasticity_train_phase()
    log("elasticity_train " + json.dumps(e_train))

    per = {s["shape"]: s for s in shapes}
    total = lambda key: sum(s[key] * s["launches_per_forward"] for s in shapes)
    by = {
        kind: sum(s["bound_ms"] * s["launches_per_forward"]
                  for s in shapes if s["bound_by"] == kind)
        for kind in ("operations", "bytes")
    }
    kernels = {"kernels": [{
        "name": "posatt_fixed_fwd",
        "route": "cuda",
        "source": "position_induced_transformer_torch/kernels/csrc/posatt_fixed_fwd.cu",
        "replaces": "position_induced_transformer_tpu/kernels/posatt_pallas.py:268",
        "launches": serve["kernel_launches"],
        "launches_by_path": {"serve": serve["kernel_launches"],
                             "train": train["launches"]["posatt_fixed_fwd"]},
        "max_abs_err": max_err,
        # times and bounds: one Burgers forward at batch 8, i.e. the sum of
        # 1 encoder + 5 processor + 1 decoder launches; "shapes" splits them
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": max(by, key=by.get),
        "library_ms": total("library_ms"),
        "shapes": [per[n] for n in ("encoder", "processor", "decoder")],
    }]}
    replaces = {  # the pl.pallas_call of each TPU kernel
        "posatt_stats": "position_induced_transformer_tpu/kernels/posatt_pallas.py:419",
        "posatt_bwd_dscale": "position_induced_transformer_tpu/kernels/posatt_pallas.py:545",
        "posatt_bwd_du": "position_induced_transformer_tpu/kernels/posatt_pallas.py:627",
    }

    def per_step(rows, launches_key):
        """Times and bounds summed over a step's launches, and what bounds
        the larger share of the bound."""
        step = lambda key: sum(r[key] * r[launches_key] for r in rows)
        by = {kind: sum(r["bound_ms"] * r[launches_key] for r in rows if r["bound_by"] == kind)
              for kind in ("operations", "bytes")}
        return {"ms": step("ms"), "plain_ms": step("plain_ms"), "bound_ms": step("bound_ms"),
                "bound_by": max(by, key=by.get)}

    for name in BWD_KERNELS:
        rows = bwd_rows[name]
        # times and bounds: one Burgers training step at batch 8, the sum
        # over its launches; "shapes" splits them
        kernels["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": "position_induced_transformer_torch/kernels/csrc/posatt_fixed_bwd.cu",
            "replaces": replaces[name],
            "launches": train["launches"][name],
            "launches_by_path": {"serve": 0, "train": train["launches"][name]},
            "max_abs_err": bwd_errs[name],
            **per_step(rows, "launches_per_step"),
            "library_ms": None,
            "shapes": rows,
        })
    # kernel #7: one elasticity training forward at batch 10 (1 encoder + 4
    # processor + 1 decoder launches); a served forward swaps the banded
    # encoder and decoder for the band-less serving shapes
    train_rows = [r for r in b_rows if not r["shape"].startswith("serve_")]
    serve_rows = [r for r in b_rows if r["shape"] in ("processor", "serve_encoder", "serve_decoder")]
    fwd = per_step(train_rows, "launches_per_forward")
    n_serve, n_train = (e_serve["launches"]["posatt_batched_fwd"],
                        e_train["launches"]["posatt_batched_fwd"])
    kernels["kernels"].append({
        "name": "posatt_batched_fwd",
        "route": "cuda",
        "source": "position_induced_transformer_torch/kernels/csrc/posatt_batched_fwd.cu",
        "replaces": "position_induced_transformer_tpu/kernels/posatt_batched.py:278",
        "launches": n_serve + n_train,
        "launches_by_path": {"serve": n_serve, "train": n_train},
        "max_abs_err": b_err,
        **fwd,
        "library_ms": sum(r["library_ms"] * r["launches_per_forward"] for r in train_rows),
        "per_serve_forward": {
            **per_step(serve_rows, "launches_per_forward"),
            "library_ms": sum(r["library_ms"] * r["launches_per_forward"] for r in serve_rows)},
        "shapes": b_rows,
    })
    # kernel #8: its two entry points over one elasticity training step
    entry = {k: per_step(b_bwd_rows[k], "launches_per_step") for k in BATCHED_KERNELS[1:]}
    kernels["kernels"].append({
        "name": "posatt_batched_bwd",
        "route": "cuda",
        "source": "position_induced_transformer_torch/kernels/csrc/posatt_batched_bwd.cu",
        "replaces": "position_induced_transformer_tpu/kernels/posatt_batched.py:415",
        "launches": sum(e_train["launches"][k] for k in BATCHED_KERNELS[1:]),
        "launches_by_path": {"serve": 0, **{k: e_train["launches"][k] for k in BATCHED_KERNELS[1:]}},
        "max_abs_err": max(b_bwd_errs[k] for k in BATCHED_KERNELS[1:]),
        "ms": sum(e["ms"] for e in entry.values()),
        "plain_ms": sum(e["plain_ms"] for e in entry.values()),
        "bound_ms": sum(e["bound_ms"] for e in entry.values()),
        "bound_by": max(entry.values(), key=lambda e: e["bound_ms"])["bound_by"],
        "library_ms": None,
        "entry_points": entry,
        "shapes": b_bwd_rows,
    })
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
