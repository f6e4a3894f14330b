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
   the device's busy share of warm steps.

The last line is ``{"ok": true, "device": {...}}``; the line before it the
``kernels`` record, and before that the ``train`` and ``serve`` records.
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


def launchers():
    """The four launchers, by kernel name; each counts its launches."""
    from position_induced_transformer_torch.kernels import posatt_pallas as kp

    return {
        "posatt_fixed_fwd": kp.posatt_fixed_cuda,
        "posatt_stats": kp.posatt_stats_cuda,
        "posatt_bwd_dscale": kp.posatt_bwd_dscale_cuda,
        "posatt_bwd_du": kp.posatt_bwd_du_cuda,
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
        if any(after[k] - before[k] != 1 for k in after):
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
    from position_induced_transformer_torch.train import loop, runner

    cfg = configs.BURGERS
    epochs, ntrain, ntest = 2, 64, 16
    plain = lambda dist, lmda, inputs, locality, thr=None: position_attention(
        dist, lmda, inputs, locality, thr=thr)

    def run(device, plain_attention=False):
        step_losses = []
        make = runner.make_train_epoch

        def capturing(*a, **kw):  # keeps each epoch's per-step losses
            epoch = make(*a, **kw)

            def train_epoch(*b):
                state, losses = epoch(*b)
                step_losses.append(losses)
                return state, losses
            return train_epoch

        patch = (mock.patch.object(pit, "position_attention_fixed", plain)
                 if plain_attention else nullcontext())
        zero_counts()
        t0 = time.perf_counter()
        with mock.patch.object(runner, "make_train_epoch", capturing), patch:
            problem, state, history = runner.train(
                cfg, epochs=epochs, ntrain=ntrain, ntest=ntest, seed=0,
                verbose=False, device=device,
            )
        seconds = time.perf_counter() - t0
        launched = counts()
        weights = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
        return problem, state, history, torch.cat(step_losses).cpu(), weights, launched, seconds

    problem, state, history, losses, weights, launched, seconds = run("cuda")
    steps = state.step
    eval_batches = epochs * -(-ntest // cfg.batch_size)
    per_step = {"posatt_fixed_fwd": 7, "posatt_stats": 7, "posatt_bwd_dscale": 7, "posatt_bwd_du": 6}
    expected = {k: n * steps for k, n in per_step.items()}
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
    for device, plain_attention, label in (("cuda", True, "plain_cuda"), ("cpu", False, "cpu")):
        _, _, _, ref_losses, ref_weights, ref_launched, ref_s = run(device, plain_attention)
        if any(ref_launched.values()):
            fail(f"train: the {label} run launched kernels: {ref_launched}")
        report[f"max_abs_err_step_loss_vs_{label}"] = check_close(
            f"train losses vs {label}", losses, ref_losses, LOSS_RTOL, 0.0)
        report[f"max_abs_err_weights_vs_{label}"] = max(
            check_close(f"train weight {k} vs {label}", v, ref_weights[k], PARAM_RTOL, PARAM_ATOL)
            for k, v in weights.items())
        report[f"seconds_whole_run_{label}"] = ref_s

    # time per step: the trained state, a constant learning rate, batch 8
    dev = torch.device("cuda")
    data = {k: torch.from_numpy(v).to(dev) for k, v in problem.train_data.items()}
    perm = loop.epoch_permutation(0, epochs, ntrain, cfg.batch_size).to(dev)
    train_epoch = loop.make_train_epoch(problem.task, lambda step: cfg.lr)

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
    for _ in range(5):
        t0 = time.perf_counter()
        train_epoch(state, problem.geom, data, perm)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t0)
    report.update({
        "wall_ms_per_step_median": statistics.median(walls),
        "steps_per_s_synchronised_steps": 1e3 / statistics.median(walls),
        "steps_per_s_back_to_back_epoch": perm.shape[0] / statistics.median(epoch_s),
        "profile_warm_steps": profile_device(one_step, "step"),
        "batch": cfg.batch_size,
    })
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
    if any(launched[k] for k in BWD_KERNELS):
        fail(f"serve: backward kernels launched while serving: {launched}")

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
    for name in BWD_KERNELS:
        rows = bwd_rows[name]
        # times and bounds: one Burgers training step at batch 8, the sum
        # over its launches; "shapes" splits them
        step = lambda key: sum(r[key] * r["launches_per_step"] for r in rows)
        by = {kind: sum(r["bound_ms"] * r["launches_per_step"] for r in rows
                        if r["bound_by"] == kind) for kind in ("operations", "bytes")}
        kernels["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": "position_induced_transformer_torch/kernels/csrc/posatt_fixed_bwd.cu",
            "replaces": replaces[name],
            "launches": train["launches"][name],
            "launches_by_path": {"serve": 0, "train": train["launches"][name]},
            "max_abs_err": bwd_errs[name],
            "ms": step("ms"),
            "plain_ms": step("plain_ms"),
            "bound_ms": step("bound_ms"),
            "bound_by": max(by, key=by.get),
            "library_ms": None,
            "shapes": rows,
        })
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
