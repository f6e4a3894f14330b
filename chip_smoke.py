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
5. serve: a full-width Burgers model (random weights from a seeded
   generator) behind the port's HTTP server on the card, answering 1, 8
   and 13 samples, then 4 concurrent requests, then warm requests; every
   reply must be 200 and agree with the same model run with the plain
   attention on the card and with a CPU run; the kernel must have launched
   exactly 7 times per device batch.

The last line is ``{"ok": true, "device": {...}}``; the line before it the
``kernels`` record, and before that the ``serve`` record.
"""

from __future__ import annotations

import io
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
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

BURGERS_B = 8  # the serving batch
SLEEP_CYCLES = 10_000_000  # ~5 ms of spinning: longer than enqueueing 10 calls


def log(*args):
    print(*args, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check_close(name, got, want, rtol, atol):
    """Max abs error; fails when any element exceeds atol + rtol*|want|."""
    import torch

    got, want = got.double().cpu(), want.double().cpu()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite values")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
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


def profile_forward(predictor, x, reps=5):
    """Wall time and device busy time of warm forwards, from torch.profiler:
    the union of the CUDA activity intervals over the host's wall clock,
    and device time by kernel. None where the trace holds no device
    activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    predictor.predict_array({"x": x})
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            predictor.predict_array({"x": x})
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    if not spans:
        return {"wall_ms_per_forward": wall_ms, "device_busy_ms_per_forward": None}
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "wall_ms_per_forward": wall_ms,
        "device_busy_ms_per_forward": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_ms_per_forward_by_kernel": {n[:80]: t / 1e3 / reps for n, t in top},
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
    for name in _build.KERNELS:
        _build.load(name)
    log(f"build: {len(_build.KERNELS)} kernel(s) in {time.perf_counter() - t0:.2f} s "
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


def bound(dist, thr, H, B, D):
    """Least time for the function on these inputs: each input read once,
    the output written once, and 2*H*B*D operations per kept entry (a
    masked weight is exactly 0, so a masked entry needs none)."""
    Lo, Li = dist.shape
    kept = int(((dist <= thr) & (dist < float("inf"))).sum())
    flops = 2 * H * B * D * kept
    nbytes = 4 * (Lo * Li + Lo + Li * B * D + H * Lo * B * D)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes), by, flops, nbytes, kept


def kernel_phase(geom):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.kernels import posatt_pallas as kp
    from position_induced_transformer_torch.ops import distances, locality, posatt

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

    ragged = [  # L not a multiple of any tile; 1, 4 and 8 heads; N = B*D ragged,
        # on both sides of the kernel's B*D <= 32 tile choice
        ("ragged_h1_masked", 97, 1000, 3, 1, 5, 0.02),
        ("ragged_h8_global", 1000, 97, 2, 8, 33, 1.0),
        ("ragged_h8_masked", 33, 65, 1, 8, 64, 0.1),
        ("ragged_h2_wide", 70, 300, 8, 2, 100, 0.3),
        ("ragged_h8_narrow", 50, 300, 4, 8, 4, 0.2),
        ("ragged_h4_narrow", 300, 50, 3, 4, 9, 1.0),
    ]
    for name, Lo, Li, B, Hr, D, loc in ragged:
        mo = torch.from_numpy(rng.random((Lo, 2)).astype(np.float32)).to(dev)
        mi = torch.from_numpy(rng.random((Li, 2)).astype(np.float32)).to(dev)
        dist = distances.euclidean_sq(mo, mi)
        # thr missing: the wrapper computes the quantile itself
        err = compare(name, *case(dist, loc, None, Hr, B, D))
        errs.append(err)
        log(f"kernel {name}: H={Hr} L_out={Lo} L_in={Li} B={B} D={D} max_abs_err={err:.3e}")
    return shapes, max(errs)


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
        kp.posatt_fixed_cuda.launches = 0
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
        launches = kp.posatt_fixed_cuda.launches
        device_calls = server.batcher.n_calls - calls0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)

    if launches != 7 * device_calls or device_calls < 25:
        fail(f"serve: {launches} kernel launches for {device_calls} device batches "
             "(expected exactly 7 per batch)")

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
        "profile_8_samples": profile_forward(predictor, x[:BURGERS_B]),
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
    serve = serve_phase()
    log("serve " + json.dumps(serve))

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
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
