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
4. kernels: the forward #1's launcher against its plain PyTorch version,
   with and without its row statistics M and L out (the same output bits;
   M and L against the plain version's), and its public wrapper (the call
   the model makes) against the model-level oracle, on the card, at the
   three Burgers shapes and at ragged shapes with 1 to 12 heads; times
   (with and without M and L out) from CUDA events, the bound from the
   H100's published peaks and the work this run's inputs need, one PyTorch
   library call computing the same function as a yardstick, each shape's
   kept fraction and the splits of L_in;
5. backward kernels: the stats kernel #2 (which writes the bits of M and L
   that #1 writes at the same shape), dscale (which reads the forward's
   output; one launch, the same bits twice) and du against their plain
   versions at the Burgers training shapes (dU is not needed at the
   encoder) and at ragged shapes with 1 to 12 heads, timed and bounded as
   in phase 4, with each op's kept fraction and the number of ranges the
   kernel splits its streamed index into; dscale and du also, through the
   kernel API, at the vorticity training shapes (encoder 256 x 4096, D 12;
   processor 256 x 256 and decoder 4096 x 256, D 256; B 20, H 2), one
   H 1 shape at sod's widths and cylinder's three ops (encoder 896 x 4390,
   D 5; processor 896^2, D 256; decoder 4390 x 896, D 256; B 200, H 1),
   each row with its launches in one cylinder step; the autograd Function's gradients against
   torch.autograd of the plain oracle, with one forward + backward
   launching the forward, dscale and du exactly once each and #2 never;
6. serve: a full-width Burgers model (random weights from a seeded
   generator) behind the port's HTTP server on the card, answering 1, 8
   and 13 samples, then 4 concurrent requests (each request's thread
   records its reply or exception; the main thread fails with every
   request that got no 200, its code and body or traceback and its sample
   range), then warm requests; every
   reply must be 200 and agree with ``infer`` on the card, the same model
   run with the plain attention on the card and a CPU run; the forward kernel must have
   launched exactly 7 times per device batch and no backward kernel at all;
7. train: ``runner.train`` on full-width, full-depth Burgers on the card
   (synthetic data, 64 training and 16 test samples, 2 epochs of 8 steps);
   exactly 7/0/7/6 launches of the forward/stats/dscale/du kernels per
   step (the forward writes M and L) and 7 forward launches per eval
   batch; the per-step losses and the
   final weights agree with the same training with the plain attention on
   the card and with a CPU run; then the wall time per step, steps/s and
   the device's busy share of warm steps;
8. batched kernels: the per-sample-mesh forward (kernel #7) against its
   plain version at the full elasticity shapes (encoder 972 x (972 + 384)
   with its circular band, D 44; processor 972 x 972, all kept, D 256;
   decoder, band, D 256; the band-less serving encoder and decoder), with
   bands and thresholds from ``setup_elasticity`` on synthetic clouds, and
   at ragged shapes (1, 2, 3, 4, 6 and 8 heads, D 4 to 256, the kernel's
   own keep count, seam-crossing bands, L_out not a multiple of 256, a
   band tile of 200 rows with a short last 32-row block, a global window of
   1500 columns past the kernel's 1024-column list); the public wrapper
   against ``ops.posatt.position_attention`` on materialized distances;
   times, bounds, the SDPA yardstick as in phase 4 and each block's
   compacted list length (mean and max); and at the full NACA shapes at
   B 20, H 1, with thresholds and band starts from ``setup_naca`` on
   synthetic airfoils: the encoder 728 x 120 (D 2), the global processor
   728^2 (D 128), the decoder 11,271 x 728 (D 128, 256-row band tiles, L_out
   no multiple of 256) and the served decoder without a band;
9. batched backward: kernel #8's dscale (which reads the forward's
   output) and du entry points against their plain versions at the
   elasticity and NACA training shapes and the ragged ones, timed and bounded, with
   the length of each block's compacted list (mean and max per block);
   dscale twice gives the same bits; the autograd
   Function's gradients against torch.autograd of the oracle, one forward
   + backward launching the forward and dscale once and du once where the
   values need a gradient;
10. elasticity serve: ``make_server("elasticity")`` on the card with a
    seeded random-weight checkpoint; ``.mat`` bodies holding ``x`` and
    ``mesh`` (1, 10, 13 samples, 4 concurrent as in phase 6, 20 warm);
    every reply 200
    and in agreement with a plain-attention card run and a CPU run; exactly
    6 launches of kernel #7 per device batch and no other kernel; a bare
    ``.npy`` gets 400;
11. elasticity train: ``runner.train("elasticity")`` at full width (80
    training and 20 test samples, 2 epochs of 8 steps at batch 10); exactly
    6/6/5 launches of the batched forward/dscale/du per step and 6 forward
    launches per eval batch; losses and weights against a plain-attention
    card run, the first two steps against a CPU run; the time per step,
    steps/s and the device's busy share;
12. TF kernels: the TF-semantics forwards #9 (pre-built halved distances)
    and #11 (from coordinates) against their plain versions at the full
    elasticity_tf shapes (B 10, L 972, 8 heads of V 64: #11's banded
    encoder and decoder with ``setup_elasticity_tf``'s thresholds and
    starts and its global processor; #9's served encoder and decoder with
    per-request thresholds and its global processor) and at ragged shapes
    (1 to 8 heads, V 3 to 130, a global window of 1500 columns past the
    kernels' 1024-column list); the public wrappers against the oracle on
    materialized distances; times, bounds and the SDPA yardstick (zero q
    and k, per-head values, the masked logits as ``attn_mask``), and #9's
    and #11's compacted list lengths;
13. TF backward: #10's and #12's dscale and dv entry points against their
    plain versions at the same shapes, timed and bounded, and at ragged
    ones (a band whose row blocks keep no entry in some 32-column steps,
    V not a multiple of the 64-column tile, 1 to 8 heads); dscale twice
    gives the same bits; the autograd Functions' gradients against
    torch.autograd of the oracle, one forward + backward launching each
    entry point once;
14. elasticity_tf serve: ``make_server("elasticity_tf")`` with a seeded
    random-weight checkpoint answering bare ``.npy`` requests (1, 10, 13
    samples, 4 concurrent, 20 warm); the model computes thresholds per
    request, so exactly 6 launches of #9 per device batch and no other
    kernel; replies against a plain-attention card run and a CPU run (the
    first three requests);
15. elasticity_tf train: ``runner.train("elasticity_tf")`` at full width (80
    training and 20 test samples, 2 epochs of 8 steps); exactly 6/6/6
    launches of #11 and #12's dscale and dv per step and 6 of #11 per eval
    batch; losses and weights against a plain-attention card run, and the
    first two steps against a CPU run; the time per step, steps/s and the
    device's busy share; then one step on a batch without thresholds and
    bands, which launches 6 of #9 and 6 of each of #10's entry points;
16. fixed-mesh schedules: the forward's schedule variants #5 (v1: a block
    per head, sample, row tile and split of L_in) and #6 (v2: a block per
    head, tile of the batch-folded columns, row tile and split), #1's body
    each, beside #1 (v3) through ``position_attention_fixed(version=...)``,
    at the six fixed-mesh shapes of scripts/tpu_checks.py and the Darcy
    421^2 ZSSR encoder and decoder at its eval batch (random 2-D points,
    thresholds by ``quantile_threshold`` on the card): each version against
    the plain version and #1, its M and L against the plain version's; one
    forward + backward per version at the Burgers decoder and ZSSR decoder
    shapes launching that version's forward, #3 and #4 once each and #2
    never (every version writes M and L), gradients against autograd of
    the oracle, and dU the bits of version 3's wherever the version's M
    and L are (else its M and L within the forward's bounds of #2's);
    times with and without M and L out, bounds and the SDPA yardstick as
    in phase 4, the kept fraction, each version's splits of L_in, warps a
    block and kept-list length; and #2 at every shape, its M and L the bits
    #1 writes, against its plain version, timed and bounded;
17. Darcy train: ``runner.train("darcy")`` at full width on the 43^2 grid
    (hid 64, 2 heads, 4 blocks, 16^2 latent; 64 training and 16 test
    samples, 2 epochs of 8 steps at batch 8), as phase 7: exactly 6/0/6/5
    launches of #1/#2/#3/#4 a step (the encoder's input needs no
    gradient) and 6 of #1 per eval batch; losses and weights against a
    plain-attention card run and a CPU run; time per step, steps/s, the
    device's busy share; the 43^2 geometry's kept sets on the card against
    a CPU build. It writes the checkpoint (with the normalizer statistics)
    that phases 18-19 read;
18. Darcy ZSSR: ``evaluate("darcy", ckpt, zssr=True)`` at 421^2 (177,241
    points, ntest 10: one eval batch) on the card, launching #1 6 times
    and nothing else; its metrics against a plain-attention card run at
    rtol 1e-4, its predictions on 2 samples against a CPU ``Predictor``;
    the geometry's build time and kept sets against a CPU build; #1 per
    launch at the 421^2 encoder (256 x 177,241, D 3) and decoder (177,241 x
    256, D 64) of this grid-ordered mesh at batch 10 against its plain
    version, timed, with SDPA's time, the bound from the kept entries and
    phase 16's random-point time at the same shape;
19. Darcy serve: ``make_server("darcy")`` answering raw 43^2 grids (1, 10,
    13 samples, 4 concurrent, 20 warm), then a server built with
    ``setup_kwargs={"downsampling": 1}`` answering raw 421^2 grids (1, 3,
    2 concurrent, 4 warm); 6 launches of #1 per device batch and nothing
    else; every reply against ``infer`` on the card and a plain-attention
    card run, and a CPU run (at 421^2 on its first 2 samples);
20. sod serve and train: a seeded random-weight sod model served (1, 8, 13
    samples, 4 concurrent, 20 warm; 4 launches of #1 per device batch),
    then ``runner.train("sod")`` as phase 17 (4/0/4/3 a step);
21. NACA train: ``runner.train("naca")`` at full width (1 head, hid 128, 4
    blocks; 221 x 51 C-grids, 56 x 13 latent slices; 80 training and 20
    test samples, 2 epochs of 4 steps at batch 20): exactly 6/6/5 launches
    of #7 and #8's dscale and du a step and 6 of #7 per eval batch; losses
    and weights against a plain-attention card run, the first two steps
    against a CPU run; time per step, steps/s, the device's busy time;
22. NACA serve and shuffle ablation: ``make_server("naca")`` answering
    ``.mat`` bodies with ``x``, ``mesh_in``, ``mesh_ltt`` and ``mesh_out``
    (1, 10, 13 samples, 4 concurrent, 20 warm; 6 launches of #7 per device
    batch; replies against ``infer``, a plain-attention card run and a CPU
    run on 11 samples; a bare ``.npy`` gets 400); then
    ``evaluate("naca", ckpt, shuffle_ablation=True)`` against a
    plain-attention card run at rtol 1e-4;
23. vorticity train: ``runner.train("vorticity")`` at full width (hid 256,
    2 heads, 4 blocks; 64^2 grid, 16^2 latent; 160 training and 40 test
    samples, 2 epochs of 8 steps at batch 20), each step a 20-step rollout
    backpropagated through, every rollout step checkpointed: exactly
    240/0/120/119 launches of #1/#2/#3/#4 a step (#1 recomputed in the
    backward; the first window needs no du) and 120 of #1 per eval batch;
    losses, the eval ``rel_l2_step`` and weights against a plain-attention
    card run, the first step against a CPU run; then one step under each
    remat mode (``full``, ``dots``, ``none``: launches, gradients against
    ``none``'s, wall and device time, peak memory); #1 per processor launch
    beside phase 16's time; time per step, steps/s, the device's busy time;
24. vorticity evaluate and serve: ``evaluate("vorticity", ckpt)`` (40 test
    samples; 120 launches of #1 per eval batch) against a plain-attention
    card run at rtol 1e-4; ``make_server("vorticity")`` answering ``.npy``
    windows (n, 4096, 10) with their (n, 4096, 1, 20) rollouts (1, 8, 13
    samples, 4 concurrent, 8 warm; 120 launches of #1 per device batch;
    replies against ``infer``, a plain-attention card run and a CPU run on
    2 samples), ``?rollout_steps=5`` (30 per device batch) and a horizon
    past the maximum (400);
25. cylinder train: ``runner.train("cylinder")`` at full width (hid 256,
    1 head, 4 blocks; 4390 -> 896 -> 4390 points; 800 training and 200
    test samples, 2 epochs of 4 steps at batch 200): exactly 6/0/6/5
    launches of #1-#4 a step and 6 of #1 per eval batch; losses and
    weights against a plain-attention card run; time per step, steps/s,
    the device's busy time; then #1 at the model's encoder, processor and
    decoder (its trained bandwidths, B 200) against its plain version,
    timed beside the plain version and SDPA, and bounded;
26. cylinder evaluate: ``evaluate("cylinder", ckpt)`` (200 test pairs in
    one batch, 6 launches of #1; the 20 raw test trajectories rolled out
    10 steps in one batch, 60 launches) against a plain-attention card run
    at rtol 1e-4;
27. cylinder serve: ``make_server("cylinder")`` answering ``.npy`` inputs
    (n, 4390, 3) one step ahead (1, 10, 13 samples, 4 concurrent, 4 warm
    of 200; 6 launches of #1 per device batch) and at ``?rollout_steps=10``
    (1, 3 samples, 2 concurrent, 2 warm; 60 per device batch); replies
    against ``infer``, a plain-attention card run and a CPU run on 2
    samples;
28. the command line: ``python -m position_induced_transformer_torch``
    as subprocesses on the card, at once: ``train --benchmark cylinder``
    and, on phase 25's checkpoint, ``evaluate`` (against the in-process
    ``evaluate``), ``infer --rollout-steps 10``, ``serve`` answering one
    ``POST /predict`` and stopped, ``describe``, ``benchmarks`` and a
    ``convert`` round trip through a ``model.pth``; every process exits 0;
29. fixed-mesh TF kernel #13: its forward (with its row statistics m and
    l), dscale (twice: the same bits) and dv against their plain versions
    at every attention op of the five fixed-mesh TF configurations at full
    width, from their setups' geometry (burgers_tf 1024 -> 1024, B 5, H 2,
    V 32; sod_tf 2048 -> 1024, V 32; darcy_tf 43^2 -> 32^2, V 64;
    vorticity_tf 64^2 -> 16^2, H 1, V 256; naca_tf 221 x 51 -> 111 x 26,
    V 128, heads of scale tan(r) negative, zero and positive) and at
    darcy_tf's 421^2 ZSSR encoder and decoder, each timed beside its plain
    version, the bound (bytes, or the operations of the kept entries) and,
    for the forward, SDPA with zero q and k and the masked logits as
    ``attn_mask``; at ragged shapes (1 to 8 heads, V 4 to 256, 9 and 13
    samples, rows that keep nothing); the autograd Function's gradients in
    r (through the bandwidth) and the values against autograd of the plain
    version, one forward + backward launching each entry point once;
30. the five fixed-mesh TF configurations (``PiTTF``), each at full width
    and depth: ``runner.train`` (2 epochs of 2 steps; burgers_tf of 2 at
    batch 5) with exactly 7/7/7 (burgers_tf, sod_tf) or 6/6/6 launches of
    #13's forward/dscale/dv a step (vorticity_tf 240/120/120 under remat
    ``full``) and the forwards of a served batch per eval batch; losses
    and weights against a plain-attention card run and, for burgers_tf,
    sod_tf and darcy_tf, a CPU run; naca_tf's bandwidths at or above 0
    after training; time per step, steps/s, the device's busy share; then
    ``make_server`` on the trained checkpoint answering raw ``.npy``
    inputs (1, 3, 5 samples, 2 concurrent, 4 warm whole batches; naca_tf
    from C-grid coordinates) with 7 or 6 launches of #13's forward per
    device batch (vorticity_tf 120, rolled out 20 steps) and nothing else,
    replies against ``infer``, a plain-attention card run and a CPU run;
31. darcy_tf ``evaluate(zssr=True)`` at 421^2 (6 launches) and
    vorticity_tf's rollout ``evaluate`` (120 launches), each against a
    plain-attention card run at rtol 1e-4; vorticity_tf served at
    ``?rollout_steps=5`` (30 launches per device batch);
32. dot-product attention kernel #14 (the TF ablation variants' ``self``
    and ``hybrid`` ops): its forward (with its row statistics), dq (with
    each row's delta and, hybrid, dscale) and dk/dv against their plain
    versions, each twice to the same bits, at every self and hybrid op of
    the variants at full width (burgers_tf B 5, L 1024, 2 heads of V 32,
    selfpit's hybrid ops on its own distances with in-call thresholds;
    sod_tf L 1024 and 2048; darcy_tf L 1024 and 1849, V 64; vorticity_tf
    L 256 and 4096, 1 head of V 256; naca_tf L 2886 at B 8 and the largest,
    L 11,271 at B 1, V 128; elasticity_tf L 972, 8 heads of V 64, B 10),
    each timed beside its plain version, the bound (the operations of the
    kept entries, or bytes) and, for the forward, SDPA; and at ragged
    shapes (L 1 to 1849, V 16 to 256 and 21, 1 to 8 heads, rows that keep
    nothing); the autograd Function's gradients against autograd of the
    plain version, one forward + backward launching each entry point once;
33. the variants trained, evaluated and served at full width through
    ``runner.train(model_variant=)``, ``evaluate``, ``make_server`` and
    ``infer``: burgers_tf lite (#13 3/3/3 and #14 4/4/4 a step),
    transformer (#14 7/7/7) and selfpit (hybrid #14 7/7/7; every
    band_width at or above 0 after every step), each 2 epochs of 2 steps
    against a plain-attention card run and a CPU run; elasticity_tf lite
    (#11/#12 2/2/2 and #14 4/4/4 a step, #9 at its served coders) and
    transformer (#14 6/6/6, no distances), 2 epochs of 2 steps, against a
    plain-attention card run and, on its first step, a CPU run; every
    served reply equal to ``infer``'s to the bit;
34. darcy_tf lite trained at 43^2 (#13 2/2/2, #14 4/4/4) and evaluated with
    ``zssr=True`` at 421^2 (#13 at the coders, #14 at the 32^2 processor);
35. sod_tf, vorticity_tf (BPTT cut to 3 rollout steps) and naca_tf, lite
    and transformer: one training step and one served batch each, with
    their launches, against a plain-attention card run (naca_tf's
    transformer at batch 8, 11,271 tokens, without one: its plain version
    cannot hold the weights; its parity rests on phase 32's batch-1 op),
    with each step's peak device memory;
36. the command line with ``--model-variant selfpit``: ``train``,
    ``infer`` and ``serve`` on burgers_tf as subprocesses, the served reply
    equal to infer's to the bit.

The last line is ``{"ok": true, "device": {...}}``; the line before it the
``kernels`` record (the twelve kernels #1-#4, the per-sample-mesh #7, #8,
the TF-semantics #9-#12, the schedule variants #5, #6, the three entry
points of #13 and the three of #14), and before that the phases' records.
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
import traceback
import urllib.error
import urllib.request
from contextlib import contextmanager, nullcontext
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
# 16 Adam steps of vorticity's 20-step BPTT (phase 23): a near-zero
# gradient's sign decides a move of lr = 1e-3, and the rollout's 20 chained
# forwards flip more of them. Measured on the CPU, the JAX package against
# the port over 16 such steps (same weights and batches): weights 2.1e-3
# apart at hid 64 on a 32^2 grid at batch 4, 2.0e-3 at hid 128 on 64^2 at
# batch 8 (4.4x PARAM_ATOL + PARAM_RTOL |w|), losses 1.0e-5 relative at the
# latter. Adam's first step moves each weight by about lr in its
# gradient's sign, so a gradient within rounding of 0 lands 2 lr away: on
# the card against the CPU one element was 1.98e-3 apart after the first
# step. The losses keep LOSS_RTOL, the weights take this absolute bound,
# and the phase reports how many lie beyond PARAM_ATOL + PARAM_RTOL |w|
VORTICITY_PARAM_ATOL = 4e-3

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


def profile_device(fn, unit, reps=5, groups=None):
    """Wall time and device busy time of warm calls of ``fn``, from
    torch.profiler: the union of the CUDA activity intervals over the
    host's wall clock, and device time by kernel, per call. None where the
    trace holds no device activity. ``groups``: label -> kernel-name
    prefix; the device time per call of every kernel whose name starts
    with it."""
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
    out = {
        f"wall_ms_per_{unit}": wall_ms,
        f"device_busy_ms_per_{unit}": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        f"device_ms_per_{unit}_by_kernel": {n[:80]: t / 1e3 / reps for n, t in top},
    }
    if groups:
        out[f"device_ms_per_{unit}_by_port_kernel"] = {
            label: sum(t for n, t in by_name.items() if n.startswith(prefix)) / 1e3 / reps
            for label, prefix in groups.items()}
    return out


# the fixed-mesh kernels' names in a trace: #1 (its versions share the
# body), #3 (bwd_kernel<DU = false>) and #4 (bwd_kernel<DU = true>)
FIXED_GROUPS = {
    "posatt_fixed_fwd": "void (anonymous namespace)::fwd_kernel<",
    "posatt_bwd_dscale": "void (anonymous namespace)::bwd_kernel<false",
    "posatt_bwd_du": "void (anonymous namespace)::bwd_kernel<true",
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


RAGGED = [  # L not a multiple of any tile; 1 to 12 heads; N = B*D
    # ragged, on both sides of the kernels' B*D <= 32 tile choice
    ("ragged_h1_masked", 97, 1000, 3, 1, 5, 0.02),
    ("ragged_h8_global", 1000, 97, 2, 8, 33, 1.0),
    ("ragged_h8_masked", 33, 65, 1, 8, 64, 0.1),
    ("ragged_h2_wide", 70, 300, 8, 2, 100, 0.3),
    ("ragged_h8_narrow", 50, 300, 4, 8, 4, 0.2),
    ("ragged_h4_narrow", 300, 50, 3, 4, 9, 1.0),
    ("ragged_h3_wide", 60, 90, 2, 3, 20, 0.3),
    ("ragged_h6_narrow", 70, 150, 4, 6, 4, 0.2),
    ("ragged_h12_global", 40, 72, 3, 12, 16, 1.0),  # two groups of six heads
]


def ragged_dist(rng, Lo, Li):
    import numpy as np
    import torch

    from position_induced_transformer_torch.ops import distances

    to = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()
    return distances.euclidean_sq(to(rng.random((Lo, 2))), to(rng.random((Li, 2))))


def plain_fixed(dist, thr, scale, u):
    """The fixed-mesh forward's plain version in the kernels' (B, L_out,
    H*D) layout."""
    from position_induced_transformer_torch.kernels import posatt_pallas as kp

    B, _, D = u.shape
    out = kp.posatt_fixed_reference(dist, thr, scale, u)
    return out.permute(1, 2, 0, 3).reshape(B, dist.shape[0], -1).contiguous()


def fixed_sdpa(dist, thr, scale, u):
    """The fixed-mesh forward's yardstick: one SDPA call with zero q and k,
    so that softmax(mask) @ v is the same function (the logits are built
    here, outside the timing), and its max abs difference from the plain
    version, reported and not held: the yardstick is not part of the port."""
    import torch
    import torch.nn.functional as F

    H, (B, Li, D), Lo = scale.shape[0], u.shape, dist.shape[0]
    keep = (dist <= thr) & (dist < float("inf"))
    logits = torch.where(keep, -dist[None] * scale[:, :, None], -1e38)[None]
    q = torch.zeros((B, H, Lo, D), device=dist.device)
    k = torch.zeros((B, H, Li, D), device=dist.device)
    v = u[:, None].expand(B, H, Li, D).contiguous()
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=logits)
    err = (sdpa().permute(0, 2, 1, 3).reshape(B, Lo, H * D)
           - plain_fixed(dist, thr, scale, u)).abs().max().item()
    return sdpa, err


def kernel_phase(geom):
    import numpy as np
    import torch

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

    def compare(name, wrapper_args, args):
        """The launcher against the kernel's plain version, with and without
        the row statistics out (the same output bits, M and L against the
        plain version's), and the public wrapper against the model-level
        oracle; the larger error."""
        got = kp.posatt_fixed_cuda(*args)
        again, M, L = kp.posatt_fixed_cuda(*args, stats=True)
        torch.cuda.synchronize()
        want = plain_fixed(*args)
        Mp, Lp = kp.posatt_stats_reference(*args[:3])
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"{name}: the forward's output differs with the row statistics out")
        err = max(check_close(name, got, want, OP_RTOL, OP_ATOL),
                  check_close(f"{name} M", M, Mp, OP_RTOL, OP_ATOL),
                  check_close(f"{name} L", L, Lp, OP_RTOL, OP_ATOL))
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
        ms_stats = cuda_ms(lambda: kp.posatt_fixed_cuda(*args, stats=True))
        plain_ms = cuda_ms(lambda: plain_fixed(*args))
        sdpa, lib_err = fixed_sdpa(*args)
        library_ms = cuda_ms(sdpa)
        bound_ms, bound_by, flops, nbytes, kept = bound(dist, thr, H, B, D)
        shapes.append({
            "shape": name, "H": H, "L_out": Lo, "L_in": Li, "B": B, "D": D,
            "kept_entries": kept, "kept_fraction": kept / (Lo * Li),
            "splits": kp._fwd_plan(True, H, B, Lo, Li, D)[2],
            "launches_per_forward": per_forward, "max_abs_err": err,
            # ms: as serving runs it; ms_with_stats: M and L out, as training
            "ms": ms, "ms_with_stats": ms_stats, "plain_ms": plain_ms,
            "library_ms": library_ms,
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


# what one training forward + backward launches: the forward writes M and L
FIXED_TRAIN_KERNELS = ("posatt_fixed_fwd", "posatt_bwd_dscale", "posatt_bwd_du")
BATCHED_KERNELS = ("posatt_batched_fwd", "posatt_batched_bwd_dscale", "posatt_batched_bwd_du")
TF_DIST_KERNELS = ("posatt_tf_fwd", "posatt_tf_bwd_dscale", "posatt_tf_bwd_dv")
TF_COORD_KERNELS = ("posatt_tf_coord_fwd", "posatt_tf_coord_bwd_dscale", "posatt_tf_coord_bwd_dv")
TF_FIXED_KERNELS = ("posatt_tf_fixed_fwd", "posatt_tf_fixed_bwd_dscale", "posatt_tf_fixed_bwd_dv")
DOTATT_KERNELS = ("dotatt_fwd", "dotatt_bwd_dq", "dotatt_bwd_dkdv")


def launchers():
    """The twenty-one launchers, by kernel entry point; each counts its
    launches."""
    from position_induced_transformer_torch.kernels import dotatt as kd
    from position_induced_transformer_torch.kernels import posatt_batched as kb
    from position_induced_transformer_torch.kernels import posatt_pallas as kp
    from position_induced_transformer_torch.kernels import posatt_tf_fixed as kf

    return {
        "posatt_tf_fwd": kb.posatt_tf_cuda,
        "posatt_tf_bwd_dscale": kb.posatt_tf_bwd_dscale_cuda,
        "posatt_tf_bwd_dv": kb.posatt_tf_bwd_dv_cuda,
        "posatt_tf_coord_fwd": kb.posatt_tf_coord_cuda,
        "posatt_tf_coord_bwd_dscale": kb.posatt_tf_coord_bwd_dscale_cuda,
        "posatt_tf_coord_bwd_dv": kb.posatt_tf_coord_bwd_dv_cuda,
        "posatt_fixed_fwd": kp.posatt_fixed_cuda,
        "posatt_fixed_fwd_v1": kp.posatt_fixed_v1_cuda,
        "posatt_fixed_fwd_v2": kp.posatt_fixed_v2_cuda,
        "posatt_stats": kp.posatt_stats_cuda,
        "posatt_bwd_dscale": kp.posatt_bwd_dscale_cuda,
        "posatt_bwd_du": kp.posatt_bwd_du_cuda,
        "posatt_batched_fwd": kb.posatt_batched_cuda,
        "posatt_batched_bwd_dscale": kb.posatt_batched_bwd_dscale_cuda,
        "posatt_batched_bwd_du": kb.posatt_batched_bwd_du_cuda,
        "posatt_tf_fixed_fwd": kf.posatt_tf_fixed_cuda,
        "posatt_tf_fixed_bwd_dscale": kf.posatt_tf_fixed_bwd_dscale_cuda,
        "posatt_tf_fixed_bwd_dv": kf.posatt_tf_fixed_bwd_dv_cuda,
        "dotatt_fwd": kd.dotatt_cuda,
        "dotatt_bwd_dq": kd.dotatt_bwd_dq_cuda,
        "dotatt_bwd_dkdv": kd.dotatt_bwd_dkdv_cuda,
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
        """Each launcher against its plain version; max abs error by
        kernel, the row statistics and the forward's output (the plain
        version's: dscale reads it). #2 writes the bits of M and L that #1
        writes beside its output at the same shape."""
        Bq, _, Dq = u.shape
        M, L = kp.posatt_stats_cuda(dist, thr, scale, Bq, Dq)
        _, M1, L1 = kp.posatt_fixed_cuda(dist, thr, scale, u, stats=True)
        Mp, Lp = kp.posatt_stats_reference(dist, thr, scale)
        out = plain_fixed(dist, thr, scale, u)
        torch.cuda.synchronize()
        if not (torch.equal(M, M1) and torch.equal(L, L1)):
            fail(f"{name}: #2's M and L are not the bits #1 writes")
        errs = {"posatt_stats": max(
            check_close(f"{name} stats M", M, Mp, OP_RTOL, OP_ATOL),
            check_close(f"{name} stats L", L, Lp, OP_RTOL, OP_ATOL),
        )}
        before = kp.posatt_bwd_dscale_cuda.launches
        ds = kp.posatt_bwd_dscale_cuda(dist, thr, scale, M, L, g, u, out)
        again = kp.posatt_bwd_dscale_cuda(dist, thr, scale, M, L, g, u, out)
        torch.cuda.synchronize()
        if kp.posatt_bwd_dscale_cuda.launches != before + 2:
            fail(f"{name}: two dscale calls did not count two launches")
        if not torch.equal(ds, again):
            fail(f"{name}: two dscale runs on the same inputs differ")
        want = kp.posatt_bwd_dscale_reference(dist, thr, scale, Mp, Lp, g, u, out)
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
        return errs, (M, L, out)

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
        if any(after[k] - before[k] != (k in FIXED_TRAIN_KERNELS) for k in after):
            fail(f"{name}: one forward + backward launched "
                 f"{ {k: after[k] - before[k] for k in after} }, expected 1 each of "
                 f"{FIXED_TRAIN_KERNELS} and no #2 (the forward writes M and L)")
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
        # name, dist, thr, D, launches per step of dscale (and the shape's
        # count in a Burgers forward, for #2's times), of du
        ("encoder", geom.dist_down, geom.thr_down, in_dim, 1, 0),
        ("processor", geom.dist_proc, inf(geom.dist_proc.shape[0]), m.hid_dim, m.n_blocks, m.n_blocks),
        ("decoder", geom.dist_up, geom.thr_up, m.hid_dim, 1, 1),
    ]
    def timed_rows(name, dist, thr, lmda, u, g, scale, per_step, kernels, small_plain=False):
        """Hold the kernels against their plain versions at one shape, then
        time them (the plain versions with fewer repetitions where they
        take milliseconds) and bound them: one row per kernel."""
        Hs, (Bs, _, Ds) = scale.shape[0], u.shape
        e, (M, L, out) = compare(name, dist, thr, scale, u, g, with_du="posatt_bwd_du" in kernels)
        for k, v in e.items():
            errs[k] = max(errs[k], v)
        calls = {
            "posatt_stats": (lambda: kp.posatt_stats_cuda(dist, thr, scale, Bs, Ds),
                             lambda: kp.posatt_stats_reference(dist, thr, scale)),
            "posatt_bwd_dscale": (
                lambda: kp.posatt_bwd_dscale_cuda(dist, thr, scale, M, L, g, u, out),
                lambda: kp.posatt_bwd_dscale_reference(dist, thr, scale, M, L, g, u, out)),
            "posatt_bwd_du": (lambda: kp.posatt_bwd_du_cuda(dist, thr, scale, M, L, g),
                              lambda: kp.posatt_bwd_du_reference(dist, thr, scale, M, L, g)),
        }
        plain_reps = dict(reps=5, per_rep=2, warmup=1) if small_plain else {}
        out_rows = {}
        for kernel in kernels:
            launch, plain = calls[kernel]
            bound_ms, bound_by, flops, nbytes, kept = bound_bwd(kernel, dist, thr, Hs, Bs, Ds)
            Lo, Li = dist.shape
            splits = (kp._fwd_plan(False, Hs, Bs, Lo, Li, Ds)[2] if kernel == "posatt_stats"
                      else kp._bwd_plan(kernel == "posatt_bwd_du", Hs, Bs, Lo, Li, Ds)[1])
            out_rows[kernel] = {
                "shape": name, "H": Hs, "L_out": Lo, "L_in": Li, "B": Bs, "D": Ds,
                "kept_entries": kept, "kept_fraction": kept / (Lo * Li), "splits": splits,
                "launches_per_step": per_step[kernel], "max_abs_err": e[kernel],
                "ms": cuda_ms(launch), "plain_ms": cuda_ms(plain, **plain_reps),
                # no one PyTorch call computes any of these three functions
                "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
                "flops": flops, "bytes": nbytes,
            }
            log(f"kernel {kernel} {name}: {json.dumps(out_rows[kernel])}")
        return out_rows

    rows = {k: [] for k in BWD_KERNELS}
    errs = {k: 0.0 for k in BWD_KERNELS}
    fn_err = 0.0
    for name, dist, thr, D, n23, n4 in burgers:
        lmda, u, g, scale = inputs(dist, thr, H, B, D)
        # #2 is off every path (every forward writes M and L); its rows
        # count the shape in one Burgers forward, for its times
        per_step = {"posatt_stats": 0, "posatt_bwd_dscale": n23, "posatt_bwd_du": n4}
        got = timed_rows(name, dist, thr, lmda, u, g, scale, per_step,
                         [k for k in BWD_KERNELS if k != "posatt_bwd_du" or n4])
        got["posatt_stats"]["count_per_burgers_forward"] = n23
        for kernel, row in got.items():
            rows[kernel].append(row)
        if name != "encoder":  # the encoder's values need no gradient
            loc = m.de_loc if name == "decoder" else 1.0
            fn_err = max(fn_err, function_check(
                name, dist, lmda, u, loc, None if loc >= 1 else thr))

    # dscale and du through the kernel API at other fixed-mesh configs'
    # training shapes: vorticity (its geometry as build_geometry makes it),
    # one head at sod's widths, and cylinder's three ops (their launches in
    # one cylinder step)
    config_rows = {k: [] for k in BWD_KERNELS[1:]}
    for name, dist, thr, Bc, Hc, D, per_step in config_shapes():
        lmda, u, g, scale = inputs(dist, thr, Hc, Bc, D)
        got = timed_rows(name, dist, thr, lmda, u, g, scale, per_step, BWD_KERNELS[1:],
                         small_plain=True)
        for kernel, row in got.items():
            config_rows[kernel].append(row)
        del lmda, u, g, scale, got

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
    return rows, errs, config_rows


def cylinder_geometry(device):
    """configs.CYLINDER's geometry as setup_cylinder builds it: the
    synthetic 4390-point cloud to its 896-point latent cloud and back,
    Euclidean distances, locality 0.01."""
    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.data import synthetic
    from position_induced_transformer_torch.models import build_geometry

    cfg = configs.CYLINDER
    _, mesh, ltt = synthetic.cylinder(n_traj=1)  # the cloud does not depend on n_traj
    return build_geometry(mesh, ltt, mesh, metric=cfg.metric, en_loc=cfg.model.en_loc,
                          de_loc=cfg.model.de_loc, device=device)


def config_shapes():
    """The fixed-mesh training shapes of configs.VORTICITY (a 64^2 periodic
    grid to a 16^2 latent grid, periodic2d distances and quantile
    thresholds as build_geometry makes them; B 20, H 2: encoder D = in_dim
    + space_dim, processor and decoder D = hid_dim), one head at
    configs.SOD's widths (its 256-point latent processor, global, D 32,
    B 8), and configs.CYLINDER's (4390 -> 896 -> 4390 points, B 200, H 1,
    encoder D 5, processor and decoder D 256): (name, dist, thr, B, H, D,
    launches per training step by kernel: 0 outside the cylinder step) on
    the card."""
    import numpy as np
    import torch

    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.data import meshes
    from position_induced_transformer_torch.models import build_geometry
    from position_induced_transformer_torch.ops import distances

    cfg = configs.VORTICITY
    m = cfg.model

    def grid_2d(n):
        x = meshes.grid_1d(n)[:, 0]
        return np.stack(np.meshgrid(x, x, indexing="ij"), -1).reshape(-1, 2)

    geom = build_geometry(grid_2d(cfg.grid[0]), grid_2d(cfg.latent_grid[0]),
                          grid_2d(cfg.grid[0]), metric=cfg.metric, en_loc=m.en_loc,
                          de_loc=m.de_loc, device="cuda")
    inf = lambda Lo: torch.full((Lo, 1), float("inf"), device="cuda")
    B, H = cfg.batch_size, m.n_head
    sod = configs.SOD
    ltt = torch.from_numpy(meshes.grid_1d(sod.latent_grid[0], *sod.domain)).cuda()
    off = dict.fromkeys(BWD_KERNELS, 0)
    cyl, cg = configs.CYLINDER, cylinder_geometry("cuda")
    cm = cyl.model
    step = lambda n_ds, n_du: {"posatt_stats": 0, "posatt_bwd_dscale": n_ds, "posatt_bwd_du": n_du}
    return [
        ("vorticity_encoder", geom.dist_down, geom.thr_down, B, H, m.in_dim + m.space_dim, off),
        ("vorticity_processor", geom.dist_proc, inf(geom.dist_proc.shape[0]), B, H, m.hid_dim, off),
        ("vorticity_decoder", geom.dist_up, geom.thr_up, B, H, m.hid_dim, off),
        ("sod_processor", distances.euclidean_sq(ltt, ltt), inf(ltt.shape[0]),
         sod.batch_size, sod.model.n_head, sod.model.hid_dim, off),
        ("cylinder_encoder", cg.dist_down, cg.thr_down, cyl.batch_size, cm.n_head,
         cm.in_dim + cm.space_dim, step(1, 0)),
        ("cylinder_processor", cg.dist_proc, inf(cg.dist_proc.shape[0]), cyl.batch_size,
         cm.n_head, cm.hid_dim, step(cm.n_blocks, cm.n_blocks)),
        ("cylinder_decoder", cg.dist_up, cg.thr_up, cyl.batch_size, cm.n_head, cm.hid_dim,
         step(1, 1)),
    ]


def train_phase():
    """runner.train on full-width, full-depth Burgers on the card (phase 7)."""
    from position_induced_transformer_torch import configs

    cfg = configs.BURGERS
    return fixed_train_phase("train", cfg, 2, 64, 16, per_step_launches(cfg.model.n_blocks))


def post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def concurrent(label, request, ranges, timeout=330):
    """One request per sample range [i, j), all at once, each from its own
    thread. A thread records what came back, the reply's code and body or
    the exception with its traceback, and never fails itself (a SystemExit
    raised in a thread dies with it). Then, from the calling thread, fail
    with every request that got no 200 reply, naming its sample range;
    else return the bodies in order. ``timeout`` outlasts the client's."""
    outcomes = [None] * len(ranges)

    def run(k, i, j):
        try:
            outcomes[k] = request(i, j)
        except BaseException:
            outcomes[k] = traceback.format_exc()

    threads = [threading.Thread(target=run, args=(k, i, j), daemon=True)
               for k, (i, j) in enumerate(ranges)]
    for t in threads:
        t.start()
    deadline = time.perf_counter() + timeout
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.perf_counter()))
    bad = []
    for t, (i, j), got in zip(threads, ranges, outcomes):
        where = f"samples [{i}, {j})"
        if t.is_alive():
            bad.append(f"{where}: no outcome after {timeout} s")
        elif isinstance(got, str):
            bad.append(f"{where}: raised\n{got}")
        elif got[0] != 200:
            bad.append(f"{where}: HTTP {got[0]}: {got[1][:2000]!r}")
    if bad:
        fail(f"{label}: {len(bad)} of {len(ranges)} concurrent requests failed:\n" + "\n".join(bad))
    return [body for _, body in outcomes]


def npy(a):
    import numpy as np

    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def serve_phase():
    """A full-width Burgers model (random weights from a seeded generator)
    behind the port's HTTP server on the card (phase 6)."""
    import torch

    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.data import synthetic
    from position_induced_transformer_torch.train import benchmarks, checkpoint

    cfg = configs.BURGERS
    model = benchmarks._make_model(cfg, torch.Generator().manual_seed(0))
    ckpt = checkpoint.save(
        str(REPO / "build" / "chip_smoke" / "burgers.pt"), model.state_dict(), cfg.name
    )
    x, _ = synthetic.burgers(n=48, L=cfg.grid[0], seed=1)
    return fixed_serve_phase("serve", cfg, ckpt, x, cfg.model.n_blocks + 2, (1, 8, 13), 4, 20)


# ------------------------------------------------ elasticity: kernels #7, #8

ELASTICITY_B = 10  # the training and serving batch

RAGGED_BATCHED = [  # B, L_q, L_k, H, D, locality, thresholds: "none" (the
    # kernel's own keep count, or global), "robust" (precomputed), "ring"
    # (an angle-sorted ring with a circular band) or "arc" (queries on an
    # arc of the key ring, a circular band)
    ("b_h2_keep7", 2, 64, 64, 2, 8, 0.1, "none"),
    ("b_h1_global", 2, 64, 64, 1, 8, 1.0, "none"),
    ("b_h2_d19", 3, 37, 53, 2, 19, 0.1, "none"),
    ("b_h1_keep3", 2, 300, 120, 1, 4, 0.02, "none"),
    ("b_h4_d44", 2, 300, 120, 4, 44, 0.1, "robust"),
    ("b_h8_d19", 1, 97, 1000, 8, 19, 0.02, "robust"),
    ("b_ring_seam", 2, 900, 700, 2, 8, 0.02, "ring"),
    ("b_ring_h8_lout1000", 2, 1000, 800, 8, 33, 0.02, "ring"),
    ("b_h3_d8", 2, 64, 80, 3, 8, 0.1, "robust"),
    ("b_h6_keep", 2, 50, 60, 6, 40, 0.2, "none"),
    ("b_ring_h6", 2, 900, 700, 6, 12, 0.02, "ring"),
    # a global window past the kernels' 1024-column list: the list refills
    ("b_h2_d256_global_L1500", 1, 70, 1500, 2, 256, 1.0, "none"),
    # queries on an arc across the key ring's seam: one band tile of 200
    # rows covers them all, and its last 32-row block is short
    ("b_arc_lout200", 2, 200, 300, 2, 8, 0.02, "arc"),
]


def ring_cloud(rng, B, L):
    import numpy as np

    th = np.sort(rng.uniform(0, 2 * np.pi, (B, L)), axis=1)
    rad = 1.0 + 0.1 * rng.random((B, 1))
    return np.stack([rad * np.cos(th), rad * np.sin(th)], -1).astype(np.float32)


def arc_cloud(rng, B, L):
    """Points on the arc of a ring from -60 to 60 degrees, angle-sorted:
    across the seam of ring_cloud's angle order."""
    import numpy as np

    th = np.sort(rng.uniform(-np.pi / 3, np.pi / 3, (B, L)), axis=1)
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
    if kind in ("ring", "arc"):
        mq = to((ring_cloud if kind == "ring" else arc_cloud)(rng, B, Lq))
        mk = to(ring_cloud(rng, B, Lk))
    else:
        mq, mk = to(rng.random((B, Lq, 2))), to(rng.random((B, Lk, 2)))
    u = to(rng.random((B, Lk, D)))
    thr = band = None
    if kind != "none":
        thr = locality.batched_topk_thresholds(mq, mk, loc)
    if kind in ("ring", "arc"):
        starts, width, wrap = locality.batched_band_starts(
            mq, mk, thr, kb.band_tile_rows(Lq), circular=True)
        if not (starts.numpy() + width > Lk).any():
            fail(f"ring case {B}x{Lq}x{Lk}: no band crosses the seam")
        band = kb.BandSpec(starts.cuda(), width, wrap)
    return batched_case(rng, mq, mk, u, loc, thr, band, H)


def unsorted_permutation(L):
    """A fixed random order of L points, on the card."""
    import numpy as np
    import torch

    return torch.from_numpy(np.random.default_rng(7).permutation(L)).cuda()


def unsorted_batched(args):
    """A band-less self-attention op's launcher arguments (#7) with the
    cloud in a fixed random order, as a served request may hold it."""
    mq, mk, scale, u, thr, starts, kc, width = args
    perm = unsorted_permutation(mq.shape[1])
    mq = mq[:, perm].contiguous()
    return mq, mq, scale, u[:, perm].contiguous(), thr[:, perm].contiguous(), None, kc, 0


def unsorted_dist(call):
    """#9's arguments (distances, thresholds, scales, values) of a
    self-attention op with the cloud in the same random order."""
    dist, thr, scales, values = call
    perm = unsorted_permutation(dist.shape[1])
    return (dist[:, perm][:, :, perm].contiguous(), thr[:, perm].contiguous(), scales,
            values[:, perm].contiguous())


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


NACA_B = 20  # the training and serving batch


def naca_shapes(rng):
    """The attention calls of full-width NACA (1 head, hid 128) on its
    first training batch as setup_naca prepares it (synthetic airfoils,
    setup-time thresholds, the decoder's plain band of 256-row tiles): the
    encoder 728 x 120 (D 2), the global processor 728^2 (D 128) and the
    banded decoder 11,271 x 728 (D 128); and the served decoder, whose
    thresholds come per request and which has no band: name -> (launcher
    args, wrapper args, launches per forward)."""
    import numpy as np
    import torch

    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.train import benchmarks

    cfg = configs.NACA
    m = cfg.model
    problem = benchmarks.setup_naca(cfg, ntrain=NACA_B, ntest=2, device="cuda")
    batch = {k: torch.from_numpy(np.asarray(v)).cuda() for k, v in problem.train_data.items()}
    geom = problem.task.geom_fn(batch)
    hid = torch.from_numpy(rng.standard_normal((NACA_B, geom.mesh_ltt.shape[1], m.hid_dim))
                           .astype(np.float32)).cuda()
    H = m.n_head
    shapes = {
        "naca_encoder": (*batched_case(rng, geom.mesh_ltt, geom.mesh_in, batch["x"], m.en_loc,
                                       geom.thr_down, None, H), 1),
        "naca_processor": (*batched_case(rng, geom.mesh_ltt, geom.mesh_ltt, hid, 1.0, None, None, H),
                           m.n_blocks),
        "naca_decoder": (*batched_case(rng, geom.mesh_out, geom.mesh_ltt, hid, m.de_loc, geom.thr_up,
                                       geom.band_up, H), 1),
        "naca_serve_decoder": (*batched_case(rng, geom.mesh_out, geom.mesh_ltt, hid, m.de_loc,
                                             geom.thr_up, None, H), 1),
    }
    band = geom.band_up
    info = {"band_width": band.width, "band_tiles": band.starts.shape[1],
            "band_starts_sample0": band.starts[0].tolist(), "L_out": geom.mesh_out.shape[1],
            "L_latent": geom.mesh_ltt.shape[1], "L_in": geom.mesh_in.shape[1]}
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


def list_lengths(keep):
    """The redesigned kernels' compacted lists (#7, #8's dscale and du, #9,
    #11): per block of 32 owned indices (the first axis of ``keep`` (B,
    owned, streamed)), the streamed indices that keep an entry with any of
    them; mean and max over the blocks."""
    import torch

    B, n, m = keep.shape
    k = torch.zeros((B, -(-n // 32) * 32, m), dtype=torch.bool, device=keep.device)
    k[:, :n] = keep
    per = k.reshape(B, -1, 32, m).any(dim=2).sum(dim=-1).float()
    return {"mean": per.mean().item(), "max": int(per.max().item()), "blocks": per.numel()}


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
    n_shapes, n_info = naca_shapes(rng)
    log("naca band " + json.dumps(n_info))
    shapes.update(n_shapes)
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
            "shape": name, "config": "naca" if name.startswith("naca") else "elasticity",
            "H": H, "B": B, "L_out": Lo, "L_in": Li, "D": D,
            "band_width": width, "inspected": inspected, "kept_entries": kept,
            "launches_per_forward": per_forward, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "library_max_abs_err": lib_err,
            "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
            # the blocks own 32 rows and list the kept columns
            "list_length": list_lengths(keep),
        })
        log(f"kernel posatt_batched_fwd {name}: {json.dumps(rows[-1])}")
    for name, *shape in RAGGED_BATCHED:
        args, wargs = ragged_batched(rng, *shape)
        err, _ = compare(name, args, wargs)
        errs.append(err)
        mq, mk, scale, u, thr, starts, kc, width = args
        lists = list_lengths(kb._rows(mq, mk, thr, starts, kc, width)[1])
        log(f"kernel posatt_batched_fwd {name}: {shape} max_abs_err={err:.3e} "
            f"list_length={json.dumps(lists)}")
    # the served decoder over a cloud in a random order, as a request may
    # hold it: a 32-row block's list grows from tens of columns to hundreds
    mq, mk, scale, u, thr, starts, kc, width = unsorted_batched(shapes["serve_decoder"][0])
    run = lambda: kb.posatt_batched_cuda(mq, mk, scale, u, thr, keep_count=kc)
    want = kb.posatt_batched_reference(mq, mk, scale, u, thr, keep_count=kc)
    errs.append(check_close("serve_decoder_unsorted", run(), want, OP_RTOL, OP_ATOL))
    log("kernel posatt_batched_fwd serve_decoder_unsorted: " + json.dumps({
        "ms": cuda_ms(run), "max_abs_err": errs[-1],
        "list_length": list_lengths(kb._rows(mq, mk, thr, None, kc, 0)[1])}))
    return shapes, rows, max(errs)


def batched_backward_phase(shapes):
    """Kernel #8's entry points against their plain versions at the
    elasticity training shapes and at ragged ones, timed and bounded; the
    Function's gradients against torch.autograd of the oracle, with the
    stated launches per forward + backward; dscale twice, the same bits."""
    import numpy as np
    import torch

    from position_induced_transformer_torch.kernels import posatt_batched as kb
    from position_induced_transformer_torch.ops import posatt

    rng = np.random.default_rng(4)

    def compare(name, args, g, with_du=True):
        mq, mk, scale, u, thr, starts, kc, width = args
        out, stats = kb.posatt_batched_cuda(mq, mk, scale, u, thr, starts, keep_count=kc,
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
        ds = kb.posatt_batched_bwd_dscale_cuda(mq, mk, scale, u, out, g, stats, starts, **w)
        again = kb.posatt_batched_bwd_dscale_cuda(mq, mk, scale, u, out, g, stats, starts, **w)
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
        ds_size = size
        if with_du:
            du = kb.posatt_batched_bwd_du_cuda(mq, mk, scale, g, stats, starts, **w)
            torch.cuda.synchronize()
            want = kb.posatt_batched_bwd_du_reference(mq, mk, scale, g, stats, starts, **w)
            size = kb.posatt_batched_bwd_du_reference(mq, mk, scale, g.abs(), stats, starts, **w)
            errs["posatt_batched_bwd_du"] = check_close(f"{name} du", du, want, OP_RTOL, OP_ATOL, size)
        return errs, out, stats, keep, ds_size

    def function_check(name, wargs, need_du, w=None, ds_size=None):
        """One forward + backward through position_attention_batched launches
        the forward and dscale once and du once when the values need a
        gradient; its gradients match autograd of the oracle. ``ds_size``:
        the size of dscale's summed terms (B, H) for the cotangent ``w``,
        where the bandwidth gradient is held on unit-size terms as dscale
        is (NACA's shapes: their float32 oracle's bandwidth gradient itself
        is 0.3-2 % off a float64 one at the encoder, measured on the CPU);
        else it is held relative to its own largest entry."""
        mq, mk, lmda, u, loc, thr, band = wargs
        H, D = lmda.shape[0], u.shape[-1]
        if w is None:
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
        err = check_close(f"{name} Function out", got[0], want[0], OP_RTOL, OP_ATOL)
        if ds_size is None:
            err = max(err, check_close(f"{name} Function d lmda", got[1], want[1], DS_RTOL,
                                       DS_ATOL * want[1].abs().max().item()))
        else:  # d lmda = sum over samples of dscale * d scale / d lmda
            lm = lmda.clone().requires_grad_(True)
            dscale_dlmda, = torch.autograd.grad(posatt.bandwidth_scale(lm).sum(), lm)
            size = (ds_size.sum(0) * dscale_dlmda.abs().reshape(-1)).reshape(want[1].shape)
            check_close(f"{name} Function d lmda (normalised)", got[1] / size, want[1] / size,
                        DS_RTOL, DS_ATOL)
            err = max(err, (got[1] - want[1]).abs().max().item())
        if need_du:
            size_u = grads(batched_oracle, w.abs())[2]
            err = max(err, check_close(f"{name} Function d u", got[2], want[2], OP_RTOL, OP_ATOL, size_u))
        return err

    # launches per training step of dscale and du: the encoder's values are
    # the model input, which needs no gradient (elasticity and NACA alike)
    per_step = {"encoder": (1, 0), "processor": (4, 4), "decoder": (1, 1),
                "naca_encoder": (1, 0), "naca_processor": (4, 4), "naca_decoder": (1, 1)}
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
        e, out, stats, keep, ds_size = compare(name, args, g, with_du=n_du > 0)
        for k, v in e.items():
            errs[k] = max(errs[k], v)
        inspected, kept, _ = batched_work(args, keep)
        flops = 3 * d * inspected + 2 * H * D * kept
        # coordinates, starts, statistics and the cotangent; dscale reads
        # the values and writes (B, H), du writes dU
        words = B * Lo * d + B * Li * d + B * (H + 2) * Lo + B * Lo * H * D
        words += starts.numel() if starts is not None else 0
        w = dict(width=width)
        # dscale's kernel also reads the forward's output, which the function
        # does not need: the bound leaves it out. The compacted lists: dscale
        # blocks own 32 rows and list keys, du blocks the reverse
        calls = {
            "posatt_batched_bwd_dscale": (
                lambda: kb.posatt_batched_bwd_dscale_cuda(mq, mk, scale, u, out, g, stats, starts, **w),
                lambda: kb.posatt_batched_bwd_dscale_reference(mq, mk, scale, u, g, stats, starts, **w),
                n_ds, words + B * Li * D + B * H, list_lengths(keep)),
            "posatt_batched_bwd_du": (
                lambda: kb.posatt_batched_bwd_du_cuda(mq, mk, scale, g, stats, starts, **w),
                lambda: kb.posatt_batched_bwd_du_reference(mq, mk, scale, g, stats, starts, **w),
                n_du, words + B * Li * D, list_lengths(keep.transpose(1, 2))),
        }
        for kernel, (launch, plain, n, nwords, lists) in calls.items():
            if not n:
                continue
            bound_ms, bound_by = roofline(flops, 4 * nwords)
            rows[kernel].append({
                "shape": name, "config": "naca" if name.startswith("naca") else "elasticity",
                "H": H, "B": B, "L_out": Lo, "L_in": Li, "D": D,
                "band_width": width, "inspected": inspected, "kept_entries": kept,
                "launches_per_step": n, "max_abs_err": e[kernel], "ms": cuda_ms(launch),
                "plain_ms": cuda_ms(plain, reps=10, per_rep=3),
                # no one PyTorch call computes either function
                "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
                "flops": flops, "bytes": 4 * nwords, "list_length": lists,
            })
            log(f"kernel {kernel} {name}: {json.dumps(rows[kernel][-1])}")
        naca = name.startswith("naca")
        fn_err = max(fn_err, function_check(name, wargs, need_du=n_du > 0, w=g if naca else None,
                                            ds_size=ds_size if naca else None))
    for name, *shape in RAGGED_BATCHED:
        args, wargs = ragged_batched(rng, *shape)
        B, Lo = args[0].shape[:2]
        HD = args[2].shape[0] * args[3].shape[-1]
        g = torch.from_numpy(rng.standard_normal((B, Lo, HD)).astype(np.float32)).cuda()
        e, _, _, _, _ = compare(name, args, g)
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

    def request(i, j):
        return post(url, mat_bytes(x=X[i:j], mesh=ext[i:j]))

    def accept(i, j, code, body):
        if code != 200:
            fail(f"elasticity serve: HTTP {code} for samples [{i}, {j}): {body[:500]!r}")
        sent.append((X[i:j], ext[i:j], np.load(io.BytesIO(body))))

    def ask(i, j):
        accept(i, j, *request(i, j))

    try:
        zero_counts()
        calls0 = server.batcher.n_calls
        t0 = time.perf_counter()
        ask(0, 1)
        first_ms = (time.perf_counter() - t0) * 1e3
        ask(1, 11)
        ask(11, 24)  # 13 samples: one full and one padded batch
        ranges = [(24 + 3 * i, 27 + 3 * i) for i in range(4)]
        for (i, j), body in zip(ranges, concurrent("elasticity serve", request, ranges)):
            accept(i, j, 200, body)
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


def run_training(cfg, device, epochs, ntrain, ntest, patch=None, **train_kw):
    """runner.train with the launch counts zeroed first; returns the
    problem, state, history, per-step losses, final weights, launches and
    seconds. ``patch``: a context manager around the run; ``train_kw``:
    more arguments of runner.train."""
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
            **train_kw,
        )
    seconds = time.perf_counter() - t0
    launched = counts()
    weights = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    return problem, state, history, torch.cat(step_losses).cpu(), weights, launched, seconds


def step_timing(problem, state, batch_size, n_rows, lr, groups=None):
    """Wall time of synchronised training steps on the trained state at a
    constant learning rate, steps/s, and the device's busy share (with the
    device time of the kernels in ``groups``, as profile_device takes it)."""
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
        "profile_warm_steps": profile_device(one_step, "step", groups=groups),
        "batch": batch_size,
    }


def elasticity_train_phase():
    """runner.train on full-width elasticity on the card (synthetic data,
    80 training and 20 test samples, 2 epochs of 8 steps at batch 10):
    exactly 6/6/5 launches of the batched forward/dscale/du per step and 6
    forward launches per eval batch; losses and weights against a
    plain-attention card run, the first two steps against a CPU run; then
    the time per step."""
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
    _, _, _, ref_losses, ref_weights, ref_launched, ref_s = run_training(
        cfg, "cuda", epochs, ntrain, ntest, patch)
    if any(ref_launched.values()):
        fail(f"elasticity train: the plain_cuda run launched kernels: {ref_launched}")
    report["max_abs_err_step_loss_vs_plain_cuda"] = check_close(
        "elasticity train losses vs plain_cuda", losses, ref_losses, LOSS_RTOL, 0.0)
    report["max_abs_err_weights_vs_plain_cuda"] = max(
        check_close(f"elasticity train weight {k} vs plain_cuda", v, ref_weights[k],
                    PARAM_RTOL, PARAM_ATOL)
        for k, v in weights.items())
    report["seconds_whole_run_plain_cuda"] = ref_s
    # the whole run takes about 100 s on the CPU: its first two steps, as
    # the card's first two
    n = 2
    card_losses, card_weights, _ = first_steps(cfg, "cuda", n, ntrain, ntest, epochs)
    check_close("elasticity first steps vs the full run", card_losses, losses[:n], LOSS_RTOL, 0.0)
    t0 = time.perf_counter()
    cpu_losses, cpu_weights, cpu_launched = first_steps(cfg, "cpu", n, ntrain, ntest, epochs)
    report["seconds_first_steps_cpu"] = time.perf_counter() - t0
    if any(cpu_launched.values()):
        fail(f"elasticity train: the CPU run launched kernels: {cpu_launched}")
    report["cpu_steps_compared"] = n
    report["max_abs_err_step_loss_vs_cpu"] = check_close(
        "elasticity train losses vs cpu", card_losses, cpu_losses, LOSS_RTOL, 0.0)
    report["max_abs_err_weights_vs_cpu"] = max(
        check_close(f"elasticity train weight {k} vs cpu", v, cpu_weights[k], PARAM_RTOL,
                    PARAM_ATOL)
        for k, v in card_weights.items())
    report.update(step_timing(problem, state, cfg.batch_size, ntrain, cfg.lr))
    return report


# ------------------------------------- elasticity_tf: kernels #9 - #12

RAGGED_TF = [  # B, L_q, L_k, H, V, thresholds: "none" (global), "thr" (a
    # percentile per row) or "ring" (angle-sorted rings, a circular band)
    ("tf_h2_v3_global", 2, 48, 48, 2, 3, "none"),
    ("tf_h8_v3_thr", 2, 37, 53, 8, 3, "thr"),
    ("tf_h4_v19_thr", 1, 97, 1000, 4, 19, "thr"),
    ("tf_h1_v130_global", 2, 1000, 97, 1, 130, "none"),
    ("tf_ring_seam", 2, 900, 700, 2, 8, "ring"),
    ("tf_ring_h8_lout1000", 2, 1000, 800, 8, 33, "ring"),
    # V not a multiple of the backward's 64-column tile; a band whose row
    # blocks keep no entry in some 32-column steps of their window
    ("tf_ring_h3_v80", 2, 900, 700, 3, 80, "ring"),
    ("tf_h5_v100_thr", 2, 300, 200, 5, 100, "thr"),
    # a global window past the kernels' 1024-column list: the list refills
    ("tf_h8_v64_global_L1500", 1, 70, 1500, 8, 64, "none"),
]


def tf_scales(rng, H, device):
    import numpy as np
    import torch

    r = rng.uniform(-0.6, 0.6, (H, 1)).astype(np.float32)  # the glorot range of r at 8 heads
    return torch.from_numpy(r * r).to(device)


def tf_calls(mq, mk, scales, values, thr, band):
    """The three forms of one TF op: the coordinate launcher's arguments
    (mq, mk, 0.5 s, v, 2 thr, starts, width) on the extended key axis, the
    pre-built-distance launcher's (half distances, thr, s, values), and the
    wrapper's (mq, mk, s, values, thr, band); ``thr`` is on the halved
    distances."""
    import torch

    from position_induced_transformer_torch.models import pit_tf

    mk_e, v_e = mk, values
    if band is not None and band.wrap:
        mk_e = torch.cat([mk, mk[:, : band.wrap]], 1)
        v_e = torch.cat([values, values[:, : band.wrap]], 1)
    coord = (mq, mk_e, 0.5 * scales, v_e, None if thr is None else 2.0 * thr,
             None if band is None else band.starts, 0 if band is None else band.width)
    dist = (pit_tf.pairwise_dist_half(mq, mk), thr, scales, values)
    return coord, dist, (mq, mk, scales, values, thr, band)


def tf_ragged(rng, B, Lq, Lk, H, V, kind):
    import numpy as np
    import torch

    from position_induced_transformer_torch.kernels import posatt_batched as kb
    from position_induced_transformer_torch.models import pit_tf
    from position_induced_transformer_torch.ops import locality

    to = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()
    if kind == "ring":
        mq, mk = to(ring_cloud(rng, B, Lq)), to(ring_cloud(rng, B, Lk))
    else:
        mq, mk = to(rng.random((B, Lq, 2))), to(rng.random((B, Lk, 2)))
    values = to(rng.standard_normal((B, Lk, H * V)))
    half = pit_tf.pairwise_dist_half(mq, mk)
    thr = band = None
    if kind == "thr":
        thr = locality.quantile_threshold(half, 0.3)
    elif kind == "ring":
        thr = locality.robust_topk_threshold(half, 0.02)
        starts, width, wrap = locality.batched_band_starts(
            mq, mk, 2.0 * thr, kb.band_tile_rows(Lq), circular=True)
        if not (starts.numpy() + width > Lk).any():
            fail(f"TF ring case {B}x{Lq}x{Lk}: no band crosses the seam")
        band = kb.BandSpec(starts.cuda(), width, wrap)
    return tf_calls(mq, mk, tf_scales(rng, H, mq.device), values, thr, band)


def tf_oracle(mq, mk, scales, values, thr=None, band=None):
    """TF attention over materialized halved distances, differentiable by
    autograd; a band holds every kept column, so the oracle needs none."""
    from position_induced_transformer_torch.kernels import posatt_batched as kb
    from position_induced_transformer_torch.models import pit_tf

    return kb.posatt_tf_reference(pit_tf.pairwise_dist_half(mq, mk), thr, scales, values)


def plain_tf_dist(dist, scales, values, thr=None):
    from position_induced_transformer_torch.kernels import posatt_batched as kb

    return kb.posatt_tf_reference(dist, thr, scales, values)


@contextmanager
def plain_tf_attention():
    """The TF model's attention ops on their plain versions: no kernel."""
    from position_induced_transformer_torch.models import pit_tf

    with mock.patch.object(pit_tf, "position_attention_batched_dist", plain_tf_dist), \
            mock.patch.object(pit_tf, "position_attention_batched_tf_coords", tf_oracle):
        yield


def elasticity_tf_shapes(rng):
    """The attention calls of full-width elasticity_tf: on its first
    training batch as setup_elasticity_tf prepares it (angle-sorted clouds,
    thresholds on the halved distances, circular band starts; kernel #11),
    and on a served batch (thresholds from quantile_threshold of the
    model's pre-built halved distances; kernel #9): name -> (calls, kind,
    launches per forward)."""
    import numpy as np
    import torch

    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.models import pit_tf
    from position_induced_transformer_torch.ops import locality
    from position_induced_transformer_torch.train import benchmarks

    cfg = configs.ELASTICITY_TF
    m = cfg.model
    problem = benchmarks.setup_elasticity_tf(cfg, ntrain=ELASTICITY_B, ntest=2, device="cuda")
    batch = {k: torch.from_numpy(v).cuda() for k, v in problem.train_data.items()}
    geom = problem.task.geom_fn(batch)
    c = batch["x"][..., :2].contiguous()
    H = m.n_head
    vals = lambda: torch.from_numpy(
        rng.standard_normal((ELASTICITY_B, c.shape[1], m.hid_dim)).astype(np.float32)).cuda()
    s = lambda: tf_scales(rng, H, c.device)
    serve_thr = locality.quantile_threshold(pit_tf.pairwise_dist_half(c, c), m.en_loc / 100.0)
    shapes = {
        "encoder": (tf_calls(c, c, s(), vals(), geom["thr_en"], geom["band_en"]), "coord", 1),
        "processor": (tf_calls(c, c, s(), vals(), None, None), "coord", m.n_blocks),
        "decoder": (tf_calls(c, c, s(), vals(), geom["thr_de"], geom["band_de"]), "coord", 1),
        "serve_encoder": (tf_calls(c, c, s(), vals(), serve_thr, None), "dist", 1),
        "serve_processor": (tf_calls(c, c, s(), vals(), None, None), "dist", m.n_blocks),
        "serve_decoder": (tf_calls(c, c, s(), vals(), serve_thr, None), "dist", 1),
    }
    band = geom["band_en"]
    info = {"band_width": band.width, "band_wrap": band.wrap,
            "band_starts_sample0": band.starts[0].tolist()}
    return shapes, info


def tf_rows(calls, kind):
    """(distances as the kernel sees them, keep mask, bare minimum) of one
    op: full squared distances for the coordinate kernel (its scale and
    thresholds carry the halving), the pre-built halved ones for #9."""
    from position_induced_transformer_torch.kernels import posatt_batched as kb

    coord, dist, _ = calls
    if kind == "coord":
        mq, mk, scale, v, thr, starts, width = coord
        return kb._tf_coord_rows(mq, mk, thr, starts, width)
    d, thr, scale, values = dist
    keep, dmin, _ = kb._tf_keep(d, thr)
    return d, keep, dmin


def tf_work(calls, kind, keep):
    """Distances inspected (every column of each row's window), kept
    entries, and the words the forward must move: the coordinates (or the
    pre-built distances), thresholds, starts, values and output, once each."""
    from position_induced_transformer_torch.kernels import posatt_batched as kb

    coord, dist, _ = calls
    if kind == "coord":
        mq, mk, scale, v, thr, starts, width = coord
        B, Lo, d = mq.shape
        Li = mk.shape[1]
        win = kb._window(starts, width, Lo, Li, mq.device)
        inspected = B * Lo * Li if win is None else int(win.sum())
        words = B * Lo * d + B * Li * d + (starts.numel() if starts is not None else 0)
    else:
        dd, thr, scale, v = dist
        B, Lo, Li = dd.shape
        d, inspected, words = 0, B * Lo * Li, B * Lo * Li
    words += (B * Lo if thr is not None else 0) + B * Li * v.shape[-1] + B * Lo * v.shape[-1]
    return inspected, int(keep.sum()), words, d


def tf_launch(calls, kind, stats=False):
    from position_induced_transformer_torch.kernels import posatt_batched as kb

    coord, dist, _ = calls
    if kind == "coord":
        mq, mk, scale, v, thr, starts, width = coord
        return kb.posatt_tf_coord_cuda(mq, mk, scale, v, thr, starts, width=width, stats=stats)
    return kb.posatt_tf_cuda(*dist, stats=stats)


def tf_plain(calls, kind):
    from position_induced_transformer_torch.kernels import posatt_batched as kb

    coord, dist, _ = calls
    if kind == "coord":
        mq, mk, scale, v, thr, starts, width = coord
        return kb.posatt_tf_coord_reference(mq, mk, scale, v, thr, starts, width=width)
    return kb.posatt_tf_reference(*dist)


def tf_kernel_phase():
    """Kernels #9 and #11 against their plain versions at the elasticity_tf
    shapes and at ragged ones, the public wrappers against the oracle;
    times, bounds and the SDPA yardstick at the elasticity_tf shapes."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from position_induced_transformer_torch.kernels import posatt_batched as kb

    rng = np.random.default_rng(5)

    def compare(name, calls, kind):
        got = tf_launch(calls, kind)
        torch.cuda.synchronize()
        want = tf_plain(calls, kind)
        err = check_close(name, got, want, OP_RTOL, OP_ATOL)
        mq, mk, scales, values, thr, band = calls[2]
        counter = kb.posatt_tf_coord_cuda if kind == "coord" else kb.posatt_tf_cuda
        before = counter.launches
        with torch.no_grad():
            if kind == "coord":
                got = kb.position_attention_batched_tf_coords(mq, mk, scales, values, thr, band)
            else:
                got = kb.position_attention_batched_dist(calls[1][0], scales, values, thr)
        torch.cuda.synchronize()
        if counter.launches != before + 1:
            fail(f"{name}: the {kind} wrapper did not launch its kernel once")
        want = tf_oracle(mq, mk, scales, values, thr)
        return max(err, check_close(f"{name} (wrapper)", got, want, OP_RTOL, OP_ATOL)), want

    shapes, info = elasticity_tf_shapes(rng)
    log("elasticity_tf band " + json.dumps(info))
    rows, errs = {"coord": [], "dist": []}, {"coord": 0.0, "dist": 0.0}
    for name, (calls, kind, per_forward) in shapes.items():
        err, want = compare(name, calls, kind)
        errs[kind] = max(errs[kind], err)
        ms = cuda_ms(lambda: tf_launch(calls, kind))
        plain_ms = cuda_ms(lambda: tf_plain(calls, kind), reps=10, per_rep=3)
        # yardstick: one SDPA call with zero q and k, per-head values and
        # the masked logits as attn_mask (built outside the timing)
        dist, keep, _ = tf_rows(calls, kind)
        scale = calls[0][2] if kind == "coord" else calls[1][2]
        v = calls[0][3] if kind == "coord" else calls[1][3]
        B, Lo, Li = dist.shape
        H = scale.shape[0]
        V = v.shape[-1] // H
        logits = torch.where(keep[:, None], -dist[:, None] * scale.reshape(1, H, 1, 1), -1e38)
        q = torch.zeros((B, H, Lo, V), device=dist.device)
        k = torch.zeros((B, H, Li, V), device=dist.device)
        vv = v.reshape(B, Li, H, V).permute(0, 2, 1, 3).contiguous()
        sdpa = lambda: F.scaled_dot_product_attention(q, k, vv, attn_mask=logits)
        lib_err = (sdpa().permute(0, 2, 1, 3).reshape(B, Lo, H * V) - want).abs().max().item()
        library_ms = cuda_ms(sdpa)
        del logits, q, k, vv
        inspected, kept, words, d = tf_work(calls, kind, keep)
        flops = 3 * d * inspected + 2 * H * V * kept
        bound_ms, bound_by = roofline(flops, 4 * words)
        rows[kind].append({
            "shape": name, "H": H, "V": V, "B": B, "L_out": Lo, "L_in": Li,
            "band_width": calls[0][6] if kind == "coord" else 0, "inspected": inspected,
            "kept_entries": kept, "launches_per_forward": per_forward, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_max_abs_err": lib_err, "bound_ms": bound_ms, "bound_by": bound_by,
            "flops": flops, "bytes": 4 * words,
        })
        # #9's and #11's blocks own 32 rows and list the kept columns
        rows[kind][-1]["list_length"] = list_lengths(keep)
        kernel = "posatt_tf_coord_fwd" if kind == "coord" else "posatt_tf_fwd"
        log(f"kernel {kernel} {name}: {json.dumps(rows[kind][-1])}")
    # #9's served encoder over a cloud in a random order, as a request may
    # hold it: a 32-row block's list grows from tens of columns to hundreds
    dist, thr, scales, values = unsorted_dist(shapes["serve_encoder"][0][1])
    run = lambda: kb.posatt_tf_cuda(dist, thr, scales, values)
    err = check_close("serve_encoder_unsorted", run(), kb.posatt_tf_reference(dist, thr, scales, values),
                      OP_RTOL, OP_ATOL)
    errs["dist"] = max(errs["dist"], err)
    log("kernel posatt_tf_fwd serve_encoder_unsorted: " + json.dumps({
        "ms": cuda_ms(run), "max_abs_err": err,
        "list_length": list_lengths(kb._tf_keep(dist, thr)[0])}))
    for name, *shape in RAGGED_TF:
        calls = tf_ragged(rng, *shape)
        lists = {}
        for kind in ("coord", "dist"):
            err, _ = compare(f"{name} {kind}", calls, kind)
            errs[kind] = max(errs[kind], err)
            lists[kind] = list_lengths(tf_rows(calls, kind)[1])
        log(f"kernels posatt_tf_fwd, posatt_tf_coord_fwd {name}: {shape} max_abs_err={err:.3e} "
            f"list_length={json.dumps(lists)}")
    return shapes, rows, errs


def tf_backward_phase(shapes):
    """#10's and #12's entry points against their plain versions at the
    elasticity_tf shapes (#12 at the training ones, #10 at the served ones,
    which a step without thresholds takes) and at ragged ones, timed and
    bounded; dscale twice, the same bits; the Functions' gradients against
    torch.autograd of the oracle, one forward + backward launching each
    entry point once."""
    import numpy as np
    import torch

    from position_induced_transformer_torch.kernels import posatt_batched as kb

    rng = np.random.default_rng(6)

    def entry_points(calls, kind, out, g, stats):
        """(dscale, dv) launchers of one op; dscale reads the forward's
        output ``out``."""
        coord, dist, _ = calls
        if kind == "coord":
            mq, mk, scale, v, thr, starts, width = coord
            return (lambda: kb.posatt_tf_coord_bwd_dscale_cuda(mq, mk, scale, v, out, g, stats,
                                                               starts, width=width),
                    lambda: kb.posatt_tf_coord_bwd_dv_cuda(mq, mk, scale, g, stats, starts, width=width))
        d, thr, scale, v = dist
        return (lambda: kb.posatt_tf_bwd_dscale_cuda(d, scale, v, out, g, stats),
                lambda: kb.posatt_tf_bwd_dv_cuda(d, scale, g, stats))

    def empty_steps(calls):
        """Of the 32-column steps of each 32-row block's band window, those
        in which no row of the block keeps an entry, and all of them."""
        mq, mk, scale, v, thr, starts, width = calls[0]
        _, keep, _ = kb._tf_coord_rows(mq, mk, thr, starts, width)
        B, Lo, Li = keep.shape
        tile = kb.band_tile_rows(Lo)
        empty = total = 0
        for r0 in range(0, Lo, 32):
            cols = keep[:, r0:r0 + 32].any(dim=1).cpu()  # (B, Li)
            for b, st in enumerate(starts[:, r0 // tile].tolist()):
                lo, hi = max(st, 0), min(st + width, Li)
                for j0 in range(lo, hi, 32):
                    total += 1
                    empty += int(not cols[b, j0:min(j0 + 32, hi)].any())
        return empty, total

    def plain_bwd(calls, kind, g):
        coord, dist, _ = calls
        if kind == "coord":
            mq, mk, scale, v, thr, starts, width = coord
            return kb.posatt_tf_coord_bwd_reference(mq, mk, scale, v, g, thr, starts, width=width)
        d, thr, scale, v = dist
        return kb.posatt_tf_bwd_reference(d, thr, scale, v, g)

    def compare(name, calls, kind, g):
        out, stats = tf_launch(calls, kind, stats=True)
        torch.cuda.synchronize()
        dscale, dv = entry_points(calls, kind, out, g, stats)
        ds, again, dvv = dscale(), dscale(), dv()
        torch.cuda.synchronize()
        if not torch.equal(ds, again):
            fail(f"{name}: two dscale runs on the same inputs differ")
        want_dv, want_ds = plain_bwd(calls, kind, g)
        size_dv, _ = plain_bwd(calls, kind, g.abs())
        errs = {"dv": check_close(f"{name} dv", dvv, want_dv, OP_RTOL, OP_ATOL, size_dv)}
        # the size of dscale's summed terms per sample and head:
        # sum_i |w_i| + |r_i v_i| with T = G_h V_h^T
        dist, keep, dmin = tf_rows(calls, kind)
        scale = calls[0][2] if kind == "coord" else calls[1][2]
        v = calls[0][3] if kind == "coord" else calls[1][3]
        att = kb._tf_attention(dist, keep, dmin, scale)
        B, H, Lo, Li = att.shape
        t = torch.einsum("bihv,bjhv->bhij", g.reshape(B, Lo, H, -1), v.reshape(B, Li, H, -1))
        nd = torch.where(keep, dist, 0.0)[:, None]
        size = ((att * t * nd).sum(-1).abs() + (att * t).sum(-1).abs() * (att * nd).sum(-1)).sum(-1)
        del att, t, nd
        check_close(f"{name} dscale (normalised)", ds / size, want_ds / size, DS_RTOL, DS_ATOL)
        errs["dscale"] = (ds - want_ds).abs().max().item()
        return errs, stats, keep, (dscale, dv)

    def function_check(name, calls, kind):
        """One forward + backward through the public wrapper launches the
        forward and each backward entry point once; gradients match
        autograd of the oracle."""
        mq, mk, scales, values, thr, band = calls[2]
        w = torch.from_numpy(rng.standard_normal((values.shape[0], mq.shape[1], values.shape[2]))
                             .astype(np.float32)).cuda()
        half = calls[1][0]

        def grads(fn, w):
            s = scales.clone().requires_grad_(True)
            x = values.clone().requires_grad_(True)
            out = fn(s, x)
            (out * w).sum().backward()
            return out.detach(), s.grad, x.grad

        if kind == "coord":
            fn = lambda s, x: kb.position_attention_batched_tf_coords(mq, mk, s, x, thr, band)
        else:
            fn = lambda s, x: kb.position_attention_batched_dist(half, s, x, thr)
        before = counts()
        got = grads(fn, w)
        torch.cuda.synchronize()
        after = counts()
        names = TF_COORD_KERNELS if kind == "coord" else TF_DIST_KERNELS
        diff = {k: after[k] - before[k] for k in after}
        if diff != {k: int(k in names) for k in after}:
            fail(f"{name}: one forward + backward launched {diff}, expected 1 each of {names}")
        oracle = lambda s, x: tf_oracle(mq, mk, s, x, thr)
        want = grads(oracle, w)
        size_v = grads(oracle, w.abs())[2]
        return max(
            check_close(f"{name} Function out", got[0], want[0], OP_RTOL, OP_ATOL),
            check_close(f"{name} Function d scales", got[1], want[1], DS_RTOL,
                        DS_ATOL * want[1].abs().max().item()),
            check_close(f"{name} Function d values", got[2], want[2], OP_RTOL, OP_ATOL, size_v),
        )

    rows = {"coord": [], "dist": []}
    errs = {"coord": {"dscale": 0.0, "dv": 0.0}, "dist": {"dscale": 0.0, "dv": 0.0}}
    fn_err = 0.0
    for name, (calls, kind, per_step) in shapes.items():
        v = calls[0][3] if kind == "coord" else calls[1][3]
        B, Lo = calls[2][0].shape[:2]
        g = torch.from_numpy(rng.standard_normal((B, Lo, v.shape[-1])).astype(np.float32)).cuda()
        e, stats, keep, (dscale, dv) = compare(name, calls, kind, g)
        for k, x in e.items():
            errs[kind][k] = max(errs[kind][k], x)
        inspected, kept, fwd_words, d = tf_work(calls, kind, keep)
        H = stats.shape[1] - 2
        V = v.shape[-1] // H
        flops = 3 * d * inspected + 2 * H * V * kept
        # the forward's words with the statistics (which hold the threshold)
        # in place of thr and the cotangent in place of the output; dscale
        # also writes (B, H), dv writes dV where dscale reads the values.
        # dscale's kernel also reads the forward's output, which the
        # function does not need: the bound leaves it out
        Li = v.shape[1]
        words = fwd_words - (B * Lo if calls[2][4] is not None else 0) + B * (H + 2) * Lo
        parts = {"dscale": (dscale, words + B * H), "dv": (dv, words)}
        row = {"shape": name, "H": H, "V": V, "B": B, "L_out": Lo, "L_in": Li,
               "inspected": inspected, "kept_entries": kept, "launches_per_step": per_step,
               "max_abs_err": e}
        for part, (launch, nwords) in parts.items():
            bound_ms, bound_by = roofline(flops, 4 * nwords)
            row[part] = {"ms": cuda_ms(launch), "bound_ms": bound_ms, "bound_by": bound_by,
                         "flops": flops, "bytes": 4 * nwords}
        row["ms"] = row["dscale"]["ms"] + row["dv"]["ms"]
        row["bound_ms"] = row["dscale"]["bound_ms"] + row["dv"]["bound_ms"]
        row["bound_by"] = row["dscale"]["bound_by"]
        # the plain version computes both gradients at once
        row["plain_ms"] = cuda_ms(lambda: plain_bwd(calls, kind, g), reps=5, per_rep=2)
        # no one PyTorch call computes either function
        row["library_ms"] = None
        rows[kind].append(row)
        kernel = "posatt_tf_coord_bwd" if kind == "coord" else "posatt_tf_bwd"
        log(f"kernel {kernel} {name}: {json.dumps(row)}")
        if name in ("encoder", "processor", "serve_encoder"):
            fn_err = max(fn_err, function_check(name, calls, kind))
    for name, *shape in RAGGED_TF:
        calls = tf_ragged(rng, *shape)
        if shape[-1] == "ring":
            empty, total = empty_steps(calls)
            log(f"backward {name}: {empty} of {total} 32-column steps of the row blocks' "
                "windows keep no entry")
            if empty == 0:
                fail(f"{name}: every 32-column step of the band keeps an entry")
        B, Lo = calls[2][0].shape[:2]
        g = torch.from_numpy(rng.standard_normal((B, Lo, calls[2][3].shape[-1])).astype(np.float32)).cuda()
        for kind in ("coord", "dist"):
            e, _, _, _ = compare(f"{name} {kind}", calls, kind, g)
            for k, x in e.items():
                errs[kind][k] = max(errs[kind][k], x)
            fn_err = max(fn_err, function_check(f"{name} {kind}", calls, kind))
        log(f"backward {name}: {shape} max_abs_err={json.dumps(errs)}")
    log(f"PosAttTF, PosAttTFCoord: gradients match autograd of the oracle, max abs err {fn_err:.3e}")
    return rows, errs


def elasticity_tf_serve_phase():
    """make_server("elasticity_tf") with a seeded random-weight checkpoint
    on the card, answering bare .npy bodies (1, 10, 13 samples, 4
    concurrent, 20 warm); every reply 200 and in agreement with a
    plain-attention card run and (the first three requests) a CPU run;
    exactly 6 launches of kernel #9 per device batch and no other kernel."""
    import numpy as np
    import torch

    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.data import synthetic
    from position_induced_transformer_torch.train import benchmarks, checkpoint
    from position_induced_transformer_torch.train.evaluate import Predictor
    from position_induced_transformer_torch.train.serve import make_server

    cfg = configs.ELASTICITY_TF
    model = benchmarks._make_model(cfg, torch.Generator().manual_seed(0))
    ckpt = checkpoint.save(
        str(REPO / "build" / "chip_smoke" / "elasticity_tf.pt"), model.state_dict(), cfg.name
    )
    t0 = time.perf_counter()
    server = make_server(cfg.name, ckpt, host="127.0.0.1", port=0, verbose=False, device="cuda")
    startup_s = time.perf_counter() - t0
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/predict"
    X, _, _ = synthetic.elasticity(n=50, seed=1)
    sent = []  # (x, reply)

    def request(i, j):
        return post(url, npy(X[i:j]))

    def accept(i, j, code, body):
        if code != 200:
            fail(f"elasticity_tf serve: HTTP {code} for samples [{i}, {j}): {body[:500]!r}")
        sent.append((X[i:j], np.load(io.BytesIO(body))))

    def ask(i, j):
        accept(i, j, *request(i, j))

    try:
        zero_counts()
        calls0 = server.batcher.n_calls
        t0 = time.perf_counter()
        ask(0, 1)
        first_ms = (time.perf_counter() - t0) * 1e3
        ask(1, 11)
        ask(11, 24)  # 13 samples: one full and one padded batch
        ranges = [(24 + 3 * i, 27 + 3 * i) for i in range(4)]
        for (i, j), body in zip(ranges, concurrent("elasticity_tf serve", request, ranges)):
            accept(i, j, 200, body)
        warm = []
        for i in range(20):
            t0 = time.perf_counter()
            ask(10 * (i % 5), 10 * (i % 5) + 10)
            warm.append((time.perf_counter() - t0) * 1e3)
        launched = counts()
        device_calls = server.batcher.n_calls - calls0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)

    expected = {k: 6 * device_calls if k == "posatt_tf_fwd" else 0 for k in launched}
    if launched != expected or device_calls < 25:
        fail(f"elasticity_tf serve: {launched} for {device_calls} device batches "
             "(expected 6 launches of #9 per batch and nothing else)")

    predictor = server.predictor
    err_plain = err_cpu = 0.0
    with plain_tf_attention():
        for a, out in sent:
            before = counts()
            ref = torch.from_numpy(predictor.predict_array({"x": a}))
            if counts() != before:
                fail("elasticity_tf serve: the plain comparison run launched a kernel")
            got = torch.from_numpy(out)
            if got.shape != (a.shape[0], a.shape[1], cfg.model.out_dim):
                fail(f"elasticity_tf serve: reply shape {tuple(got.shape)}")
            err_plain = max(err_plain, check_close(
                "elasticity_tf serve vs plain on CUDA", got, ref, MODEL_RTOL, MODEL_ATOL))
    cpu = Predictor(cfg.name, ckpt, device="cpu")
    t0 = time.perf_counter()
    for a, out in sent[:3]:  # 24 samples: the CPU takes seconds per batch
        ref_cpu = torch.from_numpy(cpu.predict_array({"x": a}))
        err_cpu = max(err_cpu, check_close(
            "elasticity_tf serve vs CPU", torch.from_numpy(out), ref_cpu, MODEL_RTOL, MODEL_ATOL))
    cpu_s = time.perf_counter() - t0
    return {
        "config": cfg.name, "startup_s": startup_s,
        "profile_10_samples": profile_device(
            lambda: predictor.predict_array({"x": X[:ELASTICITY_B]}), "forward"),
        "requests": len(sent), "samples": int(sum(a.shape[0] for a, _ in sent)),
        "device_batches": device_calls, "launches": launched,
        "first_request_ms": first_ms, "warm_median_ms": statistics.median(warm),
        "warm_requests": len(warm), "warm_samples_per_request": ELASTICITY_B,
        "max_abs_err_vs_plain_cuda": err_plain, "max_abs_err_vs_cpu": err_cpu,
        "cpu_requests_compared": 3, "cpu_seconds": cpu_s,
    }


def first_steps(cfg, device, n_steps, ntrain, ntest, epochs):
    """The first ``n_steps`` optimizer steps of ``runner.train(cfg)`` on
    ``device`` (the same setup, weights, shuffle and schedule): per-step
    losses, the weights after them, and the launches."""
    import numpy as np
    import torch

    from position_induced_transformer_torch.train import benchmarks, loop, runner

    problem = benchmarks.setup(cfg, ntrain=ntrain, ntest=ntest, device=device)
    state = runner.init_state(problem, 0)
    dev = torch.device(device)
    data = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in problem.train_data.items()}
    n_batches = ntrain // cfg.batch_size
    schedule = loop.make_lr_schedule(cfg.lr, epochs * n_batches, warmup_steps=cfg.warmup_steps)
    perm = loop.epoch_permutation(0, 0, ntrain, cfg.batch_size)[:n_steps].to(dev)
    zero_counts()
    state, losses = loop.make_train_epoch(problem.task, schedule)(state, problem.geom, data, perm)
    weights = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    return losses.cpu(), weights, counts()


def elasticity_tf_train_phase():
    """runner.train on full-width elasticity_tf on the card (synthetic data,
    80 training and 20 test samples, 2 epochs of 8 steps at batch 10):
    exactly 6/6/6 launches of #11 and #12's dscale and dv per step and 6 of
    #11 per eval batch; losses and weights against a plain-attention card
    run, the first two steps against a CPU run; the time per step; then a
    step on a batch without thresholds (6 of #9 and of each #10 entry)."""
    import numpy as np
    import torch

    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.train import loop

    cfg = configs.ELASTICITY_TF
    epochs, ntrain, ntest = 2, 80, 20
    problem, state, history, losses, weights, launched, seconds = run_training(
        cfg, "cuda", epochs, ntrain, ntest)
    steps = state.step
    eval_batches = epochs * -(-ntest // cfg.batch_size)
    expected = {k: 6 * steps if k in TF_COORD_KERNELS else 0 for k in launched}
    expected["posatt_tf_coord_fwd"] += 6 * eval_batches
    if steps != epochs * (ntrain // cfg.batch_size) or launched != expected:
        fail(f"elasticity_tf train: {steps} steps, {eval_batches} eval batches launched {launched}; "
             f"expected {expected} (6/6/6 per step, 6 forward per eval batch)")
    if not torch.isfinite(losses).all() or not all(
        np.isfinite(v) for row in history for v in row.values()
    ):
        fail(f"elasticity_tf train: non-finite losses or metrics: {history}")
    report = {
        "config": cfg.name, "epochs": epochs, "ntrain": ntrain, "ntest": ntest,
        "steps": steps, "eval_batches": eval_batches, "launches": launched,
        "seconds_whole_run_cuda": seconds, "history": history,
        "step_losses_first_last": [losses[0].item(), losses[-1].item()],
    }
    _, _, _, ref_losses, ref_weights, ref_launched, ref_s = run_training(
        cfg, "cuda", epochs, ntrain, ntest, plain_tf_attention())
    if any(ref_launched.values()):
        fail(f"elasticity_tf train: the plain card run launched kernels: {ref_launched}")
    report["max_abs_err_step_loss_vs_plain_cuda"] = check_close(
        "elasticity_tf train losses vs plain_cuda", losses, ref_losses, LOSS_RTOL, 0.0)
    report["max_abs_err_weights_vs_plain_cuda"] = max(
        check_close(f"elasticity_tf train weight {k} vs plain_cuda", v, ref_weights[k],
                    PARAM_RTOL, PARAM_ATOL) for k, v in weights.items())
    report["seconds_whole_run_plain_cuda"] = ref_s
    # the CPU takes seconds per full-width step: its first two steps against
    # the same two on the card, whose losses are the full run's first two
    n = 2
    card_losses, card_weights, card_launched = first_steps(cfg, "cuda", n, ntrain, ntest, epochs)
    check_close("elasticity_tf first steps vs the full run", card_losses, losses[:n], LOSS_RTOL, 0.0)
    t0 = time.perf_counter()
    cpu_losses, cpu_weights, cpu_launched = first_steps(cfg, "cpu", n, ntrain, ntest, epochs)
    report["seconds_first_steps_cpu"] = time.perf_counter() - t0
    if any(cpu_launched.values()):
        fail(f"elasticity_tf train: the CPU run launched kernels: {cpu_launched}")
    report["cpu_steps_compared"] = n
    report["max_abs_err_step_loss_vs_cpu"] = check_close(
        "elasticity_tf train losses vs cpu", card_losses, cpu_losses, LOSS_RTOL, 0.0)
    report["max_abs_err_weights_vs_cpu"] = max(
        check_close(f"elasticity_tf train weight {k} vs cpu", v, cpu_weights[k], PARAM_RTOL, PARAM_ATOL)
        for k, v in card_weights.items())
    report.update(step_timing(problem, state, cfg.batch_size, ntrain, cfg.lr))

    # a step on a batch without thresholds and bands: the model builds its
    # halved distances and every op takes #9 and #10
    dev = torch.device("cuda")
    bare = {k: torch.from_numpy(problem.train_data[k]).to(dev) for k in ("x", "y")}
    perm = loop.epoch_permutation(0, 7, ntrain, cfg.batch_size)[:1].to(dev)
    train_epoch = loop.make_train_epoch(problem.task, lambda step: cfg.lr)
    zero_counts()
    t0 = time.perf_counter()
    _, bare_loss = train_epoch(state, None, bare, perm)
    torch.cuda.synchronize()
    report["step_without_thresholds_ms"] = (time.perf_counter() - t0) * 1e3
    bare_launched = counts()
    expected = {k: 6 if k in TF_DIST_KERNELS else 0 for k in bare_launched}
    if bare_launched != expected or not torch.isfinite(bare_loss).all():
        fail(f"elasticity_tf train: a step without thresholds launched {bare_launched} "
             f"(expected 6 of each of {TF_DIST_KERNELS}), loss {bare_loss.tolist()}")
    report["launches_step_without_thresholds"] = bare_launched
    return report


# --------------------------------------- fixed-mesh schedules: kernels #5, #6

SCHEDULE_H = 2  # every shape below has two heads, as Burgers, vorticity and Darcy
# the forward's schedules: version -> entry point (#5 v1, #6 v2, #1 v3)
SCHEDULE_VERSIONS = {1: "posatt_fixed_fwd_v1", 2: "posatt_fixed_fwd_v2", 3: "posatt_fixed_fwd"}
SCHEDULE_SHAPES = [
    # name, L_out, L_in, B, D, locality, launches per Burgers forward: the
    # six fixed-mesh shapes of scripts/tpu_checks.py; the two full Darcy
    # 421^2 ZSSR shapes are added from configs.DARCY by schedule_shapes
    ("burgers_processor", 256, 256, 8, 64, 1.0, 5),
    ("burgers_encoder", 256, 1024, 8, 2, 0.02, 1),
    ("burgers_decoder", 1024, 256, 8, 64, 0.02, 1),
    ("vorticity_processor", 256, 256, 20, 256, 1.0, 0),
    ("vorticity_decoder", 4096, 256, 20, 256, 0.02, 0),
    ("darcy_zssr_decoder_slab", 177241 // 4, 256, 4, 64, 0.02, 0),
]
# one forward + backward through PosAttFixed per version at these shapes
SCHEDULE_FUNCTION_SHAPES = ("burgers_decoder", "darcy_zssr_decoder")


def schedule_shapes():
    """SCHEDULE_SHAPES and the Darcy zero-shot super-resolution at 421^2
    (177,241 points) at its eval batch: the encoder from the 421^2 mesh to
    the 16^2 latent (values: the input and the coordinates) and the decoder
    back (values: hid_dim)."""
    from position_induced_transformer_torch import configs

    cfg, side = configs.DARCY, 421
    m = cfg.model
    if m.n_head != SCHEDULE_H:
        fail(f"configs.DARCY has {m.n_head} heads, expected {SCHEDULE_H}")
    lat = cfg.latent_grid[0] * cfg.latent_grid[1]
    B = cfg.eval_batch_size
    return SCHEDULE_SHAPES + [
        ("darcy_zssr_encoder", lat, side * side, B, m.in_dim + m.space_dim, m.en_loc, 0),
        ("darcy_zssr_decoder", side * side, lat, B, m.hid_dim, m.de_loc, 0),
    ]


def schedule_cases(shapes):
    """The inputs of each shape of :func:`schedule_shapes` on the card:
    name -> (dist, thr, lmda, u, locality, scale), from random 2-D points
    as scripts/tpu_checks.py makes them, thresholds by
    ``quantile_threshold``."""
    import numpy as np
    import torch

    from position_induced_transformer_torch.ops import distances, locality, posatt

    dev = torch.device("cuda")
    H = SCHEDULE_H
    cases = {}
    for seed, (name, Lo, Li, B, D, loc, _) in enumerate(shapes):
        rng = np.random.default_rng(seed)
        to = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
        dist = distances.euclidean_sq(to(rng.random((Lo, 2))), to(rng.random((Li, 2))))
        thr = (torch.full((Lo, 1), float("inf"), device=dev) if loc >= 1
               else locality.quantile_threshold(dist, loc))
        lmda = to(rng.standard_normal((H, 1, 1)))
        u = to(rng.random((B, Li, D)))
        cases[name] = (dist, thr, lmda, u, loc, posatt.bandwidth_scale(lmda).reshape(H, 1))
    torch.cuda.synchronize()
    return cases


def fixed_list_lengths(dist, thr, splits):
    """The fixed-mesh forward's kept lists: per block (a 32-row tile and a
    split of L_in, whose keys are the groups of 16 dealt to it in turn), the
    keys that some row of the tile keeps; mean and max over the blocks
    (every head and column tile of a block lists the same keys)."""
    import torch

    Lo, Li = dist.shape
    keep = (dist <= thr) & (dist < float("inf"))
    k = torch.zeros((-(-Lo // 32) * 32, Li), dtype=torch.bool, device=dist.device)
    k[:Lo] = keep
    tile_any = k.reshape(-1, 32, Li).any(dim=1).float()  # (tiles, Li)
    split_of = (torch.arange(Li, device=dist.device) // 16) % splits
    per = torch.zeros((tile_any.shape[0], splits), device=dist.device)
    per.index_add_(1, split_of, tile_any)
    return {"mean": per.mean().item(), "max": int(per.max().item()), "blocks": per.numel()}


def schedule_phase():
    """Phase 16: the schedule variants #5 (v1) and #6 (v2) of the fixed-mesh
    forward beside #1 (v3), through their public entry point
    ``position_attention_fixed(version=...)``, at the eight shapes of
    :func:`schedule_shapes` (random 2-D points as scripts/tpu_checks.py
    makes them, thresholds by ``quantile_threshold`` on the card).

    The counted run: at every shape each version's forward against the
    plain version, and at SCHEDULE_FUNCTION_SHAPES one forward + backward
    per version, which launches that version's forward, #3 and #4 once each
    and #2 never (every version's forward writes M and L on its own plan).
    Its gradients within phase 5's bounds of autograd on the oracle; its
    dU the bits of version 3's where its M and L are, else its M and L
    within the forward's bounds of #2's. Then, outside the counted run,
    each version's M and L against the plain version's, each launcher's
    time (with and without M and L out), the plain version's, SDPA's and
    the bound, each version's splits, warps a block and list length; and
    #2 against its plain version and #1's bits, timed and bounded."""
    import torch

    from position_induced_transformer_torch.kernels import posatt_pallas as kp
    from position_induced_transformer_torch.ops import posatt

    dev = torch.device("cuda")
    H = SCHEDULE_H
    shapes = schedule_shapes()
    cases = schedule_cases(shapes)
    launcher = {v: launchers()[k] for v, k in SCHEDULE_VERSIONS.items()}

    def grads(fn, dist, lmda, u, loc, thr, w):
        lm = lmda.clone().requires_grad_(True)
        x = u.clone().requires_grad_(True)
        out = fn(dist, lm, x, loc, thr=thr)
        (out * w).sum().backward()
        return out.detach(), lm.grad, x.grad

    # ---- the counted run
    zero_counts()
    errs = {}
    for name, *_ in shapes:
        dist, thr, lmda, u, loc, scale = cases[name]
        with torch.no_grad():
            outs = {v: kp.position_attention_fixed(dist, lmda, u, loc, thr=thr, version=v)
                    for v in SCHEDULE_VERSIONS}
            torch.cuda.synchronize()
            want = plain_fixed(dist, thr, scale, u)
        errs[name] = {v: {
            "max_abs_err": check_close(f"schedules {name} v{v}", out, want, OP_RTOL, OP_ATOL),
            "max_abs_diff_vs_v3": (out - outs[3]).abs().max().item(),
        } for v, out in outs.items()}
        del outs, want
    fn_errs, d_u = {}, {}
    for name in SCHEDULE_FUNCTION_SHAPES:
        dist, thr, lmda, u, loc, _ = cases[name]
        gen = torch.Generator(device=dev).manual_seed(7)
        w = torch.randn((u.shape[0], dist.shape[0], H * u.shape[-1]), generator=gen, device=dev)
        got = {}
        for v, kernel in SCHEDULE_VERSIONS.items():
            before = counts()
            got[v] = grads(lambda *a, **k: kp.position_attention_fixed(*a, **k, version=v),
                           dist, lmda, u, loc, thr, w)
            torch.cuda.synchronize()
            diff = {k: n - before[k] for k, n in counts().items()}
            # every version's forward writes M and L: no #2
            expect = {k: int(k in (kernel,) + BWD_KERNELS[1:]) for k in diff}
            if diff != expect:
                fail(f"schedules {name}: one forward + backward of version {v} launched "
                     f"{diff}, expected {expect}")
        oracle = lambda *a, **k: posatt.position_attention(*a, **k)
        want = grads(oracle, dist, lmda, u, loc, thr, w)
        size_u = grads(oracle, dist, lmda, u, loc, thr, w.abs())[2]
        fn_errs[name] = {
            "out": max(check_close(f"schedules {name} v{v} Function out", got[v][0], want[0],
                                   OP_RTOL, OP_ATOL) for v in SCHEDULE_VERSIONS),
            "d_lmda": max(check_close(f"schedules {name} v{v} Function d lmda", got[v][1], want[1],
                                      DS_RTOL, DS_ATOL * want[1].abs().max().item())
                          for v in SCHEDULE_VERSIONS),
            "d_u": max(check_close(f"schedules {name} v{v} Function d u", got[v][2], want[2],
                                   OP_RTOL, OP_ATOL, size_u) for v in SCHEDULE_VERSIONS),
            "d_u_bits_of_v3": {},
        }
        d_u[name] = {v: got[v][2] for v in SCHEDULE_VERSIONS}
        del got, want, size_u, w
    launched = counts()
    n_fwd, n_fn = len(shapes), len(SCHEDULE_FUNCTION_SHAPES)
    expected = {k: 0 for k in launched}
    expected.update({k: n_fwd + n_fn for k in SCHEDULE_VERSIONS.values()})
    expected.update({k: len(SCHEDULE_VERSIONS) * n_fn for k in BWD_KERNELS[1:]})
    if launched != expected:
        fail(f"schedules: the run launched {launched}, expected {expected}")
    # dU reads M and L, not the output: the bits of version 3's where the
    # version's M and L are version 3's, else M and L near #2's
    for name in SCHEDULE_FUNCTION_SHAPES:
        dist, thr, lmda, u, loc, scale = cases[name]
        stats = {v: launcher[v](dist, thr, scale, u, stats=True)[1:] for v in SCHEDULE_VERSIONS}
        M2, L2 = kp.posatt_stats_cuda(dist, thr, scale, u.shape[0], u.shape[-1])
        torch.cuda.synchronize()
        for v in (1, 2):
            same = all(torch.equal(a, b) for a, b in zip(stats[v], stats[3]))
            fn_errs[name]["d_u_bits_of_v3"][v] = same
            if same and not torch.equal(d_u[name][v], d_u[name][3]):
                fail(f"schedules {name}: M and L of version {v} are version 3's, its dU is not")
            check_close(f"schedules {name} v{v} M against #2's", stats[v][0], M2, OP_RTOL, OP_ATOL)
            check_close(f"schedules {name} v{v} L against #2's", stats[v][1], L2, OP_RTOL, OP_ATOL)
        del stats, M2, L2
    del d_u
    log(f"schedules: launches {json.dumps(launched)}; Function max abs err {json.dumps(fn_errs)}")

    # ---- M and L, times and bounds, outside the counted run: each
    # version's forward with and without M and L out, and #2 against its
    # plain version (the bits #1 writes at the shape)
    rows, stats_rows = [], []
    for name, Lo, Li, B, D, loc, per_forward in shapes:
        dist, thr, lmda, u, loc, scale = cases[name]
        args = (dist, thr, scale, u)
        Mp, Lp = kp.posatt_stats_reference(dist, thr, scale)
        versions = {}
        for v in SCHEDULE_VERSIONS:
            _, M, L = launcher[v](*args, stats=True)
            torch.cuda.synchronize()
            plan = kp._fwd_plan(True, H, B, Lo, Li, D, v)
            versions[str(v)] = {
                "ms": cuda_ms(lambda: launcher[v](*args)),
                "ms_with_stats": cuda_ms(lambda: launcher[v](*args, stats=True)),
                **errs[name][v],
                "stats_max_abs_err": max(
                    check_close(f"schedules {name} v{v} M", M, Mp, OP_RTOL, OP_ATOL),
                    check_close(f"schedules {name} v{v} L", L, Lp, OP_RTOL, OP_ATOL)),
                "splits": plan.splits, "warps_a_block": plan.warps,
                "list_length": fixed_list_lengths(dist, thr, plan.splits),
            }
            del M, L
        sdpa, lib_err = fixed_sdpa(*args)
        bound_ms, bound_by, flops, nbytes, kept = bound(dist, thr, H, B, D)
        rows.append({
            "shape": name, "H": H, "L_out": Lo, "L_in": Li, "B": B, "D": D, "locality": loc,
            "kept_entries": kept, "kept_fraction": kept / (Lo * Li),
            "launches_per_burgers_forward": per_forward,
            "versions": versions, "plain_ms": cuda_ms(lambda: plain_fixed(*args)),
            "library_ms": cuda_ms(sdpa), "library_max_abs_err": lib_err,
            "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
        })
        del sdpa
        log(f"schedules {name}: {json.dumps(rows[-1])}")
        M, L = kp.posatt_stats_cuda(dist, thr, scale, B, D)
        _, M1, L1 = kp.posatt_fixed_cuda(*args, stats=True)
        torch.cuda.synchronize()
        if not (torch.equal(M, M1) and torch.equal(L, L1)):
            fail(f"schedules {name}: #2's M and L are not the bits #1 writes")
        s_bound, s_by, s_flops, s_bytes, _ = bound_bwd("posatt_stats", dist, thr, H, B, D)
        stats_rows.append({
            "shape": name, "H": H, "L_out": Lo, "L_in": Li, "B": B, "D": D,
            "kept_entries": kept, "kept_fraction": kept / (Lo * Li),
            "splits": kp._fwd_plan(False, H, B, Lo, Li, D).splits,
            "count_per_burgers_forward": per_forward,
            "max_abs_err": max(check_close(f"schedules {name} #2 M", M, Mp, OP_RTOL, OP_ATOL),
                               check_close(f"schedules {name} #2 L", L, Lp, OP_RTOL, OP_ATOL)),
            "ms": cuda_ms(lambda: kp.posatt_stats_cuda(dist, thr, scale, B, D)),
            "plain_ms": cuda_ms(lambda: kp.posatt_stats_reference(dist, thr, scale)),
            "library_ms": None, "bound_ms": s_bound, "bound_by": s_by,
            "flops": s_flops, "bytes": s_bytes,
        })
        del M, L, M1, L1, Mp, Lp
        log(f"schedules {name} #2: {json.dumps(stats_rows[-1])}")
    return rows, launched, fn_errs, stats_rows


# ---------------------- sod and Darcy: #1, #3 and #4 on fixed-mesh paths
def fixed_train_phase(label, cfg, epochs, ntrain, ntest, per_step, refs=("plain_cuda", "cpu"),
                      fwd="posatt_fixed_fwd", plain_patch=None, per_eval_batch=None,
                      groups=None, timing=True, **train_kw):
    """runner.train on a fixed-mesh configuration on the card, with the
    kernels: exactly ``per_step`` launches of each kernel per step and
    ``per_eval_batch`` (default ``per_step[fwd]``) launches of the forward
    ``fwd`` per eval batch (a dict: launches of each forward); the per-step
    losses and the final weights
    against the same training with the plain attention on the card
    (``plain_patch()``, default #1's plain version) and on the CPU
    (``refs`` names the reference runs); then the time per step, steps/s
    and the device's busy share of warm steps (``groups`` as
    profile_device takes them, default #1-#4's) unless ``timing`` is
    False."""
    import numpy as np
    import torch

    from position_induced_transformer_torch.models import pit
    from position_induced_transformer_torch.ops.posatt import position_attention

    plain = lambda dist, lmda, inputs, locality, thr=None: position_attention(
        dist, lmda, inputs, locality, thr=thr)
    problem, state, history, losses, weights, launched, seconds = run_training(
        cfg, "cuda", epochs, ntrain, ntest, **train_kw)
    steps = state.step
    eval_batches = epochs * -(-ntest // (cfg.eval_batch_size or cfg.batch_size))
    expected = {k: per_step.get(k, 0) * steps for k in launchers()}
    if not isinstance(per_eval_batch, dict):
        per_eval_batch = {fwd: per_step[fwd] if per_eval_batch is None else per_eval_batch}
    for k, n in per_eval_batch.items():
        expected[k] += n * eval_batches
    if steps != epochs * (ntrain // cfg.batch_size) or launched != expected:
        fail(f"{label}: {steps} steps, {eval_batches} eval batches launched {launched}; "
             f"expected {expected} ({per_step} per step, the forward's count per eval batch)")
    if not torch.isfinite(losses).all() or not all(
        np.isfinite(v) for row in history for v in row.values()
    ):
        fail(f"{label}: non-finite losses or metrics: {history}")
    report = {
        "config": cfg.name, "epochs": epochs, "ntrain": ntrain, "ntest": ntest,
        "steps": steps, "eval_batches": eval_batches, "launches": launched,
        "launches_per_step": per_step,
        "seconds_whole_run_cuda": seconds, "history": history,
        "step_losses_first_last": [losses[0].item(), losses[-1].item()],
    }
    patch = (plain_patch() if plain_patch is not None
             else mock.patch.object(pit, "position_attention_fixed", plain))
    for device, p, label_ref in (("cuda", patch, "plain_cuda"), ("cpu", None, "cpu")):
        if label_ref not in refs:
            continue
        _, _, _, ref_losses, ref_weights, ref_launched, ref_s = run_training(
            cfg, device, epochs, ntrain, ntest, p,
            **{k: v for k, v in train_kw.items() if k != "checkpoint_path"})
        if any(ref_launched.values()):
            fail(f"{label}: the {label_ref} run launched kernels: {ref_launched}")
        report[f"max_abs_err_step_loss_vs_{label_ref}"] = check_close(
            f"{label} losses vs {label_ref}", losses, ref_losses, LOSS_RTOL, 0.0)
        report[f"max_abs_err_weights_vs_{label_ref}"] = max(
            check_close(f"{label} weight {k} vs {label_ref}", v, ref_weights[k],
                        PARAM_RTOL, PARAM_ATOL)
            for k, v in weights.items())
        report[f"seconds_whole_run_{label_ref}"] = ref_s
    if timing:
        report.update(step_timing(problem, state, cfg.batch_size, ntrain, cfg.lr,
                                  groups or FIXED_GROUPS))
    return report


def model_atol(steps, ref):
    """The model-level absolute bound: MODEL_ATOL, or for a rollout of
    ``steps`` steps, each step's output fed back, MODEL_ATOL per unit of
    the reference's largest entry (as tests/test_torch_vorticity.py holds a
    rollout)."""
    return MODEL_ATOL * (float(ref.abs().max()) if steps else 1.0)


def fixed_serve_phase(label, cfg, ckpt, x, per_batch, sizes, n_concurrent, n_warm,
                      cpu_samples=None, setup_kwargs=None, rollout_steps=None,
                      fwd="posatt_fixed_fwd", plain_patch=None, groups=None, model_variant=None,
                      bitwise=False):
    """``make_server(cfg.name)`` on the card answering raw ``.npy``
    batches of ``x``: one request of each of ``sizes`` samples, then
    ``n_concurrent`` concurrent requests (as in phase 6), then ``n_warm``
    warm requests of one device batch; every reply 200; exactly
    ``per_batch`` launches of #1 per device batch and no other kernel;
    every reply against ``infer`` on the card and a plain-attention card
    run, and the first ``cpu_samples`` samples (default: all) against a
    CPU run. A rollout benchmark answers at its configured horizon, or at
    ``?rollout_steps=`` ``rollout_steps`` where it is given (a one-step
    model whose output is its next input rolls out too), and the
    comparisons roll out as far. ``fwd``: the forward kernel the model
    launches; ``plain_patch()``: the context that puts its attention on the
    plain version (default #1's); ``groups`` as profile_device takes them.
    ``per_batch`` may be a dict: launches of each forward. ``model_variant``
    goes to ``make_server``, ``infer`` and the CPU ``Predictor``; with
    ``bitwise`` every reply must equal ``infer``'s to the bit."""
    import numpy as np
    import torch

    from position_induced_transformer_torch.models import pit
    from position_induced_transformer_torch.ops.posatt import position_attention
    from position_induced_transformer_torch.train import evaluate
    from position_induced_transformer_torch.train.serve import make_server

    plain = lambda dist, lmda, inputs, locality, thr=None: position_attention(
        dist, lmda, inputs, locality, thr=thr)
    plain_patch = plain_patch or (lambda: mock.patch.object(pit, "position_attention_fixed", plain))
    t0 = time.perf_counter()
    server = make_server(cfg.name, ckpt, host="127.0.0.1", port=0, verbose=False,
                         setup_kwargs=setup_kwargs, device="cuda", model_variant=model_variant)
    startup_s = time.perf_counter() - t0
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/predict"
    if rollout_steps is not None:
        url += f"?rollout_steps={rollout_steps}"
    steps = cfg.rollout_steps if rollout_steps is None else rollout_steps
    bs = server.predictor._batch_size()
    sent = []  # (first sample, input, reply)

    def request(i, j):
        return post(url, npy(x[i:j]))

    def accept(i, j, code, body):
        if code != 200:
            fail(f"{label}: HTTP {code} for samples [{i}, {j}): {body[:500]!r}")
        sent.append((i, x[i:j], np.load(io.BytesIO(body))))

    def ask(i, j):
        accept(i, j, *request(i, j))

    try:
        zero_counts()
        calls0 = server.batcher.n_calls
        i, first_ms = 0, None
        for n in sizes:
            t0 = time.perf_counter()
            ask(i, i + n)
            first_ms = first_ms or (time.perf_counter() - t0) * 1e3
            i += n
        per = max(1, min(3, (x.shape[0] - i) // n_concurrent))
        ranges = [(i + per * k, i + per * (k + 1)) for k in range(n_concurrent)]
        for (a, b), body in zip(ranges, concurrent(label, request, ranges)):
            accept(a, b, 200, body)
        warm, span = [], x.shape[0] - x.shape[0] % bs
        for k in range(n_warm):
            a = (bs * k) % span
            t0 = time.perf_counter()
            ask(a, a + bs)
            warm.append((time.perf_counter() - t0) * 1e3)
        launched = counts()
        device_calls = server.batcher.n_calls - calls0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    per_batch = per_batch if isinstance(per_batch, dict) else {fwd: per_batch}
    expected = {k: per_batch.get(k, 0) * device_calls for k in launched}
    if launched != expected:
        fail(f"{label}: {launched} for {device_calls} device batches "
             f"(expected {per_batch} forward launches per batch and nothing else)")

    predictor = server.predictor
    n_all = max(i + len(r) for i, r, _ in sent)
    path = str(REPO / "build" / "chip_smoke" / f"{label}_inputs.npy")
    np.save(path, x[:n_all])
    zero_counts()
    t0 = time.perf_counter()
    evaluate.infer(cfg.name, ckpt, path, output_path=path.replace("inputs", "infer"),
                   setup_kwargs=setup_kwargs, rollout_steps=steps, device="cuda",
                   model_variant=model_variant)
    infer_s = time.perf_counter() - t0
    by_infer = np.load(path.replace("inputs", "infer"))
    if not all(counts()[k] for k in per_batch):
        fail(f"{label}: infer on the card launched {counts()}, not each of {sorted(per_batch)}")
    cpu_n = n_all if cpu_samples is None else cpu_samples
    cpu = evaluate.Predictor(cfg.name, ckpt, setup_kwargs=setup_kwargs, device="cpu",
                             model_variant=model_variant)
    by_cpu = cpu.predict_array(
        {"x": evaluate._prepare_inputs(cpu.problem, x[:cpu_n])}, steps, batch_size=min(cpu_n, bs))
    errs = {"infer": 0.0, "plain_cuda": 0.0, "cpu": 0.0}
    for i, a, out in sent:
        got = torch.from_numpy(out)
        if bitwise and not np.array_equal(out, by_infer[i:i + len(a)]):
            fail(f"{label}: the reply for samples [{i}, {i + len(a)}) differs from infer's bits")
        errs["infer"] = max(errs["infer"], check_close(
            f"{label} vs infer", got, torch.from_numpy(by_infer[i:i + len(a)]), MODEL_RTOL, MODEL_ATOL))
        before = counts()
        with plain_patch():
            ref = predictor.predict_array({"x": evaluate._prepare_inputs(predictor.problem, a)}, steps)
        if counts() != before:
            fail(f"{label}: the plain comparison run launched a kernel")
        ref = torch.from_numpy(ref)
        errs["plain_cuda"] = max(errs["plain_cuda"], check_close(
            f"{label} vs plain on CUDA", got, ref, MODEL_RTOL, model_atol(steps, ref)))
        k = max(0, min(len(a), cpu_n - i))
        if k:
            ref = torch.from_numpy(by_cpu[i:i + k])
            errs["cpu"] = max(errs["cpu"], check_close(
                f"{label} vs CPU", got[:k], ref, MODEL_RTOL, model_atol(steps, ref)))
    batch = {"x": evaluate._prepare_inputs(predictor.problem, x[:bs])}
    return {
        "config": cfg.name, "setup_kwargs": setup_kwargs, "rollout_steps": steps,
        "startup_s": startup_s,
        "infer_s": infer_s, "reply_shape": list(sent[0][2].shape[1:]),
        f"profile_{bs}_samples": profile_device(lambda: predictor.predict_array(batch, steps),
                                                "forward", groups=groups or FIXED_GROUPS),
        "requests": len(sent), "samples": int(sum(len(a) for _, a, _ in sent)),
        "device_batches": device_calls, "launches": launched,
        "first_request_ms": first_ms, "warm_median_ms": statistics.median(warm),
        "warm_requests": len(warm), "warm_samples_per_request": bs,
        "samples_vs_cpu": cpu_n, "model_variant": model_variant or cfg.model_variant,
        "replies_equal_infer_bitwise": bool(bitwise),
        **{f"max_abs_err_vs_{k}": v for k, v in errs.items()},
    }


# a step launches one forward a layer, dscale a layer and du for every layer
# but the encoder, whose input needs no gradient
def per_step_launches(n_blocks):
    n = n_blocks + 2
    return {"posatt_fixed_fwd": n, "posatt_stats": 0, "posatt_bwd_dscale": n, "posatt_bwd_du": n - 1}


def darcy_train_phase():
    """runner.train on full-width Darcy at 43^2 (64 training and 16 test
    samples, 2 epochs of 8 steps at batch 8; cut from 1024 / 100 and 30
    epochs): 6/0/6/5 launches a step; it writes the checkpoint the ZSSR
    and serve phases read (with the normalizer statistics)."""
    from position_induced_transformer_torch import configs

    from position_induced_transformer_torch.train import benchmarks

    cfg = configs.DARCY
    ckpt = str(REPO / "build" / "chip_smoke" / "darcy_trained.pt")
    report = fixed_train_phase("darcy train", cfg, 2, 64, 16, per_step_launches(cfg.model.n_blocks),
                               checkpoint_path=ckpt)
    report["geometry_43"] = kept_difference(benchmarks.darcy_geometry(cfg, 43, device="cuda"),
                                            benchmarks.darcy_geometry(cfg, 43, device="cpu"))
    return report, ckpt


def fixed_op_rows(label, geom, lmdas, B, dims, random_rows, ops=("encoder", "decoder")):
    """#1 at the ``ops`` of ``geom`` (encoder ``dist_down``, processor
    ``dist_proc`` with every entry kept, decoder ``dist_up``; the model's
    own bandwidths ``lmdas``, random values of widths ``dims`` at batch B):
    against the plain version, per-launch time, the plain version's and
    SDPA's, the bound from this geometry's kept entries, the splits of L_in
    and the kept lists; beside ``random_rows``: phase 16's times at the
    same shapes on random points."""
    import numpy as np
    import torch

    from position_induced_transformer_torch.kernels import posatt_pallas as kp
    from position_induced_transformer_torch.ops import posatt

    rows = []
    rng = np.random.default_rng(5)
    every = lambda d: torch.full((d.shape[0], 1), float("inf"), device=d.device)
    by_op = {"encoder": (geom.dist_down, geom.thr_down),
             "processor": (geom.dist_proc, every(geom.dist_proc)),
             "decoder": (geom.dist_up, geom.thr_up)}
    for op, lmda, D in zip(ops, lmdas, dims):
        dist, thr = by_op[op]
        Lo, Li = dist.shape
        H = lmda.shape[0]
        scale = posatt.bandwidth_scale(lmda.cuda()).reshape(H, 1)
        u = torch.from_numpy(rng.random((B, Li, D)).astype(np.float32)).cuda()
        args = (dist, thr, scale, u)
        err = check_close(f"{label} {op} #1 vs plain", kp.posatt_fixed_cuda(*args),
                          plain_fixed(*args), OP_RTOL, OP_ATOL)
        plan = kp._fwd_plan(True, H, B, Lo, Li, D)
        sdpa, lib_err = fixed_sdpa(*args)
        bound_ms, bound_by, flops, nbytes, kept = bound(dist, thr, H, B, D)
        rows.append({
            "shape": f"{label}_{op}", "H": H, "L_out": Lo, "L_in": Li, "B": B, "D": D,
            "kept_entries": kept, "kept_fraction": kept / (Lo * Li), "max_abs_err": err,
            "ms": cuda_ms(lambda: kp.posatt_fixed_cuda(*args)),
            "ms_with_stats": cuda_ms(lambda: kp.posatt_fixed_cuda(*args, stats=True)),
            "plain_ms": cuda_ms(lambda: plain_fixed(*args)),
            "library_ms": cuda_ms(sdpa), "library_max_abs_err": lib_err,
            "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
            "splits": plan.splits, "warps_a_block": plan.warps,
            "list_length": fixed_list_lengths(dist, thr, plan.splits),
            **({"random_points_phase16": random_rows[op]} if op in random_rows else {}),
        })
        del sdpa, u
        log(f"{label} {op}: {json.dumps(rows[-1])}")
    return rows


def kept_difference(gg, gc):
    """Entries kept on the card and not on the CPU or the other way, by
    side (the same ops; ties at the cut would show here)."""
    out = {}
    for side in ("down", "up"):
        kg = (getattr(gg, f"dist_{side}") <= getattr(gg, f"thr_{side}")).cpu()
        kc = getattr(gc, f"dist_{side}") <= getattr(gc, f"thr_{side}")
        out[f"entries_kept_differently_{side}"] = int((kg != kc).sum())
        out[f"kept_per_row_{side}_min_max"] = [int(kg.sum(1).min()), int(kg.sum(1).max())]
    return out


def darcy_zssr_phase(ckpt, schedule_rows):
    """``evaluate("darcy", ckpt, zssr=True)`` on the card at 421^2 (ntest
    10: one eval batch), with the train phase's weights and statistics:
    6 launches of #1 and no other kernel; its metrics against a
    plain-attention card run at rtol 1e-4, its predictions on 2 samples
    against a CPU run; the geometry's build time and its kept sets against
    a CPU build; #1 per launch at the 421^2 encoder and decoder of this
    grid-ordered mesh beside phase 16's random-point times and the bound."""
    import numpy as np
    import torch
    from scipy.io import loadmat

    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.data import loaders
    from position_induced_transformer_torch.models import pit
    from position_induced_transformer_torch.ops.posatt import position_attention
    from position_induced_transformer_torch.train import benchmarks, checkpoint, evaluate

    cfg, ntest = configs.DARCY, 10
    out_dir = REPO / "build" / "chip_smoke"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    geom = benchmarks.darcy_geometry(cfg, 421, device="cuda")
    torch.cuda.synchronize()
    geometry_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    geom_cpu = benchmarks.darcy_geometry(cfg, 421, device="cpu")
    report = {"geometry_build_s_cuda": geometry_s,
              "geometry_build_s_cpu": time.perf_counter() - t0,
              **kept_difference(geom, geom_cpu)}
    del geom_cpu
    log(f"darcy zssr geometry: {json.dumps(report)}")

    kw = dict(zssr=True, ntest=ntest)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = evaluate.evaluate("darcy", ckpt, save_pred=str(out_dir / "zssr_cuda.mat"), device="cuda", **kw)
    torch.cuda.synchronize()
    report["evaluate_s_cuda"] = time.perf_counter() - t0
    launched = counts()
    expected = {k: 6 if k == "posatt_fixed_fwd" else 0 for k in launched}
    if launched != expected:
        fail(f"darcy zssr: evaluate launched {launched}, expected {expected}")
    report["launches"] = launched
    plain = lambda dist, lmda, inputs, locality, thr=None: position_attention(
        dist, lmda, inputs, locality, thr=thr)
    with mock.patch.object(pit, "position_attention_fixed", plain):
        t0 = time.perf_counter()
        want = evaluate.evaluate("darcy", ckpt, save_pred=str(out_dir / "zssr_plain.mat"),
                                 device="cuda", **kw)
        report["evaluate_s_plain_cuda"] = time.perf_counter() - t0
    if counts() != launched:
        fail("darcy zssr: the plain-attention evaluation launched a kernel")
    for k in ("rel_l1", "rel_l2", "rel_max", "rel_l1_quartiles"):
        check_close(f"darcy zssr {k} vs plain on CUDA", torch.tensor(got[k], dtype=torch.float64),
                    torch.tensor(want[k], dtype=torch.float64), 1e-4, 0.0)
    pred = torch.from_numpy(loadmat(str(out_dir / "zssr_cuda.mat"))["pred"])
    pred_plain = torch.from_numpy(loadmat(str(out_dir / "zssr_plain.mat"))["pred"])
    if pred.shape != (ntest, 421, 421, 1):
        fail(f"darcy zssr: predictions of shape {tuple(pred.shape)}")
    report["max_abs_err_pred_vs_plain_cuda"] = check_close(
        "darcy zssr predictions vs plain on CUDA", pred, pred_plain, MODEL_RTOL, MODEL_ATOL)
    # the raw inputs evaluate read: its test split (ntrain = ntest under
    # the checkpoint's statistics)
    x_raw = loaders.darcy(None, None, 1, ntrain=ntest, ntest=ntest)[2][:2]
    t0 = time.perf_counter()
    cpu = evaluate.Predictor("darcy", ckpt, setup_kwargs={"downsampling": 1}, device="cpu")
    ref = cpu.predict_array({"x": evaluate._prepare_inputs(cpu.problem, x_raw)}, batch_size=2)
    report["cpu_predict_2_samples_s"] = time.perf_counter() - t0
    report["max_abs_err_pred_vs_cpu_2_samples"] = check_close(
        "darcy zssr predictions vs CPU", pred[:2], torch.from_numpy(ref), MODEL_RTOL, MODEL_ATOL)
    del cpu, ref
    report["metrics"] = got
    report["metrics_plain_cuda"] = want

    sd = checkpoint.restore(ckpt)["state_dict"]
    m = cfg.model
    random_rows = {}
    for r in schedule_rows:
        for op in ("encoder", "decoder"):
            if r["shape"] == f"darcy_zssr_{op}":
                random_rows[op] = {"ms": r["versions"]["3"]["ms"], "bound_ms": r["bound_ms"],
                                   "kept_fraction": r["kept_fraction"],
                                   "list_length": r["versions"]["3"]["list_length"]}
    report["ops"] = fixed_op_rows("darcy_zssr", geom, (sd["down.lmda"], sd["up.lmda"]),
                                  cfg.eval_batch_size, (m.in_dim + m.space_dim, m.hid_dim),
                                  random_rows)
    return report


def darcy_serve_phases(ckpt):
    """make_server("darcy") on the train phase's checkpoint answering raw
    43^2 grids (1, 10 and 13 samples, 4 concurrent, 20 warm), then a
    second server built with ``setup_kwargs={"downsampling": 1}``
    answering raw 421^2 grids (1 and 3 samples, 2 concurrent, 4 warm;
    against the CPU on 2 samples): 6 launches of #1 per device batch."""
    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.data import synthetic

    cfg = configs.DARCY
    per_batch = cfg.model.n_blocks + 2
    x43 = synthetic.darcy(n=50, s=43, seed=1)[0]
    at43 = fixed_serve_phase("darcy_serve_43", cfg, ckpt, x43, per_batch, (1, 10, 13), 4, 20)
    x421 = synthetic.darcy(n=10, s=421, seed=1)[0]
    at421 = fixed_serve_phase("darcy_serve_421", cfg, ckpt, x421, per_batch, (1, 3), 2, 4,
                              cpu_samples=2, setup_kwargs={"downsampling": 1})
    return at43, at421


def sod_phases():
    """sod at full width: a seeded random-weight checkpoint served (1, 8
    and 13 samples, 4 concurrent, 20 warm; 4 launches of #1 per device
    batch), then runner.train (64 training and 16 test samples, 2 epochs
    of 8 steps at batch 8; cut from 1024 / 128 and 500 epochs): 4/0/4/3
    launches a step."""
    import torch

    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.data import synthetic
    from position_induced_transformer_torch.train import benchmarks, checkpoint

    cfg = configs.SOD
    model = benchmarks._make_model(cfg, torch.Generator().manual_seed(0))
    ckpt = checkpoint.save(str(REPO / "build" / "chip_smoke" / "sod.pt"), model.state_dict(), cfg.name)
    x = synthetic.sod(n=48, seed=1)[0]
    serve = fixed_serve_phase("sod_serve", cfg, ckpt, x, cfg.model.n_blocks + 2, (1, 8, 13), 4, 20)
    train = fixed_train_phase("sod train", cfg, 2, 64, 16, per_step_launches(cfg.model.n_blocks))
    return serve, train


# ----------------------------------------- NACA: kernels #7 and #8 on C-grids

# the batched kernels' names in a trace (one library each; the fixed-mesh
# kernels share the names but run on no NACA path)
BATCHED_GROUPS = {
    "posatt_batched_fwd": "void (anonymous namespace)::fwd_kernel<",
    "posatt_batched_bwd_dscale": "void (anonymous namespace)::bwd_kernel<false",
    "posatt_batched_bwd_du": "void (anonymous namespace)::bwd_kernel<true",
}


def naca_train_phase():
    """runner.train on full-width NACA on the card (synthetic airfoils on
    221 x 51 C-grids; 80 training and 20 test samples, 2 epochs of 4 steps
    at batch 20, cut from 1000 / 200 and 500 epochs): exactly 6/6/5
    launches of #7 and #8's dscale and du per step (the encoder's input
    needs no gradient) and 6 of #7 per eval batch; losses and weights
    against a plain-attention card run, the first two steps against a CPU
    run; the time per step, steps/s and the device's busy time. It writes
    the checkpoint the serve phase reads."""
    import numpy as np
    import torch

    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.models import pit

    cfg = configs.NACA
    epochs, ntrain, ntest = 2, 80, 20
    ckpt = str(REPO / "build" / "chip_smoke" / "naca_trained.pt")
    problem, state, history, losses, weights, launched, seconds = run_training(
        cfg, "cuda", epochs, ntrain, ntest, checkpoint_path=ckpt)
    steps = state.step
    eval_batches = epochs * -(-ntest // cfg.batch_size)
    per_step = {"posatt_batched_fwd": 6, "posatt_batched_bwd_dscale": 6, "posatt_batched_bwd_du": 5}
    expected = {k: per_step.get(k, 0) * steps for k in launched}
    expected["posatt_batched_fwd"] += 6 * eval_batches
    if steps != epochs * (ntrain // cfg.batch_size) or launched != expected:
        fail(f"naca train: {steps} steps, {eval_batches} eval batches launched {launched}; "
             f"expected {expected} (6/6/5 per step, 6 forward per eval batch)")
    if not torch.isfinite(losses).all() or not all(
        np.isfinite(v) for row in history for v in row.values()
    ):
        fail(f"naca train: non-finite losses or metrics: {history}")
    report = {
        "config": cfg.name, "epochs": epochs, "ntrain": ntrain, "ntest": ntest,
        "steps": steps, "eval_batches": eval_batches, "launches": launched,
        "launches_per_step": per_step, "seconds_whole_run_cuda": seconds, "history": history,
        "step_losses_first_last": [losses[0].item(), losses[-1].item()],
        "band_width": problem.task.geom_fn(
            {k: torch.from_numpy(np.asarray(v[:1])).cuda()
             for k, v in problem.train_data.items()}).band_up.width,
    }
    patch = mock.patch.object(pit, "position_attention_batched", plain_batched)
    _, _, _, ref_losses, ref_weights, ref_launched, ref_s = run_training(
        cfg, "cuda", epochs, ntrain, ntest, patch)
    if any(ref_launched.values()):
        fail(f"naca train: the plain card run launched kernels: {ref_launched}")
    report["max_abs_err_step_loss_vs_plain_cuda"] = check_close(
        "naca train losses vs plain_cuda", losses, ref_losses, LOSS_RTOL, 0.0)
    report["max_abs_err_weights_vs_plain_cuda"] = max(
        check_close(f"naca train weight {k} vs plain_cuda", v, ref_weights[k], PARAM_RTOL, PARAM_ATOL)
        for k, v in weights.items())
    report["seconds_whole_run_plain_cuda"] = ref_s
    # a full-width step takes seconds on the CPU: the first two steps
    n = 2
    card_losses, card_weights, _ = first_steps(cfg, "cuda", n, ntrain, ntest, epochs)
    check_close("naca first steps vs the full run", card_losses, losses[:n], LOSS_RTOL, 0.0)
    t0 = time.perf_counter()
    cpu_losses, cpu_weights, cpu_launched = first_steps(cfg, "cpu", n, ntrain, ntest, epochs)
    report["seconds_first_steps_cpu"] = time.perf_counter() - t0
    if any(cpu_launched.values()):
        fail(f"naca train: the CPU run launched kernels: {cpu_launched}")
    report["cpu_steps_compared"] = n
    report["max_abs_err_step_loss_vs_cpu"] = check_close(
        "naca train losses vs cpu", card_losses, cpu_losses, LOSS_RTOL, 0.0)
    report["max_abs_err_weights_vs_cpu"] = max(
        check_close(f"naca train weight {k} vs cpu", v, cpu_weights[k], PARAM_RTOL, PARAM_ATOL)
        for k, v in card_weights.items())
    report.update(step_timing(problem, state, cfg.batch_size, ntrain, cfg.lr, BATCHED_GROUPS))
    return report, ckpt


def naca_request(cfg, coords, X, i, j):
    """A NACA request's variables for samples [i, j): the shape points as
    ``x`` and ``mesh_in``, the latent slice of each C-grid and the C-grid."""
    xr, yr = cfg.latent_grid
    ltt = X[i:j, ::4, ::4][:, :xr, :yr].reshape(j - i, -1, 2)
    return {"x": coords[i:j], "mesh_in": coords[i:j], "mesh_ltt": ltt,
            "mesh_out": X[i:j].reshape(j - i, -1, 2)}


def naca_serve_phase(ckpt):
    """make_server("naca") on the train phase's checkpoint: ``.mat`` bodies
    holding ``x``, ``mesh_in``, ``mesh_ltt`` and ``mesh_out`` (1, 10 and 13
    samples, 4 concurrent, 20 warm of 20), thresholds computed per
    request: exactly 6 launches of #7 per device batch and nothing else;
    every reply against ``infer`` and a plain-attention card run, the first
    11 samples against a CPU run; a bare ``.npy`` gets 400. Then
    ``evaluate("naca", ckpt, shuffle_ablation=True)`` (20 test samples)
    against a plain-attention card run at rtol 1e-4, launching 6 of #7 per
    eval batch, with true and with shuffled inputs."""
    import dataclasses

    import numpy as np
    import torch

    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.data import synthetic
    from position_induced_transformer_torch.models import pit
    from position_induced_transformer_torch.train import evaluate
    from position_induced_transformer_torch.train.serve import make_server

    cfg = configs.NACA
    t0 = time.perf_counter()
    server = make_server(cfg.name, ckpt, host="127.0.0.1", port=0, verbose=False, device="cuda")
    startup_s = time.perf_counter() - t0
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/predict"
    coords, X, _ = synthetic.naca(n=60, nx=cfg.grid[0], ny=cfg.grid[1], seed=1)
    bs = server.predictor._batch_size()
    sent = []  # (i, j, reply)

    def request(i, j):
        return post(url, mat_bytes(**naca_request(cfg, coords, X, i, j)))

    def accept(i, j, code, body):
        if code != 200:
            fail(f"naca serve: HTTP {code} for samples [{i}, {j}): {body[:500]!r}")
        sent.append((i, j, np.load(io.BytesIO(body))))

    def ask(i, j):
        accept(i, j, *request(i, j))

    try:
        zero_counts()
        calls0 = server.batcher.n_calls
        t0 = time.perf_counter()
        ask(0, 1)
        first_ms = (time.perf_counter() - t0) * 1e3
        ask(1, 11)
        ask(11, 24)  # 13 samples
        ranges = [(24 + 3 * k, 27 + 3 * k) for k in range(4)]
        for (i, j), body in zip(ranges, concurrent("naca serve", request, ranges)):
            accept(i, j, 200, body)
        warm = []
        for k in range(20):
            a = bs * (k % 3)
            t0 = time.perf_counter()
            ask(a, a + bs)
            warm.append((time.perf_counter() - t0) * 1e3)
        launched = counts()
        device_calls = server.batcher.n_calls - calls0
        code, body = post(url, npy(coords[:2]))
        if code != 400 or b"mesh_in" not in body:
            fail(f"naca serve: a bare .npy got HTTP {code}: {body[:300]!r}")
        if counts() != launched:
            fail("naca serve: the refused request launched kernels")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    expected = {k: 6 * device_calls if k == "posatt_batched_fwd" else 0 for k in launched}
    if launched != expected:
        fail(f"naca serve: {launched} for {device_calls} device batches "
             "(expected 6 launches of #7 per batch and nothing else)")

    predictor = server.predictor
    n_all = max(j for _, j, _ in sent)
    path = str(REPO / "build" / "chip_smoke" / "naca_inputs.mat")
    from scipy.io import savemat

    savemat(path, naca_request(cfg, coords, X, 0, n_all))
    t0 = time.perf_counter()
    evaluate.infer(cfg.name, ckpt, path, output_path=path.replace("inputs.mat", "infer.npy"),
                   device="cuda")
    infer_s = time.perf_counter() - t0
    by_infer = np.load(path.replace("inputs.mat", "infer.npy"))
    cpu_n = 11
    cpu = evaluate.Predictor(cfg.name, ckpt, device="cpu")
    t0 = time.perf_counter()
    by_cpu = cpu.predict_array(naca_request(cfg, coords, X, 0, cpu_n), batch_size=cpu_n)
    cpu_s = time.perf_counter() - t0
    errs = {"infer": 0.0, "plain_cuda": 0.0, "cpu": 0.0}
    for i, j, out in sent:
        got = torch.from_numpy(out)
        if got.shape != (j - i, X.shape[1] * X.shape[2], cfg.model.out_dim):
            fail(f"naca serve: reply shape {tuple(got.shape)}")
        errs["infer"] = max(errs["infer"], check_close(
            "naca serve vs infer", got, torch.from_numpy(by_infer[i:j]), MODEL_RTOL, MODEL_ATOL))
        before = counts()
        with mock.patch.object(pit, "position_attention_batched", plain_batched):
            ref = predictor.predict_array(naca_request(cfg, coords, X, i, j))
        if counts() != before:
            fail("naca serve: the plain comparison run launched a kernel")
        errs["plain_cuda"] = max(errs["plain_cuda"], check_close(
            "naca serve vs plain on CUDA", got, torch.from_numpy(ref), MODEL_RTOL, MODEL_ATOL))
        k = max(0, min(j, cpu_n) - i)
        if k:
            errs["cpu"] = max(errs["cpu"], check_close(
                "naca serve vs CPU", got[:k], torch.from_numpy(by_cpu[i:i + k]), MODEL_RTOL,
                MODEL_ATOL))
    batch = naca_request(cfg, coords, X, 0, bs)
    report = {
        "config": cfg.name, "startup_s": startup_s, "infer_s": infer_s,
        "cpu_predict_s": cpu_s, "samples_vs_cpu": cpu_n,
        f"profile_{bs}_samples": profile_device(lambda: predictor.predict_array(batch), "forward",
                                                groups=BATCHED_GROUPS),
        "requests": len(sent), "samples": int(sum(j - i for i, j, _ in sent)),
        "device_batches": device_calls, "launches": launched,
        "first_request_ms": first_ms, "warm_median_ms": statistics.median(warm),
        "warm_requests": len(warm), "warm_samples_per_request": bs,
        **{f"max_abs_err_vs_{k}": v for k, v in errs.items()},
    }

    # the shuffle ablation on the trained split's size (not the full 1000)
    ev_cfg = dataclasses.replace(cfg, ntrain=80)
    ntest = 20
    zero_counts()
    t0 = time.perf_counter()
    got = evaluate.evaluate(ev_cfg, ckpt, ntest=ntest, shuffle_ablation=True, device="cuda")
    torch.cuda.synchronize()
    report["shuffle_ablation_evaluate_s"] = time.perf_counter() - t0
    ablation_launched = counts()
    n_eval = 2 * -(-ntest // cfg.batch_size)  # the true and the shuffled pairing
    expected = {k: 6 * n_eval if k == "posatt_batched_fwd" else 0 for k in ablation_launched}
    if ablation_launched != expected:
        fail(f"naca shuffle ablation: evaluate launched {ablation_launched}, expected {expected}")
    with mock.patch.object(pit, "position_attention_batched", plain_batched):
        want = evaluate.evaluate(ev_cfg, ckpt, ntest=ntest, shuffle_ablation=True, device="cuda")
    if counts() != ablation_launched:
        fail("naca shuffle ablation: the plain-attention evaluation launched a kernel")
    f64 = lambda v: torch.tensor(v, dtype=torch.float64)
    for k in ("rel_l1", "rel_l2", "rel_max", "rel_l1_quartiles"):
        check_close(f"naca evaluate {k} vs plain on CUDA", f64(got[k]), f64(want[k]), 1e-4, 0.0)
    for k, v in got["shuffle_ablation"].items():  # rounded to 6 decimals
        check_close(f"naca shuffle ablation {k} vs plain on CUDA", f64(v),
                    f64(want["shuffle_ablation"][k]), 1e-4, 2e-6)
    report["shuffle_ablation"] = {"launches": ablation_launched, "metrics": got,
                                  "metrics_plain_cuda": want}
    return report


# ----------------------- vorticity: kernels #1, #3 and #4 under 20-step BPTT

REMAT_MODES = ("full", "dots", "none")


def vorticity_launches(cfg, mode):
    """What one vorticity training step launches: a forward of every
    attention op in each of the rollout's steps, and as many again when
    the checkpointed forward is recomputed in the backward (``full``; and
    ``dots``, which keeps only matmul outputs: a ctypes launch is none);
    dscale for every op; du for every op but the first step's encoder,
    whose window is data (every later window holds predicted frames)."""
    ops = (cfg.model.n_blocks + 2) * cfg.rollout_steps
    return {"posatt_fixed_fwd": ops * (1 if mode == "none" else 2), "posatt_stats": 0,
            "posatt_bwd_dscale": ops, "posatt_bwd_du": ops - 1}


def remat_mode_phase(problem, batch):
    """One training step's loss and backward under each remat mode on the
    same batch and weights: the launches, the gradients (held against
    ``none``'s), the wall and device busy time, and the peak of
    ``torch.cuda.max_memory_allocated`` above what was allocated before."""
    import dataclasses

    import torch

    cfg, model = problem.config, problem.model
    rows, grads = {}, {}
    for mode in REMAT_MODES:
        task = dataclasses.replace(problem.task, remat_rollout=mode)

        def step():
            model.zero_grad(set_to_none=True)
            loss = task.loss_fn(problem.geom, batch)
            loss.backward()
            return loss

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        zero_counts()
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        launched = counts()
        want = vorticity_launches(cfg, mode)
        if launched != {k: want.get(k, 0) for k in launched}:
            fail(f"vorticity remat {mode}: one step launched {launched}, expected {want}")
        grads[mode] = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
        rows[mode] = {"launches": launched, "loss": loss.item(), "first_step_ms": first_ms,
                      "peak_allocated_above_start_bytes": peak - base,
                      "max_memory_allocated_bytes": peak,
                      **profile_device(step, "step", reps=3, groups=FIXED_GROUPS)}
        log(f"vorticity remat {mode}: " + json.dumps(rows[mode]))
    for mode in REMAT_MODES[:2]:
        if rows[mode]["loss"] != rows["none"]["loss"]:
            fail(f"vorticity remat {mode}: loss {rows[mode]['loss']} != none's {rows['none']['loss']}")
        rows[mode]["max_abs_err_grad_vs_none"] = max(
            check_close(f"vorticity remat {mode} grad {k} vs none", g, grads["none"][k],
                        OP_RTOL, OP_ATOL * grads["none"][k].abs().max().item())
            for k, g in grads[mode].items())
    return rows


def beyond_one_step_bound(weights, ref):
    """The weight elements farther from ``ref`` than the one-step training
    bound (PARAM_ATOL + PARAM_RTOL |w|), of all."""
    n = sum(int(((v.double() - ref[k].double()).abs()
                 > PARAM_ATOL + PARAM_RTOL * ref[k].double().abs()).sum()) for k, v in weights.items())
    return {"elements": n, "of": sum(v.numel() for v in weights.values())}


def vorticity_train_phase(schedule_rows):
    """runner.train on full-width vorticity on the card (synthetic 64^2
    fields, 160 training and 40 test samples, 2 epochs of 8 steps at batch
    20, cut from 1000 / 200 and 500 epochs): each step unrolls 20 forwards
    and backpropagates through all of them, every rollout step's forward
    checkpointed (remat ``full``): exactly 240/0/120/119 launches of
    #1/#2/#3/#4 a step and 120 of #1 per eval batch; losses, the eval
    ``rel_l2_step`` and weights against a plain-attention card run, the
    first step against a CPU run; the geometry's kept sets on the card
    against a CPU build; one step under each remat mode (launches,
    gradients, time, peak memory); #1 per processor launch (256^2, D 256,
    B 20, every entry kept) beside phase 16's time at that shape; the time
    per step, steps/s and the device's busy time. It writes the checkpoint
    the evaluate and serve phases read."""
    import numpy as np
    import torch

    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.kernels import posatt_pallas as kp
    from position_induced_transformer_torch.models import pit
    from position_induced_transformer_torch.ops.posatt import bandwidth_scale, position_attention
    from position_induced_transformer_torch.train import benchmarks

    cfg = configs.VORTICITY
    epochs, ntrain, ntest = 2, 160, 40
    ckpt = str(REPO / "build" / "chip_smoke" / "vorticity_trained.pt")
    problem, state, history, losses, weights, launched, seconds = run_training(
        cfg, "cuda", epochs, ntrain, ntest, checkpoint_path=ckpt)
    steps = state.step
    eval_batches = epochs * -(-ntest // cfg.batch_size)
    per_step = vorticity_launches(cfg, "full")
    per_eval = vorticity_launches(cfg, "none")["posatt_fixed_fwd"]
    expected = {k: per_step.get(k, 0) * steps for k in launched}
    expected["posatt_fixed_fwd"] += per_eval * eval_batches
    if steps != epochs * (ntrain // cfg.batch_size) or launched != expected:
        fail(f"vorticity train: {steps} steps, {eval_batches} eval batches launched {launched}; "
             f"expected {expected} ({per_step} per step, {per_eval} of #1 per eval batch)")
    if not torch.isfinite(losses).all() or not all(
        np.isfinite(v) for row in history for v in row.values()
    ):
        fail(f"vorticity train: non-finite losses or metrics: {history}")
    report = {
        "config": cfg.name, "epochs": epochs, "ntrain": ntrain, "ntest": ntest,
        "rollout_steps": cfg.rollout_steps, "remat": problem.task.remat_mode(),
        "steps": steps, "eval_batches": eval_batches, "launches": launched,
        "launches_per_step": per_step, "launches_per_eval_batch": per_eval,
        "seconds_whole_run_cuda": seconds, "history": history,
        "step_losses_first_last": [losses[0].item(), losses[-1].item()],
        "geometry_64": kept_difference(
            problem.geom, benchmarks.setup_vorticity(cfg, ntrain=1, ntest=1, device="cpu").geom),
    }
    plain = lambda dist, lmda, inputs, locality, thr=None: position_attention(
        dist, lmda, inputs, locality, thr=thr)
    patch = mock.patch.object(pit, "position_attention_fixed", plain)
    _, _, ref_history, ref_losses, ref_weights, ref_launched, ref_s = run_training(
        cfg, "cuda", epochs, ntrain, ntest, patch)
    if any(ref_launched.values()):
        fail(f"vorticity train: the plain card run launched kernels: {ref_launched}")
    report["max_abs_err_step_loss_vs_plain_cuda"] = check_close(
        "vorticity train losses vs plain_cuda", losses, ref_losses, LOSS_RTOL, 0.0)
    rel = lambda h: torch.tensor([row["rel_l2_step"] for row in h], dtype=torch.float64)
    report["max_abs_err_rel_l2_step_vs_plain_cuda"] = check_close(
        "vorticity eval rel_l2_step vs plain_cuda", rel(history), rel(ref_history), LOSS_RTOL, 0.0)
    report["max_abs_err_weights_vs_plain_cuda"] = max(
        check_close(f"vorticity train weight {k} vs plain_cuda", v, ref_weights[k], PARAM_RTOL,
                    VORTICITY_PARAM_ATOL) for k, v in weights.items())
    report["weights_beyond_one_step_bound_vs_plain_cuda"] = beyond_one_step_bound(
        weights, ref_weights)
    report["seconds_whole_run_plain_cuda"] = ref_s
    # a full-width 20-step BPTT step takes tens of seconds on the CPU: one
    n = 1
    card_losses, card_weights, _ = first_steps(cfg, "cuda", n, ntrain, ntest, epochs)
    check_close("vorticity first step vs the full run", card_losses, losses[:n], LOSS_RTOL, 0.0)
    t0 = time.perf_counter()
    cpu_losses, cpu_weights, cpu_launched = first_steps(cfg, "cpu", n, ntrain, ntest, epochs)
    report["seconds_first_steps_cpu"] = time.perf_counter() - t0
    if any(cpu_launched.values()):
        fail(f"vorticity train: the CPU run launched kernels: {cpu_launched}")
    report["cpu_steps_compared"] = n
    report["max_abs_err_step_loss_vs_cpu"] = check_close(
        "vorticity train losses vs cpu", card_losses, cpu_losses, LOSS_RTOL, 0.0)
    report["max_abs_err_weights_vs_cpu"] = max(
        check_close(f"vorticity train weight {k} vs cpu", v, cpu_weights[k], PARAM_RTOL,
                    VORTICITY_PARAM_ATOL) for k, v in card_weights.items())
    report["weights_beyond_one_step_bound_vs_cpu"] = beyond_one_step_bound(card_weights, cpu_weights)

    dev = torch.device("cuda")
    batch = {k: torch.from_numpy(v[: cfg.batch_size]).to(dev) for k, v in problem.train_data.items()}
    report["remat_modes"] = remat_mode_phase(problem, batch)

    # #1 at the processor (global: every entry kept), the model's geometry
    # and first block's bandwidths, values of the model's width
    geom, m = problem.geom, cfg.model
    rng = np.random.default_rng(9)
    u = torch.from_numpy(rng.standard_normal((cfg.batch_size, geom.dist_proc.shape[0], m.hid_dim))
                         .astype(np.float32)).to(dev)
    thr = torch.full((geom.dist_proc.shape[0], 1), float("inf"), device=dev)
    scale = bandwidth_scale(weights["conv.0.lmda"].to(dev)).reshape(m.n_head, 1)
    got = kp.posatt_fixed_cuda(geom.dist_proc, thr, scale, u)
    want = kp.posatt_fixed_reference(geom.dist_proc, thr, scale, u)
    want = want.permute(1, 2, 0, 3).reshape(got.shape)
    phase16 = next(r for r in schedule_rows if r["shape"] == "vorticity_processor")
    report["processor_launch"] = {
        "L_out": geom.dist_proc.shape[0], "L_in": geom.dist_proc.shape[1], "B": cfg.batch_size,
        "H": m.n_head, "D": m.hid_dim,
        "max_abs_err": check_close("vorticity processor #1", got, want, OP_RTOL, OP_ATOL),
        "ms": cuda_ms(lambda: kp.posatt_fixed_cuda(geom.dist_proc, thr, scale, u)),
        "ms_with_stats": cuda_ms(lambda: kp.posatt_fixed_cuda(geom.dist_proc, thr, scale, u,
                                                             stats=True)),
        "phase16_random_points_ms": phase16["versions"]["3"]["ms"],
        "phase16_bound_ms": phase16["bound_ms"],
        "plan": kp._fwd_plan(True, m.n_head, cfg.batch_size, geom.dist_proc.shape[0],
                             geom.dist_proc.shape[1], m.hid_dim)._asdict(),
    }
    log("vorticity processor #1: " + json.dumps(report["processor_launch"]))
    report.update(step_timing(problem, state, cfg.batch_size, ntrain, cfg.lr, FIXED_GROUPS))
    return report, ckpt


def vorticity_eval_serve_phases(ckpt):
    """``evaluate("vorticity", ckpt)`` on the train phase's checkpoint (40
    test samples: 2 eval batches of 20-step rollouts, 120 launches of #1
    each and nothing else) against a plain-attention card run at rtol
    1e-4; then ``make_server("vorticity")`` answering ``.npy`` windows (n,
    4096, 10) with their 20-step rollouts (1, 8 and 13 samples, 4
    concurrent, 8 warm of 20; 120 launches of #1 per device batch; replies
    against ``infer``, a plain-attention card run and, on 2 samples, a CPU
    run); then ``?rollout_steps=5`` (30 launches per device batch, the
    first 5 steps of the default reply) and ``?rollout_steps=`` above the
    maximum (400, no launch)."""
    import dataclasses

    import numpy as np
    import torch

    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.data import synthetic
    from position_induced_transformer_torch.models import pit
    from position_induced_transformer_torch.ops.posatt import position_attention
    from position_induced_transformer_torch.train import evaluate
    from position_induced_transformer_torch.train.serve import make_server

    cfg = configs.VORTICITY
    ev_cfg = dataclasses.replace(cfg, ntrain=160)  # the trained split's size, not 1000
    ntest = 40
    per_batch = vorticity_launches(cfg, "none")["posatt_fixed_fwd"]
    zero_counts()
    t0 = time.perf_counter()
    got = evaluate.evaluate(ev_cfg, ckpt, ntest=ntest, device="cuda")
    torch.cuda.synchronize()
    evaluate_s = time.perf_counter() - t0
    launched = counts()
    n_batches = -(-ntest // cfg.batch_size)
    expected = {k: per_batch * n_batches if k == "posatt_fixed_fwd" else 0 for k in launched}
    if launched != expected:
        fail(f"vorticity evaluate: launched {launched}, expected {expected}")
    plain = lambda dist, lmda, inputs, locality, thr=None: position_attention(
        dist, lmda, inputs, locality, thr=thr)
    with mock.patch.object(pit, "position_attention_fixed", plain):
        t0 = time.perf_counter()
        want = evaluate.evaluate(ev_cfg, ckpt, ntest=ntest, device="cuda")
        plain_s = time.perf_counter() - t0
    if counts() != launched:
        fail("vorticity evaluate: the plain-attention evaluation launched a kernel")
    f64 = lambda v: torch.tensor(v, dtype=torch.float64)
    err = max(check_close(f"vorticity evaluate {k} vs plain on CUDA", f64(got[k]), f64(want[k]),
                          1e-4, 0.0) for k in ("rel_l2_step", "rel_l2_traj", "rel_l2_mean_step"))
    evaluation = {"launches": launched, "evaluate_s_cuda": evaluate_s,
                  "evaluate_s_plain_cuda": plain_s, "max_abs_err_vs_plain_cuda": err,
                  "metrics": got, "metrics_plain_cuda": want}

    x = synthetic.vorticity(n=48, frames=cfg.memory, seed=1).reshape(48, -1, cfg.memory)
    serve = fixed_serve_phase("vorticity_serve", cfg, ckpt, x, per_batch, (1, 8, 13), 4, 8,
                              cpu_samples=2)

    server = make_server(cfg.name, ckpt, host="127.0.0.1", port=0, verbose=False, device="cuda")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/predict"
    short = 5
    try:
        default = post(url, npy(x[:8]))
        zero_counts()
        calls0 = server.batcher.n_calls
        code, body = post(f"{url}?rollout_steps={short}", npy(x[:8]))
        short_launched, short_calls = counts(), server.batcher.n_calls - calls0
        too_far = server.max_rollout_steps + 1
        bad = post(f"{url}?rollout_steps={too_far}", npy(x[:8]))
        if counts() != short_launched:
            fail("vorticity serve: the refused horizon launched kernels")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if default[0] != 200 or code != 200:
        fail(f"vorticity serve: HTTP {default[0]} / {code} for the default / {short}-step horizon")
    per_short = per_batch * short // cfg.rollout_steps
    want_launched = {k: per_short * short_calls if k == "posatt_fixed_fwd" else 0 for k in short_launched}
    if short_launched != want_launched or short_calls != 1:
        fail(f"vorticity serve: {short} steps launched {short_launched} for {short_calls} batches, "
             f"expected {per_short} of #1 per batch")
    full, part = np.load(io.BytesIO(default[1])), np.load(io.BytesIO(body))
    if part.shape != full.shape[:-1] + (short,):
        fail(f"vorticity serve: {short}-step reply of shape {part.shape}, default {full.shape}")
    horizon = {
        "rollout_steps": short, "launches": short_launched, "device_batches": short_calls,
        "reply_shape": list(part.shape), "default_reply_shape": list(full.shape),
        "max_abs_err_vs_default_first_steps": check_close(
            "vorticity serve: the 5-step reply vs the default's first 5 steps",
            torch.from_numpy(part), torch.from_numpy(full[..., :short]), MODEL_RTOL, MODEL_ATOL),
        "max_rollout_steps": server.max_rollout_steps, "refused_code": bad[0],
    }
    if bad[0] != 400 or b"rollout_steps" not in bad[1]:
        fail(f"vorticity serve: rollout_steps={too_far} got HTTP {bad[0]}: {bad[1][:300]!r}")
    return evaluation, serve, horizon


# --------------------------------------- cylinder: #1, #3, #4 at full width

CYLINDER_NTRAIN, CYLINDER_NTEST = 800, 200  # 80 and 20 trajectories


def cylinder_train_phase():
    """runner.train on full-width cylinder (hid 256, 1 head, 4 blocks; 4390
    -> 896 -> 4390 points; 800 training and 200 test samples, 2 epochs of
    4 steps at batch 200; cut from 10,000 / 1000 and 500 epochs): exactly
    6/0/6/5 launches of #1/#2/#3/#4 a step (the encoder's input needs no
    gradient) and 6 of #1 per eval batch; losses and weights against a
    plain-attention card run (the CPU tests hold a narrow cylinder to the
    JAX package); time per step, steps/s, the device's busy time. Writes
    the checkpoint the next phases read; then #1 per launch at the model's
    encoder, processor and decoder with its trained bandwidths (B 200)."""
    import torch

    from position_induced_transformer_torch import configs

    cfg = configs.CYLINDER
    m = cfg.model
    ckpt = str(REPO / "build" / "chip_smoke" / "cylinder_trained.pt")
    report = fixed_train_phase("cylinder train", cfg, 2, CYLINDER_NTRAIN, CYLINDER_NTEST,
                               per_step_launches(m.n_blocks), refs=("plain_cuda",),
                               checkpoint_path=ckpt)
    sd = torch.load(ckpt, weights_only=True)["state_dict"]
    rows = fixed_op_rows("cylinder", cylinder_geometry("cuda"),
                         (sd["down.lmda"], sd["conv.0.lmda"], sd["up.lmda"]), cfg.batch_size,
                         (m.in_dim + m.space_dim, m.hid_dim, m.hid_dim), {},
                         ops=("encoder", "processor", "decoder"))
    for row, n in zip(rows, (1, m.n_blocks, 1)):
        row["launches_per_forward"] = n
    return report, ckpt, rows


CYLINDER_METRICS = ("rel_l1", "rel_l2", "rel_max", "rel_l1_quartiles", "rollout_rel_l2_step",
                    "rollout_rel_l2_mean")


def cylinder_eval_phase(ckpt):
    """``evaluate("cylinder", ckpt)`` on the card (200 test pairs: one
    one-step batch of 200, 6 launches of #1; the 20 raw test trajectories
    rolled out 10 steps in one batch, 60 launches; nothing else) against a
    plain-attention card run at rtol 1e-4."""
    import dataclasses

    import torch

    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.models import pit
    from position_induced_transformer_torch.ops.posatt import position_attention
    from position_induced_transformer_torch.train import evaluate

    cfg = dataclasses.replace(configs.CYLINDER, ntrain=CYLINDER_NTRAIN)  # the trained split
    per_forward = cfg.model.n_blocks + 2
    zero_counts()
    t0 = time.perf_counter()
    got = evaluate.evaluate(cfg, ckpt, ntest=CYLINDER_NTEST, device="cuda")
    torch.cuda.synchronize()
    evaluate_s = time.perf_counter() - t0
    launched = counts()
    steps = got["rollout_steps"]
    expected = {k: per_forward * (1 + steps) if k == "posatt_fixed_fwd" else 0 for k in launched}
    if launched != expected or steps != 10:
        fail(f"cylinder evaluate: {steps} rollout steps launched {launched}, expected {expected} "
             f"({per_forward} for the one-step batch and {per_forward} x {steps} for the rollout)")
    plain = lambda dist, lmda, inputs, locality, thr=None: position_attention(
        dist, lmda, inputs, locality, thr=thr)
    with mock.patch.object(pit, "position_attention_fixed", plain):
        t0 = time.perf_counter()
        want = evaluate.evaluate(cfg, ckpt, ntest=CYLINDER_NTEST, device="cuda")
        plain_s = time.perf_counter() - t0
    if counts() != launched:
        fail("cylinder evaluate: the plain-attention evaluation launched a kernel")
    f64 = lambda v: torch.tensor(v, dtype=torch.float64)
    err = max(check_close(f"cylinder evaluate {k} vs plain on CUDA", f64(got[k]), f64(want[k]),
                          1e-4, 0.0) for k in CYLINDER_METRICS)
    return {"launches": launched, "launches_one_step_batch": per_forward,
            "launches_rollout_batch": per_forward * steps, "evaluate_s_cuda": evaluate_s,
            "evaluate_s_plain_cuda": plain_s, "max_abs_err_vs_plain_cuda": err,
            "metrics": got, "metrics_plain_cuda": want}


def cylinder_inputs(n_traj, seed=0):
    """(n_traj * 10, 4390, 3) one-step inputs: the first 10 frames of
    synthetic trajectories on configs.CYLINDER's cloud."""
    import numpy as np

    from position_induced_transformer_torch.data import synthetic

    traj = synthetic.cylinder(n_traj=n_traj, seed=seed)[0]
    x = traj[..., :-1].transpose(0, 3, 1, 2).reshape(-1, traj.shape[1], traj.shape[2])
    return np.ascontiguousarray(x)


def cylinder_serve_phases(ckpt):
    """``make_server("cylinder")`` with the trained checkpoint answering
    ``.npy`` inputs (n, 4390, 3) one step ahead (1, 10, 13 samples, 4
    concurrent, 4 warm of 200; 6 launches of #1 per device batch of 200)
    and at ``?rollout_steps=10`` with (n, 4390, 3, 10) rollouts, the
    model's output fed back (1, 3 samples, 2 concurrent, 2 warm; 60
    launches per device batch); replies against ``infer``, a
    plain-attention card run and, on 2 samples, a CPU run."""
    from position_induced_transformer_torch import configs

    cfg = configs.CYLINDER
    x = cylinder_inputs(24, seed=1)
    n = cfg.model.n_blocks + 2
    one = fixed_serve_phase("cylinder_serve", cfg, ckpt, x, n, (1, 10, 13), 4, 4, cpu_samples=2)
    roll = fixed_serve_phase("cylinder_serve_rollout", cfg, ckpt, x, 10 * n, (1, 3), 2, 2,
                             cpu_samples=2, rollout_steps=10)
    return one, roll


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cli_phase(ckpt):
    """The command line, ``python -m position_induced_transformer_torch``,
    as subprocesses on the card (the default device), all started at once:
    ``train --benchmark cylinder`` (1 epoch of 2 steps at batch 200,
    ``--checkpoint``); and on phase 25's checkpoint ``evaluate`` (its
    metrics against the in-process ``evaluate`` at rtol 1e-4), ``infer
    --rollout-steps 10`` (against an in-process ``Predictor``), ``serve``
    on a free port answering one ``POST /predict`` (against the in-process
    one-step reply) and stopped by SIGINT, ``describe`` (the checkpoint's
    parameter count), ``benchmarks`` (13 lines) and ``convert
    --to-torch``; then ``convert --from-torch`` back, the same bits. Every
    process must exit 0, and every process is stopped when the phase
    ends."""
    import dataclasses
    import signal

    import numpy as np
    import torch

    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.train import checkpoint, evaluate

    out = REPO / "build" / "chip_smoke" / "cli"
    out.mkdir(parents=True, exist_ok=True)
    trained, pth, back = (str(out / f) for f in ("cylinder.pt", "cylinder.pth", "back.pt"))
    procs, seconds = {}, {}

    def start(label, *argv):
        procs[label] = (subprocess.Popen(
            [sys.executable, "-m", "position_induced_transformer_torch", *argv], cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), time.perf_counter())

    def finish(label, timeout=600):
        proc, t0 = procs[label]
        stdout, stderr = proc.communicate(timeout=timeout)
        seconds[label] = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"cli {label}: exit {proc.returncode}: {stderr[-3000:]}")
        return stdout

    cfg = dataclasses.replace(configs.CYLINDER, ntrain=CYLINDER_NTRAIN)
    x = cylinder_inputs(1, seed=2)[:3]
    inp, pred_path = str(out / "x.npy"), str(out / "pred.npy")
    np.save(inp, x)
    port = free_port()
    try:
        start("serve", "serve", "--benchmark", "cylinder", "--checkpoint", ckpt, "--port", str(port))
        start("train", "train", "--benchmark", "cylinder", "--epochs", "1", "--ntrain", "400",
              "--ntest", "200", "--checkpoint", trained)
        start("evaluate", "evaluate", "--benchmark", "cylinder", "--checkpoint", ckpt, "--ntest",
              str(CYLINDER_NTEST), "--set", f"ntrain={CYLINDER_NTRAIN}")
        start("infer", "infer", "--benchmark", "cylinder", "--checkpoint", ckpt, "--input", inp,
              "--output", pred_path, "--rollout-steps", "10")
        start("describe", "describe", "--benchmark", "cylinder")
        start("benchmarks", "benchmarks")
        start("convert_to_torch", "convert", "--benchmark", "cylinder", "--from", ckpt,
              "--to-torch", pth)
        results = {k: finish(k) for k in ("train", "evaluate", "infer", "describe", "benchmarks",
                                          "convert_to_torch")}
        start("convert_from_torch", "convert", "--benchmark", "cylinder", "--from-torch", pth,
              "--to", back)
        results["convert_from_torch"] = finish("convert_from_torch")
        url = f"http://127.0.0.1:{port}"
        t0 = time.perf_counter()
        while True:
            if procs["serve"][0].poll() is not None:
                finish("serve")
                fail("cli serve: the server exited before answering")
            try:
                with urllib.request.urlopen(f"{url}/health", timeout=5) as r:
                    if r.status == 200:
                        break
            except (urllib.error.URLError, ConnectionError, TimeoutError):
                pass
            if time.perf_counter() - t0 > 300:
                fail("cli serve: no /health reply within 300 s")
            time.sleep(0.5)
        code, body = post(f"{url}/predict", npy(x[:2]))
        procs["serve"][0].send_signal(signal.SIGINT)
        finish("serve", timeout=60)
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if code != 200:
        fail(f"cli serve: HTTP {code}: {body[:500]!r}")
    served = torch.from_numpy(np.load(io.BytesIO(body)))

    final = json.loads(results["train"].splitlines()[-1])["final"]
    state = checkpoint.restore(ckpt)["state_dict"]
    if not all(np.isfinite(v) for v in final.values()) or set(
            checkpoint.restore(trained)["state_dict"]) != set(state):
        fail(f"cli train: {final}")
    got = json.loads(results["evaluate"].splitlines()[-1])
    want = evaluate.evaluate(cfg, ckpt, ntest=CYLINDER_NTEST, device="cuda")
    f64 = lambda v: torch.tensor(v, dtype=torch.float64)
    eval_err = max(check_close(f"cli evaluate {k} vs in-process", f64(got[k]), f64(want[k]),
                               1e-4, 0.0) for k in CYLINDER_METRICS)
    predictor = evaluate.Predictor(cfg, ckpt, device="cuda")
    roll = torch.from_numpy(predictor.predict_array({"x": x}, 10))
    one = torch.from_numpy(predictor.predict_array({"x": x[:2]}))
    infer_err = check_close("cli infer --rollout-steps 10 vs in-process", torch.from_numpy(
        np.load(pred_path)), roll, MODEL_RTOL, model_atol(10, roll))
    serve_err = check_close("cli serve vs in-process", served, one, MODEL_RTOL, MODEL_ATOL)
    info = json.loads(results["describe"])
    if info["params"] != sum(v.numel() for v in state.values()) or info["benchmark"] != "cylinder":
        fail(f"cli describe: {info}")
    listed = results["benchmarks"].splitlines()
    if len(listed) != 13 or not any(line.startswith("cylinder ") for line in listed):
        fail(f"cli benchmarks: {listed}")
    round_trip = checkpoint.restore(back)
    if round_trip["config"] != "cylinder" or set(round_trip["state_dict"]) != set(state) or not all(
            torch.equal(round_trip["state_dict"][k], v) for k, v in state.items()):
        fail("cli convert: the model.pth round trip changed the weights")
    return {"seconds": seconds, "train_final": final, "evaluate": got,
            "max_abs_err_evaluate_vs_in_process": eval_err,
            "infer_shape": list(roll.shape), "max_abs_err_infer_vs_in_process": infer_err,
            "max_abs_err_serve_vs_in_process": serve_err, "describe": info,
            "convert": [json.loads(results[k]) for k in ("convert_to_torch", "convert_from_torch")]}


# ------------------- the fixed-mesh TF family: kernel #13 on five configs

# the configurations of the fixed-mesh TF family (PiTTF), in phase order
TF_FIXED_CONFIGS = ("burgers_tf", "sod_tf", "darcy_tf", "vorticity_tf", "naca_tf")
# #13's kernels' names in a trace
TF_FIXED_GROUPS = {
    "posatt_tf_fixed_fwd": "void (anonymous namespace)::fwd_kernel<",
    "posatt_tf_fixed_scan": "(anonymous namespace)::scan_kernel(",
    "posatt_tf_fixed_lists": "(anonymous namespace)::lists_kernel(",
    "posatt_tf_fixed_bwd_dv": "void (anonymous namespace)::dv_kernel<",
    "posatt_tf_fixed_bwd_dscale": "(anonymous namespace)::dscale_kernel(",
    "posatt_tf_fixed_sum_splits": "tffixed::sum_splits_kernel(",
}
# naca_tf's heads take the scales tan(r) of these r, op by op: negative,
# zero and positive heads (r of either sign before keras' NonNeg projection)
NACA_TF_R = {"down": (-0.35, 0.25), "processor": (0.0, -0.2), "up": (0.3, 0.0)}
RAGGED_TF_FIXED = [  # name, L_out, L_in, B, H, V, bandwidth, locality, r of each head
    ("tff_h1_v4", 37, 53, 3, 1, 4, "tan_sin", 10.0, None),
    ("tff_h3_v33_tan", 130, 77, 2, 3, 33, "tan", 20.0, (-0.5, 0.0, 0.4)),
    ("tff_h8_v16_global_b9", 100, 300, 9, 8, 16, "square", 200.0, None),
    ("tff_h5_v256_tan", 260, 129, 4, 5, 256, "tan", 5.0, (0.3, -0.3, 0.0, -0.1, 0.6)),
    ("tff_h4_v7_b13", 300, 257, 13, 4, 7, "tan_sin", 5.0, None),
    ("tff_h2_v100_tan_global", 64, 1100, 2, 2, 100, "tan", 200.0, (-0.4, 0.5)),
    # rows that keep nothing (thresholds below every distance): uniform weights
    ("tff_h2_v12_empty_rows", 64, 64, 2, 2, 12, "square", 1.0, None),
    # one such row in a row tile: that tile lists every step
    ("tff_h2_v16_one_empty_row", 300, 1100, 4, 2, 16, "tan_sin", 2.0, None),
    ("tff_h2_v8_zero_negative", 520, 333, 8, 2, 8, "tan", 3.0, (0.0, -0.2)),
    # few row tiles: the forward's splits cut each tile's list
    ("tff_h2_v20_split_lists", 301, 5003, 2, 2, 20, "tan", 0.5, (0.3, 0.6)),
]


def plain_tf_fixed(dist, thr, scales, values, kind, locality):
    """Kernel #13's public function on its plain version: no kernel."""
    from position_induced_transformer_torch.kernels import posatt_tf_fixed as kf

    if locality > 100:
        thr = None
    elif thr is None:
        thr = kf.percentile_thresholds(dist, locality)
    return kf.posatt_tf_fixed_reference(dist, thr, scales, values, kf.KINDS[kind])


def plain_tf_fixed_attention():
    """PiTTF's attention ops on #13's plain version."""
    from position_induced_transformer_torch.models import pit_tf

    return mock.patch.object(pit_tf, "position_attention_tf_fixed", plain_tf_fixed)


def tf_fixed_ops(cfg, geom):
    """The attention ops of one PiTTF forward: name -> (dist, thr, locality,
    launches per forward)."""
    from position_induced_transformer_torch.train import benchmarks

    m = cfg.model
    ops = {"down": (geom.m_cross_t, geom.thr_down, m.en_loc, 1),
           "processor": (geom.m_ltt, None, 200.0, m.n_blocks),
           "up": (geom.m_cross, geom.thr_up, m.de_loc, 1)}
    if benchmarks.TF_FIXED[cfg.name][1]:
        ops["up2"] = (geom.m_qry, geom.thr_qry, m.de_loc, 1)
    return ops


def tf_fixed_case(rng, dist, thr, locality, B, H, V, kind, r=None):
    """One #13 op's arguments on the card: (dist, thr or None, scales (H,
    1), r, values, g, mode); scales are the bandwidth ``kind`` of r, drawn
    from the glorot range of a (H, 1, 1) parameter unless given."""
    import numpy as np
    import torch

    from position_induced_transformer_torch.kernels import posatt_tf_fixed as kf
    from position_induced_transformer_torch.models import pit_tf

    if r is None:
        lim = float(np.sqrt(6.0 / (2 * H)))
        r = rng.uniform(-lim, lim, H)
    r = torch.tensor(np.asarray(r, np.float32).reshape(H, 1), device="cuda")
    scales = pit_tf._bandwidth(r, kind)
    Lo, Li = dist.shape
    to = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()
    values = to(rng.standard_normal((B, Li, H * V)))
    g = to(rng.standard_normal((B, Lo, H * V)))
    thr = None if locality > 100 else thr
    return dist, thr, scales, r, values, g, kf.KINDS[kind]


def tf_fixed_work(case):
    """Kept entries over the heads, and the bytes each entry point must
    move: every input read once, every output written once."""
    from position_induced_transformer_torch.kernels import posatt_tf_fixed as kf

    dist, thr, scales, _, values, g, mode = case
    _, keep = kf._scaled_keep(dist, thr, scales, mode)
    H = scales.shape[0]
    Lo, Li = dist.shape
    kept = H * Lo * Li if keep is None else int(keep.sum())
    B, HV = values.shape[0], values.shape[2]
    geo = Lo * Li + (2 * Lo if thr is not None else 0) + H  # distances, thresholds, scales
    stats = 2 * H * Lo
    return kept, {
        "fwd": 4 * (geo + B * Li * HV + B * Lo * HV + stats),
        "dv": 4 * (geo + stats + B * Lo * HV + B * Li * HV),
        "dscale": 4 * (geo + stats + B * Li * HV + 2 * B * Lo * HV + H),
    }


def tf_fixed_sdpa(case):
    """One SDPA call computing the forward: zero q and k, per-head values
    and the masked logits as ``attn_mask``."""
    import torch
    import torch.nn.functional as F

    from position_induced_transformer_torch.kernels import posatt_tf_fixed as kf

    dist, thr, scales, _, values, _, mode = case
    scaled, keep = kf._scaled_keep(dist, thr, scales, mode)
    logits = -scaled if keep is None else torch.where(keep, -scaled, float("-inf"))
    # a row that keeps nothing: JAX's sentinel makes it uniform
    logits = torch.where(torch.isinf(logits).all(-1, keepdim=True), 0.0, logits)[None]
    H, Lo, Li = scaled.shape
    B = values.shape[0]
    V = values.shape[2] // H
    q = torch.zeros((B, H, Lo, V), device=dist.device)
    k = torch.zeros((B, H, Li, V), device=dist.device)
    vv = values.reshape(B, Li, H, V).permute(0, 2, 1, 3).contiguous()
    return lambda: F.scaled_dot_product_attention(q, k, vv, attn_mask=logits)


def tf_fixed_dscale_size(case, out):
    """The size of dscale's summed terms per head, sum_ij att |T d| + att d
    |r| (``out`` the forward's output): its float32 rounding scales with
    these, not with the cancelled sum."""
    import torch

    from position_induced_transformer_torch.kernels import posatt_tf_fixed as kf

    dist, thr, scales, _, values, g, mode = case
    att, keep = kf._attention(dist, thr, scales, mode)
    H, Lo, Li = att.shape
    B = values.shape[0]
    gh = g.reshape(B, Lo, H, -1)
    t = torch.einsum("bihv,bjhv->hij", gh, values.reshape(B, Li, H, -1))
    r = torch.einsum("bihv,bihv->hi", gh, out.reshape(B, Lo, H, -1))
    d = dist if keep is None else torch.where(keep, dist, 0.0)
    return (att * (t * d).abs()).sum((-1, -2)) + ((att * d).sum(-1) * r.abs()).sum(-1) + 1e-30


def tf_fixed_lists(case, steps):
    """The kept-step lists of one op: the steps the forward and dv walk
    summed over their tiles and heads, their share of the dense walk, the
    share of dscale's tiles it contracts, and the forward's and dv's
    splits."""
    from position_induced_transformer_torch.kernels import posatt_tf_fixed as kf

    dist, _, scales, _, values, _, _ = case
    Lo, Li = dist.shape
    H, B = scales.shape[0], values.shape[0]
    V = values.shape[2] // H
    ft, dt = kf._row_tile(B, Lo, H, V), kf._row_tile(B, Li, H, V)
    nT, nU = -(-Li // 16), -(-Lo // 16)
    dense = {"fwd": H * -(-Lo // ft) * nT, "dv": H * -(-Li // dt) * nU,
             "tiles": H * -(-Lo // 128) * -(-Li // 128)}
    walked = dense if steps is None else {"fwd": int(steps.fwd_cnt.sum()),
                                          "dv": int(steps.dv_cnt.sum()),
                                          "tiles": int(steps.tiles.sum())}
    return {"fwd_steps": walked["fwd"], "fwd_share": walked["fwd"] / dense["fwd"],
            "dv_steps": walked["dv"], "dv_share": walked["dv"] / dense["dv"],
            "dscale_tile_share": walked["tiles"] / dense["tiles"],
            "fwd_rows_a_block": ft, "dv_columns_a_block": dt,
            "fwd_splits": kf._split_plan(B, Lo, Li, H, V)[0],
            "dv_splits": kf._split_plan(B, Li, Lo, H, V)[0],
            "dscale_splits": kf._dscale_plan(B, Lo, Li, H, V)[0]}


def tf_fixed_lists_equal(dist, thr, scales, mode, steps):
    """Whether the forward's kept-step lists equal the plain version's at
    the same tiles (both None for a global op)."""
    import torch

    from position_induced_transformer_torch.kernels import posatt_tf_fixed as kf

    if steps is None:
        return thr is None
    want = kf.posatt_tf_fixed_lists_reference(dist, thr, scales, mode, steps.fwd_tile,
                                              steps.dv_tile)
    return all(torch.equal(a, b) if torch.is_tensor(a) else a == b for a, b in zip(steps, want))


def tf_fixed_check(name, case, timed, reps=5, per_rep=4):
    """#13's three entry points against their plain versions on one op:
    the forward with its statistics and kept-step lists (the plain
    version's, exactly), dv and dscale on those lists, each run twice to
    the same bits, at the op tolerances (dv on its terms' magnitude, dscale
    normalised); with ``timed``, each timed beside its plain version, the
    bound and, for the forward, SDPA. Returns the row, with the lists'
    length and share of the steps."""
    import torch

    from position_induced_transformer_torch.kernels import posatt_tf_fixed as kf

    dist, thr, scales, _, values, g, mode = case
    out, stats, steps = kf.posatt_tf_fixed_cuda(dist, thr, scales, values, mode)
    dv = kf.posatt_tf_fixed_bwd_dv_cuda(dist, thr, scales, g, stats, mode, steps)
    ds = kf.posatt_tf_fixed_bwd_dscale_cuda(dist, thr, scales, values, out, g, stats, mode, steps)
    again = (kf.posatt_tf_fixed_cuda(dist, thr, scales, values, mode)[0],
             kf.posatt_tf_fixed_bwd_dv_cuda(dist, thr, scales, g, stats, mode, steps),
             kf.posatt_tf_fixed_bwd_dscale_cuda(dist, thr, scales, values, out, g, stats, mode,
                                                steps))
    torch.cuda.synchronize()
    for part, first, second in zip(("forward", "dv", "dscale"), (out, dv, ds), again):
        if not torch.equal(first, second):
            fail(f"{name}: two {part} runs on the same inputs differ")
    if not tf_fixed_lists_equal(dist, thr, scales, mode, steps):
        fail(f"{name}: the kept-step lists differ from the plain version's")
    want = kf.posatt_tf_fixed_reference(dist, thr, scales, values, mode)
    errs = {"fwd": check_close(f"{name} forward", out, want, OP_RTOL, OP_ATOL)}
    want_stats = kf.posatt_tf_fixed_stats_reference(dist, thr, scales, mode)
    empty = torch.isinf(want_stats)  # m of a row that keeps nothing
    if not torch.equal(torch.isinf(stats), empty):
        fail(f"{name} stats: the rows that keep nothing differ from the plain version's")
    errs["stats"] = check_close(f"{name} stats", torch.where(empty, 0.0, stats),
                                torch.where(empty, 0.0, want_stats), OP_RTOL, OP_ATOL)
    errs["dv"] = check_close(
        f"{name} dv", dv, kf.posatt_tf_fixed_bwd_dv_reference(dist, thr, scales, g, mode),
        OP_RTOL, OP_ATOL, kf.posatt_tf_fixed_bwd_dv_reference(dist, thr, scales, g.abs(), mode))
    want_ds = kf.posatt_tf_fixed_bwd_dscale_reference(dist, thr, scales, values, want, g, mode)
    size = tf_fixed_dscale_size(case, want)
    check_close(f"{name} dscale (normalised)", ds / size, want_ds / size, DS_RTOL, DS_ATOL)
    errs["dscale"] = (ds - want_ds).abs().max().item()
    Lo, Li = dist.shape
    B, H = values.shape[0], scales.shape[0]
    row = {"shape": name, "L_out": Lo, "L_in": Li, "B": B, "H": H, "V": values.shape[2] // H,
           "mode": mode, "scales": scales.flatten().tolist(), "max_abs_err": errs,
           "lists": tf_fixed_lists(case, steps)}
    if not timed:
        return row
    kept, nbytes = tf_fixed_work(case)
    V = values.shape[2] // H
    flops = {"fwd": 2 * B * V * kept, "dv": 2 * B * V * kept,
             "dscale": 2 * B * V * kept + 2 * B * Lo * H * V}
    launch = {  # as the autograd Function runs them: the backward on the forward's lists
        "fwd": lambda: kf.posatt_tf_fixed_cuda(dist, thr, scales, values, mode),
        "dv": lambda: kf.posatt_tf_fixed_bwd_dv_cuda(dist, thr, scales, g, stats, mode, steps),
        "dscale": lambda: kf.posatt_tf_fixed_bwd_dscale_cuda(dist, thr, scales, values, out, g,
                                                             stats, mode, steps),
    }
    plain = {
        "fwd": lambda: kf.posatt_tf_fixed_reference(dist, thr, scales, values, mode),
        "dv": lambda: kf.posatt_tf_fixed_bwd_dv_reference(dist, thr, scales, g, mode),
        "dscale": lambda: kf.posatt_tf_fixed_bwd_dscale_reference(dist, thr, scales, values, out,
                                                                  g, mode),
    }
    row["kept_entries"] = kept
    for part in ("fwd", "dv", "dscale"):
        bound_ms, bound_by = roofline(flops[part], nbytes[part])
        row[part] = {"ms": cuda_ms(launch[part], reps=reps, per_rep=per_rep),
                     "plain_ms": cuda_ms(plain[part], reps=reps, per_rep=per_rep),
                     "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops[part],
                     "bytes": nbytes[part]}
    sdpa = tf_fixed_sdpa(case)
    row["fwd"]["library_max_abs_err"] = (
        sdpa().permute(0, 2, 1, 3).reshape(B, Lo, -1) - want).abs().max().item()
    row["fwd"]["library_ms"] = cuda_ms(sdpa, reps=reps, per_rep=per_rep)
    del sdpa
    return row


def log_tf_fixed_times(label, row):
    """One line per op: each entry point's time beside its plain version
    and bound, and the lists' length and share of the steps."""
    li = row["lists"]
    log(f"#13 {label} ({row['L_out']} x {row['L_in']}): " + "; ".join(
        f"{p} {row[p]['ms']:.4f} ms (plain {row[p]['plain_ms']:.4f}, bound {row[p]['bound_ms']:.4f})"
        for p in ("fwd", "dscale", "dv"))
        + f"; SDPA {row['fwd']['library_ms']:.4f}; lists fwd {li['fwd_steps']} steps"
        f" ({li['fwd_share']:.4f}), dv {li['dv_steps']} ({li['dv_share']:.4f}),"
        f" dscale tiles {li['dscale_tile_share']:.4f}")


def tf_fixed_function_check(name, case):
    """One forward + backward through the public function (r -> the
    bandwidth -> PosAttTFFixed) launches each entry point once; its
    gradients in r and the values against torch.autograd of the plain
    version."""
    import torch

    from position_induced_transformer_torch.kernels import posatt_tf_fixed as kf
    from position_induced_transformer_torch.models import pit_tf

    dist, thr, _, r0, values, g, mode = case
    kind = {0: "tan_sin", 1: "tan"}[mode]
    locality = 200.0 if thr is None else 50.0

    def grads(fn, w):
        r = r0.clone().requires_grad_(True)
        x = values.clone().requires_grad_(True)
        out = fn(dist, thr, pit_tf._bandwidth(r, kind).reshape(-1, 1), x, kind, locality)
        (out * w).sum().backward()
        return out.detach(), r.grad, x.grad

    before = counts()
    got = grads(kf.position_attention_tf_fixed, g)
    torch.cuda.synchronize()
    diff = {k: v - before[k] for k, v in counts().items()}
    if diff != {k: int(k in TF_FIXED_KERNELS) for k in diff}:
        fail(f"{name}: one forward + backward launched {diff}, expected 1 each of {TF_FIXED_KERNELS}")
    want = grads(plain_tf_fixed, g)
    size_x = grads(plain_tf_fixed, g.abs())[2]
    # d r = dscale * d bandwidth / d r: normalised by the terms' size
    r = r0.clone().requires_grad_(True)
    pit_tf._bandwidth(r, kind).sum().backward()
    size_r = tf_fixed_dscale_size(case[:2] + (pit_tf._bandwidth(r0, kind),) + case[3:],
                                  want[0]).reshape(r0.shape) * r.grad.abs() + 1e-30
    check_close(f"{name} Function d r (normalised)", got[1] / size_r, want[1] / size_r,
                DS_RTOL, DS_ATOL)
    return max(
        check_close(f"{name} Function out", got[0], want[0], OP_RTOL, OP_ATOL),
        (got[1] - want[1]).abs().max().item(),
        check_close(f"{name} Function d values", got[2], want[2], OP_RTOL, OP_ATOL, size_x),
    )


def tf_fixed_kernel_phase():
    """#13's forward, dscale and dv against their plain versions at every
    attention op of the five fixed-mesh TF configurations at full width
    (their setups' geometry; naca_tf's heads of scale tan(r) negative, zero
    and positive), darcy_tf's 421^2 ZSSR encoder and decoder, and ragged
    shapes (1 to 8 heads, V 4 to 256, batches past 8 samples, rows that
    keep nothing); each timed beside its plain version, the bound and SDPA;
    the autograd Function's gradients against autograd of the plain
    version, one forward + backward launching each entry point once."""
    import numpy as np
    import torch

    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.kernels import posatt_tf_fixed as kf
    from position_induced_transformer_torch.train import benchmarks

    rng = np.random.default_rng(13)
    rows, fn_err = [], 0.0
    for name in TF_FIXED_CONFIGS:
        cfg = configs.get(name)
        m = cfg.model
        problem = benchmarks.setup(cfg, ntrain=cfg.batch_size, ntest=2, device="cuda")
        kind = benchmarks.TF_FIXED[name][0]
        V = m.hid_dim // m.n_head
        for op, (dist, thr, loc, per_forward) in tf_fixed_ops(cfg, problem.geom).items():
            r = NACA_TF_R[op] if name == "naca_tf" else None
            case = tf_fixed_case(rng, dist, thr, loc, cfg.batch_size, m.n_head, V, kind, r)
            row = tf_fixed_check(f"{name} {op}", case, timed=True)
            row.update(config=name, op=op, launches_per_forward=per_forward)
            rows.append(row)
            log(f"kernel posatt_tf_fixed {name} {op}: {json.dumps(row)}")
            log_tf_fixed_times(f"{name} {op}", row)
            if op in ("down", "processor"):
                fn_err = max(fn_err, tf_fixed_function_check(f"{name} {op}", case))
            del case
        del problem
    # darcy_tf's zero-shot 421^2 encoder and decoder
    cfg = configs.DARCY_TF
    problem = benchmarks.setup(cfg, ntrain=cfg.batch_size, ntest=2, downsampling=1, device="cuda")
    ops = tf_fixed_ops(cfg, problem.geom)
    m = cfg.model
    for op in ("down", "up"):
        dist, thr, loc, _ = ops[op]
        case = tf_fixed_case(rng, dist, thr, loc, cfg.batch_size, m.n_head, m.hid_dim // m.n_head,
                             "tan_sin")
        row = tf_fixed_check(f"darcy_tf_zssr {op}", case, timed=True, reps=3, per_rep=2)
        row.update(config="darcy_tf_zssr", op=op, launches_per_forward=1)
        rows.append(row)
        log(f"kernel posatt_tf_fixed darcy_tf_zssr {op}: {json.dumps(row)}")
        log_tf_fixed_times(f"darcy_tf_zssr {op}", row)
        del case
    del problem, ops
    torch.cuda.empty_cache()
    ragged_err = {}
    for name, Lo, Li, B, H, V, kind, loc, r in RAGGED_TF_FIXED:
        dist = torch.from_numpy(rng.random((Lo, Li)).astype(np.float32)).cuda()
        thr = kf.percentile_thresholds(dist, loc) if loc <= 100 else None
        if name.endswith("empty_rows"):  # half the rows below their minimum
            thr = thr.clone()
            thr[::2] = dist[::2].amin(-1, keepdim=True) * 0.5
        elif name.endswith("one_empty_row"):  # row 130, in the second row tile
            thr = thr.clone()
            thr[130] = torch.stack([dist[130].amin() * 0.5, dist[130].amax() * 2.0])
        case = tf_fixed_case(rng, dist, thr, loc, B, H, V, kind, r)
        row = tf_fixed_check(name, case, timed=False)
        ragged_err[name] = row["max_abs_err"]
        fn_err = max(fn_err, tf_fixed_function_check(name, case))
        log(f"kernel posatt_tf_fixed {name}: {json.dumps(row)}")
    log(f"PosAttTFFixed: gradients match autograd of the plain version, max abs err {fn_err:.3e}")
    return rows, ragged_err, fn_err


def tf_fixed_launches(cfg):
    """#13's launches per training step and per served or evaluated batch
    of a PiTTF configuration: one forward, dscale and dv per attention op
    (every op's values need a gradient); a rollout runs its ops once a
    step and, under remat ``full``, its forwards again in the backward."""
    from position_induced_transformer_torch.train import benchmarks

    n = cfg.model.n_blocks + 2 + int(benchmarks.TF_FIXED[cfg.name][1])
    steps = cfg.rollout_steps or 1
    per_batch = n * steps
    per_step = {"posatt_tf_fixed_fwd": per_batch * (2 if cfg.rollout_steps else 1),
                "posatt_tf_fixed_bwd_dscale": per_batch, "posatt_tf_fixed_bwd_dv": per_batch}
    return per_step, per_batch


# name -> (training split, test split, reference runs): 2 epochs each; the
# CPU runs where the width allows (vorticity_tf's 20-step BPTT and naca_tf's
# 11,271 x 2,886 ops take minutes a step on the card machine's CPU)
TF_FIXED_TRAIN = {
    "burgers_tf": (10, 10, ("plain_cuda", "cpu")),
    "sod_tf": (16, 8, ("plain_cuda", "cpu")),
    "darcy_tf": (16, 8, ("plain_cuda", "cpu")),
    "vorticity_tf": (16, 8, ("plain_cuda",)),
    "naca_tf": (16, 8, ("plain_cuda",)),
}


def tf_fixed_train_phase(name):
    """runner.train on one PiTTF configuration at full width and depth
    (synthetic data, 2 epochs of 2 steps; cut from ~1000 samples and 500
    epochs): exactly the launches of :func:`tf_fixed_launches` per step and
    per eval batch; losses and weights against a plain-attention card run
    and, where the width allows, a CPU run; the time per step, steps/s and
    the device's busy share. Returns the report and the checkpoint."""
    from position_induced_transformer_torch import configs

    cfg = configs.get(name)
    ntrain, ntest, refs = TF_FIXED_TRAIN[name]
    per_step, per_batch = tf_fixed_launches(cfg)
    ckpt = str(REPO / "build" / "chip_smoke" / f"{name}.pt")
    report = fixed_train_phase(
        f"{name} train", cfg, 2, ntrain, ntest, per_step, refs=refs, fwd="posatt_tf_fixed_fwd",
        plain_patch=plain_tf_fixed_attention, per_eval_batch=per_batch, groups=TF_FIXED_GROUPS,
        checkpoint_path=ckpt)
    if name == "naca_tf":  # keras' NonNeg projection after every update
        from position_induced_transformer_torch.train import checkpoint

        sd = checkpoint.restore(ckpt)["state_dict"]
        low = min(float(v.min()) for k, v in sd.items() if k.endswith("band_width"))
        if low < 0:
            fail(f"naca_tf train: a band_width of {low} after the NonNeg projection")
        report["min_band_width"] = low
    return report, ckpt


def tf_fixed_inputs(cfg, n):
    """``n`` raw inputs of a PiTTF configuration, as a request carries
    them (seed 1: not the training data)."""
    from position_induced_transformer_torch.data import synthetic

    if cfg.name == "burgers_tf":
        return synthetic.burgers(n=n, L=cfg.grid[0], seed=1)[0]
    if cfg.name == "sod_tf":
        return synthetic.sod(n=n, L=cfg.grid[0], seed=1)[0]
    if cfg.name == "darcy_tf":
        return synthetic.darcy(n=n, s=43, seed=1)[0]
    if cfg.name == "vorticity_tf":
        return synthetic.vorticity(n=n, frames=cfg.memory, seed=1).reshape(n, -1, cfg.memory)
    return synthetic.naca(n=n, nx=cfg.grid[0], ny=cfg.grid[1], seed=1)[1]  # C-grid vertices


def tf_fixed_serve_phase(name, ckpt, rollout_steps=None):
    """make_server(name) on the train phase's checkpoint answering raw
    ``.npy`` inputs (1, 3 and 5 samples, 2 concurrent, 4 warm; vorticity_tf
    rolls them out, at ``?rollout_steps=`` where given): #13's forward
    exactly as often as :func:`tf_fixed_launches` says per device batch and
    no other kernel; replies against ``infer``, a plain-attention card run
    and, on the first samples, a CPU run."""
    from position_induced_transformer_torch import configs

    cfg = configs.get(name)
    _, per_batch = tf_fixed_launches(cfg)
    if rollout_steps is not None:
        per_batch = per_batch * rollout_steps // cfg.rollout_steps
    x = tf_fixed_inputs(cfg, (cfg.eval_batch_size or cfg.batch_size) + 12)  # warm: whole batches
    label = f"{name}_serve" + (f"_rollout_{rollout_steps}" if rollout_steps else "")
    return fixed_serve_phase(label, cfg, ckpt, x, per_batch, (1, 3, 5), 2, 4,
                             cpu_samples=1 if name in ("vorticity_tf", "naca_tf") else 2,
                             rollout_steps=rollout_steps, fwd="posatt_tf_fixed_fwd",
                             plain_patch=plain_tf_fixed_attention, groups=TF_FIXED_GROUPS)


def tf_fixed_evaluate_phase(name, ckpt, **kw):
    """``evaluate(name, ckpt, **kw)`` on the card (darcy_tf: ``zssr=True``,
    the 421^2 grid; vorticity_tf: its 20-step rollouts) on one eval batch:
    #13's forward exactly as often as :func:`tf_fixed_launches` says and no
    other kernel; its metrics against a plain-attention card run at rtol
    1e-4."""
    import dataclasses

    import torch

    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.train import evaluate

    cfg = configs.get(name)
    ntrain, ntest, _ = TF_FIXED_TRAIN[name]
    ev_cfg = dataclasses.replace(cfg, ntrain=ntrain)  # the trained split's size
    _, per_batch = tf_fixed_launches(cfg)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = evaluate.evaluate(ev_cfg, ckpt, ntest=ntest, device="cuda", **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = counts()
    expected = {k: per_batch if k == "posatt_tf_fixed_fwd" else 0 for k in launched}
    if launched != expected:
        fail(f"{name} evaluate: launched {launched}, expected {expected}")
    with plain_tf_fixed_attention():
        t0 = time.perf_counter()
        want = evaluate.evaluate(ev_cfg, ckpt, ntest=ntest, device="cuda", **kw)
        plain_s = time.perf_counter() - t0
    if counts() != launched:
        fail(f"{name} evaluate: the plain-attention evaluation launched a kernel")
    keys = [k for k, v in got.items() if isinstance(v, (float, list)) and k != "rel_l1_quartiles"]
    f64 = lambda v: torch.tensor(v, dtype=torch.float64)
    err = max(check_close(f"{name} evaluate {k} vs plain on CUDA", f64(got[k]), f64(want[k]),
                          1e-4, 0.0) for k in keys)
    return {"config": name, "options": kw, "launches": launched, "evaluate_s_cuda": seconds,
            "evaluate_s_plain_cuda": plain_s, "max_abs_err_vs_plain_cuda": err,
            "metrics": got, "metrics_plain_cuda": want}


def tf_fixed_phases():
    """The five PiTTF configurations: train, serve, and evaluate darcy_tf
    at 421^2 and vorticity_tf by rollout; name -> report."""
    reports = {}
    for name in TF_FIXED_CONFIGS:
        train, ckpt = tf_fixed_train_phase(name)
        log(f"{name}_train " + json.dumps(train))
        serve = tf_fixed_serve_phase(name, ckpt)
        log(f"{name}_serve " + json.dumps(serve))
        reports[name] = {"train": train, "serve": serve}
        if name == "darcy_tf":
            reports[name]["zssr"] = tf_fixed_evaluate_phase(name, ckpt, zssr=True)
            log(f"{name}_zssr " + json.dumps(reports[name]["zssr"]))
        if name == "vorticity_tf":
            reports[name]["evaluate"] = tf_fixed_evaluate_phase(name, ckpt)
            log(f"{name}_evaluate " + json.dumps(reports[name]["evaluate"]))
            reports[name]["serve_rollout_5"] = tf_fixed_serve_phase(name, ckpt, rollout_steps=5)
            log(f"{name}_serve_rollout_5 " + json.dumps(reports[name]["serve_rollout_5"]))
    return reports


# ------------- the TF ablation variants: dot-product attention kernel #14

# #14's kernels' names in a trace
DOTATT_GROUPS = {
    "dotatt_fwd": "void dotatt::fwd_kernel<",
    "dotatt_bwd_dq": "void dotatt::dq_kernel<",
    "dotatt_bwd_dscale_sum": "dotatt::reduce_kernel(",
    "dotatt_bwd_dkdv": "void dotatt::dkv_kernel<",
}
# the self and hybrid ops of the variants at full width: name -> (config,
# variant, kind, B, launches a forward); L, H and V from the config, the
# hybrid ops' distances from its setup (burgers_tf selfpit: 1024 -> 1024)
DOTATT_OPS = {
    "burgers_tf_self": ("burgers_tf", "transformer", "self", 5, 7),
    "burgers_tf_selfpit_down": ("burgers_tf", "selfpit", "down", 5, 1),
    "burgers_tf_selfpit_processor": ("burgers_tf", "selfpit", "processor", 5, 4),
    "burgers_tf_selfpit_up": ("burgers_tf", "selfpit", "up", 5, 2),  # up and up2
    "sod_tf_lite": ("sod_tf", "lite", "self", 8, 4),
    "sod_tf_transformer": ("sod_tf", "transformer", "self", 8, 7),
    "darcy_tf_lite": ("darcy_tf", "lite", "self", 8, 4),
    "darcy_tf_transformer": ("darcy_tf", "transformer", "self", 8, 6),
    "vorticity_tf_lite": ("vorticity_tf", "lite", "self", 8, 4),
    "vorticity_tf_transformer": ("vorticity_tf", "transformer", "self", 8, 6),
    "naca_tf_lite": ("naca_tf", "lite", "self", 8, 4),
    # the largest: the plain version holds one (2, 11271, 11271) logit
    # tensor (1 GB) at batch 1; the model trains at batch 8
    "naca_tf_transformer": ("naca_tf", "transformer", "self", 1, 6),
    "elasticity_tf_self": ("elasticity_tf", "transformer", "self", 10, 6),
}
DOTATT_RAGGED = [  # name, B, L, H, V, kind: self, local / global (hybrid), empty (local,
    # every second row keeping nothing: uniform weights)
    ("dot_l1_h1_v16", 2, 1, 1, 16, "self"),
    ("dot_l17_h3_v16_local", 3, 17, 3, 16, "local"),
    ("dot_l972_h8_v16", 2, 972, 8, 16, "self"),
    ("dot_l1849_h1_v256_global", 1, 1849, 1, 256, "global"),
    ("dot_l300_h3_v256_local", 2, 300, 3, 256, "local"),
    ("dot_l100_h3_v21", 2, 100, 3, 21, "self"),  # V % 4 != 0: 4-byte copies
    ("dot_l130_h8_v128_empty", 2, 130, 8, 128, "empty"),
]


def plain_dotatt(q, k, v, dist=None, thr=None, scale=None):
    """Kernel #14's public function on its plain version: no kernel."""
    from position_induced_transformer_torch.kernels import dotatt as kd

    return kd.dotatt_reference(q.contiguous(), k.contiguous(), v.contiguous(), dist, thr, scale)


@contextmanager
def plain_variant_attention():
    """Every attention op of the TF models on its plain version: #13's
    and #14's public functions, and #9/#11's (the point-cloud coders)."""
    from position_induced_transformer_torch.models import pit_tf

    with plain_tf_fixed_attention(), plain_tf_attention(), \
            mock.patch.object(pit_tf, "dot_attention", plain_dotatt):
        yield


def dotatt_case(rng, B, L, H, V, kind, dist=None, locality=None):
    """One #14 op's arguments on the card: (q, k, v, g, dist, thr, scale);
    hybrid scales tan(r) of r from the glorot range of a (H, 1, 1)
    parameter, thresholds the per-head row quantile of the scaled
    distances at ``locality`` (as the model takes them), random distances
    unless given."""
    import numpy as np
    import torch

    from position_induced_transformer_torch.ops.locality import quantile_threshold

    to = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()
    q, k, v = (to(rng.standard_normal((B, L, H, V))) for _ in range(3))
    g = to(rng.standard_normal((B, L, H * V)))
    thr = scale = None
    if kind != "self":
        lim = float(np.sqrt(6.0 / (2 * H)))
        scale = torch.tan(to(rng.uniform(-lim, lim, H)))
        dist = to(rng.random((L, L))) if dist is None else dist
        if kind in ("local", "empty"):
            locality = 10.0 if locality is None else locality
        if locality is not None and locality <= 100:
            thr = quantile_threshold(dist * scale.reshape(-1, 1, 1), locality / 100.0)[..., 0]
        if kind == "empty":
            thr[:, ::2] = -1e30
    return q, k, v, g, dist, thr, scale


def dotatt_work(case):
    """Kept entries over the batch and heads, and the bytes each entry
    point must move: every input read once, every output written once."""
    import torch

    q, k, v, g, dist, thr, scale = case
    B, L, H, V = q.shape
    kept = H * L * L if thr is None else int((dist * scale.reshape(-1, 1, 1) <= thr[:, :, None]).sum())
    kept *= B
    act = B * L * H * V  # one of q, k, v, out, g and each gradient
    geo = 0 if dist is None else L * L + H + (H * L if thr is not None else 0)
    stats, delta = 2 * B * H * L, B * H * L
    return kept, {
        "fwd": 4 * (3 * act + act + stats + geo),
        "dq": 4 * (5 * act + stats + geo + act + delta + (H if dist is not None else 0)),
        "dkdv": 4 * (4 * act + stats + delta + geo + 2 * act),
    }


def dotatt_sdpa(case):
    """One SDPA call computing the forward: (B, H, L, V) q, k, v and, for a
    hybrid op, the distance bias (masked entries -inf) as ``attn_mask``."""
    import torch
    import torch.nn.functional as F

    q, k, v, _, dist, thr, scale = case
    qs, ks, vs = (t.permute(0, 2, 1, 3).contiguous() for t in (q, k, v))
    mask = None
    if dist is not None:
        scaled = dist * scale.reshape(-1, 1, 1)
        mask = -scaled if thr is None else torch.where(scaled <= thr[:, :, None], -scaled,
                                                       float("-inf"))
        mask = torch.where(torch.isinf(mask).all(-1, keepdim=True), 0.0, mask)[None]
    return lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)


def dotatt_check(name, case, timed, reps=5, per_rep=4):
    """#14's three entry points against their plain versions on one op:
    the forward with its statistics, dq with delta and (hybrid) dscale,
    dk and dv, each run twice to the same bits; outputs at the op
    tolerances, dq, dk and dv on their terms' magnitude, dscale normalised.
    With ``timed``, each timed beside its plain version, the bound (the
    operations of the kept entries, or bytes) and, for the forward, SDPA.
    Returns the row."""
    import torch

    from position_induced_transformer_torch.kernels import dotatt as kd

    q, k, v, g, dist, thr, scale = case
    out, stats = kd.dotatt_cuda(q, k, v, dist, thr, scale)
    dq, delta, ds = kd.dotatt_bwd_dq_cuda(q, k, v, out, g, stats, dist, thr, scale)
    dk, dv = kd.dotatt_bwd_dkdv_cuda(q, k, v, g, stats, delta, dist, thr, scale)
    again = (kd.dotatt_cuda(q, k, v, dist, thr, scale)[0],
             *kd.dotatt_bwd_dq_cuda(q, k, v, out, g, stats, dist, thr, scale)[::2],
             *kd.dotatt_bwd_dkdv_cuda(q, k, v, g, stats, delta, dist, thr, scale))
    torch.cuda.synchronize()
    for part, first, second in zip(("forward", "dq", "dscale", "dk", "dv"), (out, dq, ds, dk, dv),
                                   again):
        if not (first is None and second is None) and not torch.equal(first, second):
            fail(f"{name}: two {part} runs on the same inputs differ")
    args = (q, k, v, g, dist, thr, scale)
    B, L, H, V = q.shape
    want = kd.dotatt_reference(q, k, v, dist, thr, scale)
    errs = {"fwd": check_close(f"{name} forward", out, want, OP_RTOL, OP_ATOL)}
    st = kd.dotatt_stats_reference(q, k, dist, thr, scale)
    errs["stats"] = max(check_close(f"{name} stats m", stats[0], st[0], OP_RTOL, OP_ATOL),
                        check_close(f"{name} stats l", stats[1], st[1], OP_RTOL, OP_ATOL))
    errs["delta"] = check_close(f"{name} delta", delta, kd.dotatt_bwd_delta_reference(want, g, H),
                                OP_RTOL, OP_ATOL,
                                kd.dotatt_bwd_delta_reference(want.abs(), g.abs(), H))
    sizes = kd.dotatt_bwd_term_sizes(*args)
    for part, got, ref, size in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                    (kd.dotatt_bwd_dq_reference, kd.dotatt_bwd_dk_reference,
                                     kd.dotatt_bwd_dv_reference), sizes):
        errs[part] = check_close(f"{name} {part}", got, ref(*args), OP_RTOL, OP_ATOL, size)
    del sizes
    if dist is not None:
        want_ds = kd.dotatt_bwd_dscale_reference(*args)
        norm = want_ds.abs().max() + 1.0
        check_close(f"{name} dscale (normalised)", ds / norm, want_ds / norm, DS_RTOL, DS_ATOL)
        errs["dscale"] = (ds - want_ds).abs().max().item()
    row = {"shape": name, "B": B, "L": L, "H": H, "V": V,
           "kind": "self" if dist is None else ("local" if thr is not None else "global"),
           "max_abs_err": errs}
    if not timed:
        return row
    kept, nbytes = dotatt_work(case)
    flops = {"fwd": 4 * V * kept, "dq": 6 * V * kept + 2 * B * L * H * V,
             "dkdv": 8 * V * kept}
    launch = {
        "fwd": lambda: kd.dotatt_cuda(q, k, v, dist, thr, scale),
        "dq": lambda: kd.dotatt_bwd_dq_cuda(q, k, v, out, g, stats, dist, thr, scale),
        "dkdv": lambda: kd.dotatt_bwd_dkdv_cuda(q, k, v, g, stats, delta, dist, thr, scale),
    }

    def plain_dkdv():
        kd.dotatt_bwd_dk_reference(*args)
        kd.dotatt_bwd_dv_reference(*args)

    plain = {
        "fwd": lambda: kd.dotatt_reference(q, k, v, dist, thr, scale),
        "dq": lambda: (kd.dotatt_bwd_dq_reference(*args),
                       None if dist is None else kd.dotatt_bwd_dscale_reference(*args)),
        "dkdv": plain_dkdv,
    }
    row["kept_entries"] = kept
    for part in ("fwd", "dq", "dkdv"):
        bound_ms, bound_by = roofline(flops[part], nbytes[part])
        row[part] = {"ms": cuda_ms(launch[part], reps=reps, per_rep=per_rep),
                     "plain_ms": cuda_ms(plain[part], reps=reps, per_rep=per_rep),
                     "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops[part],
                     "bytes": nbytes[part], "library_ms": None}
        row[part]["tflops"] = flops[part] / row[part]["ms"] / 1e9
    sdpa = dotatt_sdpa(case)
    row["fwd"]["library_max_abs_err"] = (
        sdpa().permute(0, 2, 1, 3).reshape(B, L, -1) - want).abs().max().item()
    row["fwd"]["library_ms"] = cuda_ms(sdpa, reps=reps, per_rep=per_rep)
    del sdpa
    return row


def dotatt_function_check(name, case):
    """One forward + backward through ``dot_attention`` launches each entry
    point once; its gradients in q, k, v and the scales against
    torch.autograd of the plain version (normalised as dscale)."""
    import torch

    from position_induced_transformer_torch.kernels import dotatt as kd

    q, k, v, g, dist, thr, scale = case

    def grads(fn):
        leaves = [a.clone().requires_grad_(True) for a in (q, k, v)]
        s = None if scale is None else scale.clone().requires_grad_(True)
        out = fn(*leaves, dist, thr, s)
        (out * g).sum().backward()
        return [out.detach()] + [a.grad for a in leaves] + ([] if s is None else [s.grad])

    before = counts()
    got = grads(kd.dot_attention)
    torch.cuda.synchronize()
    diff = {k_: n - before[k_] for k_, n in counts().items()}
    if diff != {k_: int(k_ in DOTATT_KERNELS) for k_ in diff}:
        fail(f"{name}: one forward + backward launched {diff}, expected 1 each of {DOTATT_KERNELS}")
    want = grads(plain_dotatt)
    err = 0.0
    for part, a, b in zip(("out", "dq", "dk", "dv", "dscale"), got, want):
        norm = b.abs().max() + 1.0
        check_close(f"{name} Function {part} (normalised)", a / norm, b / norm, DS_RTOL, DS_ATOL)
        err = max(err, (a - b).abs().max().item())
    return err


def dotatt_op_case(rng, name, problems):
    """The arguments of one of DOTATT_OPS: the config's widths, the hybrid
    ops' distances from its setup (``problems``: config -> Problem)."""
    from position_induced_transformer_torch import configs

    config, variant, op, B, _ = DOTATT_OPS[name]
    m = configs.get(config).model
    H, V = m.n_head, m.hid_dim // m.n_head
    if op == "self":
        if config == "elasticity_tf":
            L = 972
        else:
            geom = problems[config].geom
            L = (geom.m_ltt if variant == "lite" else geom.m_cross).shape[0]
        return dotatt_case(rng, B, L, H, V, "self")
    geom = problems[config].geom
    dist, loc = {"down": (geom.m_cross_t, m.en_loc), "processor": (geom.m_ltt, 200.0),
                 "up": (geom.m_cross, m.de_loc)}[op]
    return dotatt_case(rng, B, dist.shape[0], H, V, "local" if loc <= 100 else "global", dist, loc)


def dotatt_kernel_phase():
    """#14's forward, dq (with delta and dscale) and dk/dv against their
    plain versions at every self and hybrid op of the variants at full
    width (DOTATT_OPS: the hybrid ops on burgers_tf's own distances and
    in-call thresholds) and at ragged shapes (L 1 to 1849, V 16 to 256 and
    21, 1 to 8 heads, rows that keep nothing); each full-width op timed
    beside its plain version, the bound and SDPA; the autograd Function's
    gradients against autograd of the plain version, one forward +
    backward launching each entry point once."""
    import numpy as np
    import torch

    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.train import benchmarks

    rng = np.random.default_rng(14)
    problems = {}
    for name in TF_FIXED_CONFIGS:
        cfg = configs.get(name)
        problems[name] = benchmarks.setup(cfg, ntrain=cfg.batch_size, ntest=2, device="cuda")
    rows, fn_err = [], 0.0
    for name in DOTATT_OPS:
        config, variant, op, _, per_forward = DOTATT_OPS[name]
        case = dotatt_op_case(rng, name, problems)
        big = name == "naca_tf_transformer"
        row = dotatt_check(name, case, timed=True, reps=3 if big else 5, per_rep=2 if big else 4)
        row.update(config=config, variant=variant, op=op, launches_per_forward=per_forward)
        rows.append(row)
        log(f"kernel dotatt {name}: {json.dumps(row)}")
        log(f"#14 {name} (B {row['B']}, L {row['L']}, H {row['H']}, V {row['V']}, {row['kind']}): "
            + "; ".join(f"{p} {row[p]['ms']:.4f} ms (plain {row[p]['plain_ms']:.4f}, bound "
                        f"{row[p]['bound_ms']:.4f}, {row[p]['tflops']:.2f} TFLOP/s)"
                        for p in ("fwd", "dq", "dkdv"))
            + f"; SDPA {row['fwd']['library_ms']:.4f}")
        if name in ("burgers_tf_self", "burgers_tf_selfpit_down", "burgers_tf_selfpit_processor"):
            fn_err = max(fn_err, dotatt_function_check(name, case))
        del case
        torch.cuda.empty_cache()
    del problems
    ragged_err = {}
    for name, B, L, H, V, kind in DOTATT_RAGGED:
        case = dotatt_case(rng, B, L, H, V, kind)
        row = dotatt_check(name, case, timed=False)
        ragged_err[name] = row["max_abs_err"]
        if name in ("dot_l17_h3_v16_local", "dot_l100_h3_v21"):
            fn_err = max(fn_err, dotatt_function_check(name, case))
        log(f"kernel dotatt {name}: {json.dumps(row)}")
    log(f"DotAtt: gradients match autograd of the plain version, max abs err {fn_err:.3e}")
    return rows, ragged_err, fn_err


def variant_launches(name, variant, mode="step"):
    """Launches of #13 (or the point-cloud coders' kernels) and #14 by a
    TF configuration's variant per training step (``mode`` "step"), per
    evaluated batch ("eval") or per served batch ("serve"): each entry
    point once per op of its kind; a rollout runs its ops once a rollout
    step and, in training under remat ``full``, its forwards twice.
    elasticity_tf's coders take #11/#12 where the batch carries
    thresholds (training, evaluation) and #9 where it does not (serving)."""
    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.train import benchmarks

    cfg = configs.get(name)
    pa, ca = benchmarks._VARIANT_ATTENTION[variant]
    coders = 2 if name == "elasticity_tf" else 2 + int(benchmarks.TF_FIXED[name][1])
    ops = {"position": 0, "self": 0, "hybrid": 0}
    ops[pa] += cfg.model.n_blocks
    ops[ca] += coders
    steps = VARIANT_ROLLOUT if name == "vorticity_tf" else 1
    fwd_again = 2 if name == "vorticity_tf" and mode == "step" else 1
    kinds = TF_FIXED_KERNELS
    if name == "elasticity_tf":
        kinds = ("posatt_tf_fwd",) if mode == "serve" else TF_COORD_KERNELS
    out = {}
    for n, names in ((ops["position"] * steps, kinds),
                     ((ops["self"] + ops["hybrid"]) * steps, DOTATT_KERNELS)):
        if n:
            out[names[0]] = n * fwd_again
            if mode == "step":
                out.update({k: n for k in names[1:]})
    return out


# vorticity_tf's variants train by BPTT cut to 3 rollout steps (of 20)
VARIANT_ROLLOUT = 3


def nonneg_recorder():
    """A patch of ``benchmarks.nonneg_bandwidths`` recording the smallest
    band_width after each projection (each optimizer step), and that
    list."""
    from position_induced_transformer_torch.train import benchmarks

    project, lows = benchmarks.nonneg_bandwidths, []

    def recording(model):
        project(model)
        lows.append(min(float(p.detach().min()) for n, p in model.named_parameters()
                        if n.endswith("band_width")))

    return mock.patch.object(benchmarks, "nonneg_bandwidths", recording), lows


def variant_train_phase(name, variant, epochs, ntrain, ntest, refs, timing=True):
    """runner.train(name, model_variant=variant) at full width and depth
    through fixed_train_phase: the variant's launches per step and per eval
    batch, losses and weights against a plain-attention card run (and a
    CPU run where ``refs`` names it); selfpit's band_widths at or above 0
    after every step; with ``timing``, the time per step and the device's
    busy share. Returns the report and the checkpoint."""
    from position_induced_transformer_torch import configs

    cfg = configs.get(name)
    ckpt = str(REPO / "build" / "chip_smoke" / f"{name}_{variant}.pt")
    patch, lows = nonneg_recorder()
    with patch:
        report = fixed_train_phase(
            f"{name} {variant} train", cfg, epochs, ntrain, ntest, variant_launches(name, variant),
            refs=refs, plain_patch=plain_variant_attention,
            per_eval_batch=variant_launches(name, variant, "eval"),
            groups={**TF_FIXED_GROUPS, **DOTATT_GROUPS}, timing=timing, checkpoint_path=ckpt,
            model_variant=variant)
    if variant == "selfpit":
        steps = report["steps"]
        if len(lows) < steps or min(lows[:steps]) < 0:
            fail(f"{name} selfpit train: band_width minima after the steps {lows[:steps]}")
        report["min_band_width_after_each_step"] = lows[:steps]
    report["model_variant"] = variant
    return report, ckpt


def variant_evaluate_phase(name, variant, ckpt, ntrain, ntest, **kw):
    """``evaluate(name, ckpt, model_variant=variant, **kw)`` on the card:
    the variant's forwards per evaluated batch and no other kernel; its
    metrics against a plain-attention card run at rtol 1e-4."""
    import dataclasses

    import torch

    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.train import evaluate

    cfg = configs.get(name)
    ev_cfg = dataclasses.replace(cfg, ntrain=ntrain)  # the trained split's size
    per_batch = variant_launches(name, variant, "eval")
    batches = -(-ntest // (cfg.eval_batch_size or cfg.batch_size))
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = evaluate.evaluate(ev_cfg, ckpt, ntest=ntest, device="cuda", model_variant=variant, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = counts()
    expected = {k: per_batch.get(k, 0) * batches for k in launched}
    if launched != expected:
        fail(f"{name} {variant} evaluate: launched {launched}, expected {expected}")
    with plain_variant_attention():
        t0 = time.perf_counter()
        want = evaluate.evaluate(ev_cfg, ckpt, ntest=ntest, device="cuda", model_variant=variant,
                                 **kw)
        plain_s = time.perf_counter() - t0
    if counts() != launched:
        fail(f"{name} {variant} evaluate: the plain-attention evaluation launched a kernel")
    keys = [k for k, v in got.items() if isinstance(v, (float, list)) and k != "rel_l1_quartiles"]
    f64 = lambda v: torch.tensor(v, dtype=torch.float64)
    err = max(check_close(f"{name} {variant} evaluate {k} vs plain on CUDA", f64(got[k]),
                          f64(want[k]), 1e-4, 0.0) for k in keys)
    return {"config": name, "model_variant": variant, "options": kw, "launches": launched,
            "evaluate_s_cuda": seconds, "evaluate_s_plain_cuda": plain_s,
            "max_abs_err_vs_plain_cuda": err, "metrics": got}


def variant_inputs(cfg, n):
    """``n`` raw inputs of a TF configuration, as a request carries them."""
    if cfg.name == "elasticity_tf":
        from position_induced_transformer_torch.data import synthetic

        return synthetic.elasticity(n=n, seed=1)[0]
    return tf_fixed_inputs(cfg, n)


def variant_serve_phase(name, variant, ckpt, bitwise=True):
    """make_server(name, model_variant=variant) on the trained checkpoint
    through fixed_serve_phase (1, 3, 5 samples, 2 concurrent, 4 warm whole
    batches): the variant's forwards per device batch and nothing else,
    every reply equal to ``infer``'s to the bit and within the model
    bounds of a plain-attention card run and (2 samples) a CPU run."""
    from position_induced_transformer_torch import configs

    cfg = configs.get(name)
    x = variant_inputs(cfg, (cfg.eval_batch_size or cfg.batch_size) + 12)
    return fixed_serve_phase(f"{name}_{variant}_serve", cfg, ckpt, x,
                             variant_launches(name, variant, "serve"), (1, 3, 5), 2, 4,
                             cpu_samples=2, plain_patch=plain_variant_attention,
                             groups={**TF_FIXED_GROUPS, **DOTATT_GROUPS}, model_variant=variant,
                             bitwise=bitwise)


def variant_step_serve_phase(name, variant):
    """One training step of a TF configuration's variant at full width and
    depth (vorticity_tf's BPTT cut to VARIANT_ROLLOUT rollout steps) and one
    served batch of its checkpoint through make_server: the variant's
    launches for each; the step's loss and weights and the served reply
    against a plain-attention card run (vorticity_tf's weights at
    VORTICITY_PARAM_ATOL: one Adam step of BPTT moves a near-zero gradient's
    weight by up to 2 lr, the gap scripts/torch_bptt_gap.py measures between
    two float32 programs), except naca_tf's transformer at batch 8, whose
    plain version cannot hold its (8, 2, 11271, 11271) weights: its parity
    rests on the batch-1 kernel phase; the step's peak device memory. A
    served rollout (vorticity_tf) is held to a float64 run of the plain
    version on the card: at most twice as far from it as the plain float32
    card run is, or the model bounds where they are larger. The
    random-weight self-attention's logits reach a few thousand, whose
    float32 rounding alone moves a weight by about 1e-4, and the 3 fed-back
    steps amplify it: the plain card run and a plain CPU run of the same
    weights parted by 0.105 (lite) and 2.74 (transformer) on one sample
    of 8 and by under 0.005 on most (an NVIDIA H100 80GB HBM3 at 700 W)."""
    import dataclasses

    import numpy as np
    import torch

    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.train import benchmarks, checkpoint, evaluate, loop, runner
    from position_induced_transformer_torch.train.serve import make_server

    cfg = dataclasses.replace(configs.get(name), model_variant=variant)
    if name == "vorticity_tf":
        cfg = dataclasses.replace(cfg, rollout_steps=VARIANT_ROLLOUT)
    dev = torch.device("cuda")
    plain_ok = not (name == "naca_tf" and variant == "transformer")
    label = f"{name} {variant}"

    def one_step(patch=None):
        problem = benchmarks.setup(cfg, ntrain=cfg.batch_size, ntest=2, device=dev)
        state = runner.init_state(problem, 0)
        data = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in problem.train_data.items()}
        perm = torch.arange(cfg.batch_size, device=dev).reshape(1, -1)
        zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with patch or nullcontext():
            _, losses = loop.make_train_epoch(problem.task, lambda step: cfg.lr)(
                state, problem.geom, data, perm)
        torch.cuda.synchronize()
        return (problem, losses.cpu(), {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
                counts(), time.perf_counter() - t0, torch.cuda.max_memory_allocated())

    problem, losses, weights, launched, step_s, peak = one_step()
    expected = {k: variant_launches(name, variant).get(k, 0) for k in launched}
    if launched != expected or not torch.isfinite(losses).all():
        fail(f"{label} step: launched {launched}, expected {expected}; loss {losses.tolist()}")
    report = {"config": name, "model_variant": variant, "rollout_steps": cfg.rollout_steps,
              "batch": cfg.batch_size, "launches_step": launched, "step_s_first": step_s,
              "max_memory_allocated_step_bytes": peak, "loss": losses.tolist()}
    if plain_ok:
        _, ref_losses, ref_weights, ref_launched, ref_s, ref_peak = one_step(plain_variant_attention())
        if any(ref_launched.values()):
            fail(f"{label} step: the plain card run launched kernels: {ref_launched}")
        atol = VORTICITY_PARAM_ATOL if name == "vorticity_tf" else PARAM_ATOL
        report["max_abs_err_step_loss_vs_plain_cuda"] = check_close(
            f"{label} step loss vs plain_cuda", losses, ref_losses, LOSS_RTOL, 0.0)
        report["max_abs_err_weights_vs_plain_cuda"] = max(
            check_close(f"{label} step weight {k} vs plain_cuda", v, ref_weights[k], PARAM_RTOL, atol)
            for k, v in weights.items())
        report["max_memory_allocated_step_bytes_plain_cuda"] = ref_peak
    ckpt = checkpoint.save(str(REPO / "build" / "chip_smoke" / f"{name}_{variant}_step.pt"),
                           weights, cfg.name)
    del problem
    torch.cuda.empty_cache()
    server = make_server(cfg, ckpt, host="127.0.0.1", port=0, verbose=False, device="cuda",
                         model_variant=variant)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    bs = server.predictor._batch_size()
    x = variant_inputs(cfg, bs)
    try:
        zero_counts()
        calls0 = server.batcher.n_calls
        t0 = time.perf_counter()
        code, body = post(f"http://127.0.0.1:{server.server_address[1]}/predict", npy(x))
        serve_ms = (time.perf_counter() - t0) * 1e3
        served_launched = counts()
        device_calls = server.batcher.n_calls - calls0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if code != 200:
        fail(f"{label} serve: HTTP {code}: {body[:500]!r}")
    per_batch = variant_launches(name, variant, "serve")
    expected = {k: per_batch.get(k, 0) * device_calls for k in served_launched}
    if served_launched != expected or device_calls != 1:
        fail(f"{label} serve: {served_launched} for {device_calls} device batches, expected {expected}")
    got = torch.from_numpy(np.load(io.BytesIO(body)))
    if not torch.isfinite(got).all():
        fail(f"{label} serve: non-finite reply")
    report.update(serve_samples=int(x.shape[0]), serve_ms=serve_ms, launches_serve=served_launched)
    if plain_ok:
        predictor = server.predictor
        with plain_variant_attention():
            ref = torch.from_numpy(predictor.predict_array(
                {"x": evaluate._prepare_inputs(predictor.problem, x)}, cfg.rollout_steps))
        if cfg.rollout_steps:
            exact = float64_rollout(predictor, x, cfg.rollout_steps).cpu()
            per_sample = lambda a: (a.double() - exact).abs().flatten(1).amax(1)
            plain_gap, kernel_gap = per_sample(ref), per_sample(got)
            atol = max(2.0 * plain_gap.max().item(), model_atol(cfg.rollout_steps, exact))
            report.update(plain_cuda_vs_float64_per_sample=plain_gap.tolist(),
                          kernel_vs_float64_per_sample=kernel_gap.tolist())
            report["max_abs_err_serve_vs_float64"] = check_close(
                f"{label} serve vs float64 plain on CUDA", got, exact, MODEL_RTOL, atol)
        else:
            report["max_abs_err_serve_vs_plain_cuda"] = check_close(
                f"{label} serve vs plain on CUDA", got, ref, MODEL_RTOL,
                model_atol(cfg.rollout_steps, ref))
    del server
    torch.cuda.empty_cache()
    return report


def float64_rollout(predictor, x, steps):
    """The predictor's model rolled out ``steps`` steps from the raw inputs
    ``x`` in float64 on its device (weights, geometry and inputs converted,
    each exactly), every attention op on its plain version: (n, L, out,
    steps)."""
    import copy
    import dataclasses

    import torch

    from position_induced_transformer_torch.train import evaluate

    problem = predictor.problem
    task = dataclasses.replace(problem.task, model=copy.deepcopy(problem.model).double())
    geom = type(problem.geom)(*(None if t is None else t.double() for t in problem.geom))
    xx = torch.from_numpy(evaluate._prepare_inputs(problem, x)).double().to(predictor.device)
    with torch.no_grad(), plain_variant_attention():
        out = task.rollout(geom, xx, steps)
    del task
    return out


def variant_cli_phase(ckpt):
    """The command line with ``--model-variant selfpit`` as subprocesses on
    the card, started at once: ``train --benchmark burgers_tf`` (1 epoch of
    2 steps, ``--checkpoint``), and on the selfpit checkpoint of the
    burgers_tf phase ``infer`` of a raw .npy and ``serve`` answering one
    ``POST /predict`` (its /info naming the variant); the served reply
    equal to infer's to the bit and both within the model bounds of an
    in-process Predictor. Every process exits 0 and is stopped when the
    phase ends."""
    import signal

    import numpy as np
    import torch

    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.train import checkpoint, evaluate

    out = REPO / "build" / "chip_smoke" / "cli_variant"
    out.mkdir(parents=True, exist_ok=True)
    trained, inp, pred_path = (str(out / f) for f in ("selfpit.pt", "x.npy", "pred.npy"))
    cfg = configs.BURGERS_TF
    x = tf_fixed_inputs(cfg, 3)
    np.save(inp, x)
    variant = ["--model-variant", "selfpit"]
    common = ["--benchmark", "burgers_tf", *variant, "--set", "ntrain=10"]
    procs, seconds = {}, {}

    def start(label, *argv):
        procs[label] = (subprocess.Popen(
            [sys.executable, "-m", "position_induced_transformer_torch", *argv], cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), time.perf_counter())

    def finish(label, timeout=600):
        proc, t0 = procs[label]
        stdout, stderr = proc.communicate(timeout=timeout)
        seconds[label] = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"cli {label}: exit {proc.returncode}: {stderr[-3000:]}")
        return stdout

    port = free_port()
    try:
        start("serve", "serve", *common, "--checkpoint", ckpt, "--port", str(port))
        start("train", "train", "--benchmark", "burgers_tf", *variant, "--epochs", "1",
              "--ntrain", "10", "--ntest", "10", "--checkpoint", trained)
        start("infer", "infer", *common, "--checkpoint", ckpt, "--input", inp, "--output",
              pred_path)
        results = {k: finish(k) for k in ("train", "infer")}
        url = f"http://127.0.0.1:{port}"
        t0 = time.perf_counter()
        while True:
            if procs["serve"][0].poll() is not None:
                finish("serve")
                fail("cli serve: the server exited before answering")
            try:
                with urllib.request.urlopen(f"{url}/info", timeout=5) as r:
                    info = json.loads(r.read())
                    break
            except (urllib.error.URLError, ConnectionError, TimeoutError):
                pass
            if time.perf_counter() - t0 > 300:
                fail("cli serve: no /info reply within 300 s")
            time.sleep(0.5)
        code, body = post(f"{url}/predict", npy(x))
        procs["serve"][0].send_signal(signal.SIGINT)
        finish("serve", timeout=60)
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if code != 200:
        fail(f"cli selfpit serve: HTTP {code}: {body[:500]!r}")
    if info.get("model_variant") != "selfpit":
        fail(f"cli selfpit serve: /info {info}")
    served = np.load(io.BytesIO(body))
    by_infer = np.load(pred_path)
    if not np.array_equal(served, by_infer):
        fail("cli selfpit: the served reply differs from infer's bits")
    final = json.loads(results["train"].splitlines()[-1])["final"]
    state = checkpoint.restore(ckpt)["state_dict"]
    if not all(np.isfinite(v) for v in final.values()) or set(
            checkpoint.restore(trained)["state_dict"]) != set(state):
        fail(f"cli selfpit train: {final}")
    predictor = evaluate.Predictor("burgers_tf", ckpt, device="cuda", model_variant="selfpit")
    want = torch.from_numpy(predictor.predict_array({"x": x}))
    err = check_close("cli selfpit infer vs in-process", torch.from_numpy(by_infer), want,
                      MODEL_RTOL, MODEL_ATOL)
    return {"seconds": seconds, "train_final": final, "info": info,
            "served_equals_infer_bitwise": True, "max_abs_err_infer_vs_in_process": err}


# name -> (variants, training split, test split, reference runs, step timing):
# 2 epochs each at full width (cut from ~1000 samples and 500 epochs)
VARIANT_TRAIN = {
    "burgers_tf": (("lite", "transformer", "selfpit"), 10, 10, ("plain_cuda", "cpu")),
    "elasticity_tf": (("lite", "transformer"), 20, 10, ("plain_cuda",)),
    "darcy_tf": (("lite",), 16, 8, ("plain_cuda", "cpu")),
}
# one step and one served batch each
VARIANT_STEP = (("sod_tf", "lite"), ("sod_tf", "transformer"), ("vorticity_tf", "lite"),
                ("vorticity_tf", "transformer"), ("naca_tf", "lite"), ("naca_tf", "transformer"))


def variant_phases():
    """The TF ablation variants at full width: burgers_tf lite /
    transformer / selfpit and elasticity_tf lite / transformer trained,
    evaluated and served; darcy_tf lite trained at 43^2 and evaluated at
    421^2 (ZSSR); sod_tf, vorticity_tf and naca_tf lite / transformer one
    step and one served batch each; the selfpit command line. Returns
    path -> report."""
    import dataclasses

    from position_induced_transformer_torch import configs

    reports, ckpts = {}, {}
    for name, (variants, ntrain, ntest, refs) in VARIANT_TRAIN.items():
        for variant in variants:
            label = f"{name}_{variant}"
            timing = variant == "transformer"  # the step the kernel record sums
            train, ckpt = variant_train_phase(name, variant, 2, ntrain, ntest, refs, timing=timing)
            ckpts[label] = ckpt
            if name == "elasticity_tf":  # the CPU takes seconds a full-width step
                cfg = dataclasses.replace(configs.ELASTICITY_TF, model_variant=variant)
                card_losses, card_weights, _ = first_steps(cfg, "cuda", 1, ntrain, ntest, 2)
                check_close(f"{label} first step vs the full run", card_losses,
                            card_losses.new_tensor(train["step_losses_first_last"][:1]),
                            LOSS_RTOL, 0.0)
                cpu_losses, cpu_weights, cpu_launched = first_steps(cfg, "cpu", 1, ntrain, ntest, 2)
                if any(cpu_launched.values()):
                    fail(f"{label}: the CPU run launched kernels: {cpu_launched}")
                train["max_abs_err_step_loss_vs_cpu"] = check_close(
                    f"{label} first step loss vs cpu", card_losses, cpu_losses, LOSS_RTOL, 0.0)
                train["max_abs_err_weights_vs_cpu"] = max(
                    check_close(f"{label} weight {k} vs cpu", v, cpu_weights[k], PARAM_RTOL,
                                PARAM_ATOL) for k, v in card_weights.items())
                train["cpu_steps_compared"] = 1
            log(f"{label}_train " + json.dumps(train))
            reports[f"{label}_train"] = train
            if name == "darcy_tf":
                ev = variant_evaluate_phase(name, variant, ckpt, ntrain, ntest, zssr=True)
            else:
                ev = variant_evaluate_phase(name, variant, ckpt, ntrain, ntest)
            log(f"{label}_evaluate " + json.dumps(ev))
            reports[f"{label}_evaluate"] = ev
            if name != "darcy_tf":
                serve = variant_serve_phase(name, variant, ckpt)
                log(f"{label}_serve " + json.dumps(serve))
                reports[f"{label}_serve"] = serve
    for name, variant in VARIANT_STEP:
        rep = variant_step_serve_phase(name, variant)
        log(f"{name}_{variant}_step_serve " + json.dumps(rep))
        reports[f"{name}_{variant}_step_serve"] = rep
    cli = variant_cli_phase(ckpts["burgers_tf_selfpit"])
    log("cli_selfpit " + json.dumps(cli))
    reports["cli_selfpit"] = cli
    return reports


# each entry point's outputs in a check's errors
ERR_KEYS = {"fwd": ("fwd", "stats"), "dq": ("dq", "delta", "dscale"), "dkdv": ("dk", "dv")}


def variant_launch_paths(reports):
    """path -> the launches counted on it, from the variant phases'
    reports (a step-and-serve report gives two paths)."""
    by_path = {}
    for path, rep in reports.items():
        for key in ("launches", "launches_step", "launches_serve"):
            if key in rep:
                by_path[path + ("" if key == "launches" else key[len("launches"):])] = rep[key]
    return by_path


def dotatt_entries(rows, ragged_err, fn_err, reports):
    """The kernels-record entries of #14's three entry points: launches by
    path (the variant phases' reports), the largest error, and times,
    bounds, plain and SDPA times summed over one burgers_tf transformer
    training step (7 launches of each at batch 5); ``per_config`` the same
    over one elasticity_tf transformer step (6 at batch 10) and each
    variant op's forward, ``shapes`` each op's row."""
    by_path = variant_launch_paths(reports)
    entries = []
    for name, part in zip(DOTATT_KERNELS, ("fwd", "dq", "dkdv")):
        def summed(op_names, part=part):
            ops = [r for r in rows if r["shape"] in op_names]
            total = lambda key: sum(r[part][key] * r["launches_per_forward"] for r in ops)
            by = {kind: sum(r[part]["bound_ms"] * r["launches_per_forward"] for r in ops
                            if r[part]["bound_by"] == kind) for kind in ("operations", "bytes")}
            return {"ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
                    "bound_by": max(by, key=by.get),
                    "library_ms": total("library_ms") if part == "fwd" else None}

        launches = {p: v.get(name, 0) for p, v in by_path.items() if v.get(name, 0)}
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "position_induced_transformer_torch/kernels/csrc/"
                      + ("dotatt_fwd.cu" if part == "fwd" else "dotatt_bwd.cu"),
            "replaces": "position_induced_transformer_tpu/models/pit_tf.py:181 and :254 "
                        "(XLA, no pallas_call)",
            "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": max(e.get(key, 0.0) for e in [r["max_abs_err"] for r in rows]
                               + list(ragged_err.values()) for key in ERR_KEYS[part]),
            **summed(("burgers_tf_self",)),
            "per_config": {"elasticity_tf_transformer_step": summed(("elasticity_tf_self",)),
                           **{r["shape"]: summed((r["shape"],)) for r in rows}},
            "function_max_abs_err": fn_err,
            "shapes": [{k: v for k, v in r.items() if k not in ("fwd", "dq", "dkdv")} | r[part]
                       for r in rows],
        })
    return entries


def schedule_entry(version, rows, launched):
    """The kernels-record entry of one schedule: times and bounds summed
    over the seven launches of a Burgers forward (1 encoder + 5 processor
    + 1 decoder, as #1's entry), per-shape rows under ``shapes``."""
    name = SCHEDULE_VERSIONS[version]
    burgers = [r for r in rows if r["launches_per_burgers_forward"]]
    total = lambda f: sum(f(r) * r["launches_per_burgers_forward"] for r in burgers)
    by = {kind: total(lambda r: r["bound_ms"] * (r["bound_by"] == kind))
          for kind in ("operations", "bytes")}
    per_shape = [{k: v for k, v in r.items() if k != "versions"} | r["versions"][str(version)]
                 for r in rows]
    return {
        "name": name,
        "route": "cuda",
        "source": "position_induced_transformer_torch/kernels/csrc/posatt_fixed_fwd.cu",
        "replaces": "position_induced_transformer_tpu/kernels/posatt_pallas.py:"
                    + {1: "133", 2: "233", 3: "341"}[version],
        "launches": launched[name],
        # no model path sets the version: the phase's calls of
        # position_attention_fixed(version=...) are the path
        "launches_by_path": {"kernel_api": launched[name]},
        "max_abs_err": max(r["max_abs_err"] for r in per_shape),
        "ms": total(lambda r: r["versions"][str(version)]["ms"]),
        "plain_ms": total(lambda r: r["plain_ms"]),
        "bound_ms": total(lambda r: r["bound_ms"]),
        "bound_by": max(by, key=by.get),
        "library_ms": total(lambda r: r["library_ms"]),
        "shapes": per_shape,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import position_induced_transformer_torch as port  # fails outside the repo

    if Path(port.__file__).resolve().parents[1] != REPO:
        fail(f"the port was imported from {port.__file__}, not from this checkout")

    t_start = time.perf_counter()
    stamp = lambda label: log(f"phase {label} done at {time.perf_counter() - t_start:.1f} s")
    environment()
    build()
    stamp("build")
    geom = geometry_phase()
    shapes, max_err = kernel_phase(geom)
    bwd_rows, bwd_errs, bwd_config_rows = backward_kernel_phase(geom)
    serve = serve_phase()
    log("serve " + json.dumps(serve))
    train = train_phase()
    log("train " + json.dumps(train))
    stamp("1-7 (burgers)")
    b_shapes, b_rows, b_err = batched_kernel_phase()
    b_bwd_rows, b_bwd_errs = batched_backward_phase(b_shapes)
    e_serve = elasticity_serve_phase()
    log("elasticity_serve " + json.dumps(e_serve))
    e_train = elasticity_train_phase()
    log("elasticity_train " + json.dumps(e_train))
    stamp("8-11 (elasticity)")
    tf_shapes, tf_fwd_rows, tf_errs = tf_kernel_phase()
    tf_bwd_rows, tf_bwd_errs = tf_backward_phase(tf_shapes)
    t_serve = elasticity_tf_serve_phase()
    log("elasticity_tf_serve " + json.dumps(t_serve))
    t_train = elasticity_tf_train_phase()
    log("elasticity_tf_train " + json.dumps(t_train))
    stamp("12-15 (elasticity_tf)")
    s_rows, s_launched, s_fn_errs, s_stats_rows = schedule_phase()
    v3 = schedule_entry(3, s_rows, s_launched)
    log("schedules " + json.dumps({
        "launches": s_launched, "function_max_abs_err": s_fn_errs,
        # #1 at this phase's Burgers shapes, beside #5 and #6
        "v3_per_burgers_forward": {k: v3[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
    }))
    stamp("16 (schedules)")
    d_train, darcy_ckpt = darcy_train_phase()
    log("darcy_train " + json.dumps(d_train))
    d_zssr = darcy_zssr_phase(darcy_ckpt, s_rows)
    log("darcy_zssr " + json.dumps(d_zssr))
    d_serve43, d_serve421 = darcy_serve_phases(darcy_ckpt)
    log("darcy_serve_43 " + json.dumps(d_serve43))
    log("darcy_serve_421 " + json.dumps(d_serve421))
    sod_serve, sod_train = sod_phases()
    log("sod_serve " + json.dumps(sod_serve))
    log("sod_train " + json.dumps(sod_train))
    stamp("17-20 (darcy, sod)")
    n_train, naca_ckpt = naca_train_phase()
    log("naca_train " + json.dumps(n_train))
    n_serve = naca_serve_phase(naca_ckpt)
    log("naca_serve " + json.dumps(n_serve))
    v_train, vorticity_ckpt = vorticity_train_phase(s_rows)
    log("vorticity_train " + json.dumps(v_train))
    v_eval, v_serve, v_horizon = vorticity_eval_serve_phases(vorticity_ckpt)
    log("vorticity_eval " + json.dumps(v_eval))
    log("vorticity_serve " + json.dumps(v_serve))
    log("vorticity_serve_horizon " + json.dumps(v_horizon))
    stamp("21-24 (naca, vorticity)")
    c_train, cylinder_ckpt, c_rows = cylinder_train_phase()
    log("cylinder_train " + json.dumps(c_train))
    c_eval = cylinder_eval_phase(cylinder_ckpt)
    log("cylinder_eval " + json.dumps(c_eval))
    c_serve, c_rollout = cylinder_serve_phases(cylinder_ckpt)
    log("cylinder_serve " + json.dumps(c_serve))
    log("cylinder_serve_rollout " + json.dumps(c_rollout))
    cli = cli_phase(cylinder_ckpt)
    log("cli " + json.dumps(cli))
    stamp("25-28 (cylinder, cli)")
    tff_rows, tff_ragged_errs, tff_fn_err = tf_fixed_kernel_phase()
    stamp("29 (#13)")
    tff = tf_fixed_phases()
    stamp("30-31 (tf fixed)")
    dot_rows, dot_ragged_errs, dot_fn_err = dotatt_kernel_phase()
    stamp("32 (#14)")
    variants = variant_phases()
    stamp("33-36 (variants)")
    fixed_paths = {  # the fixed-mesh model paths: (train, served or evaluated)
        "darcy_train": d_train["launches"], "darcy_zssr": d_zssr["launches"],
        "darcy_serve_43": d_serve43["launches"], "darcy_serve_421": d_serve421["launches"],
        "sod_train": sod_train["launches"], "sod_serve": sod_serve["launches"],
        "vorticity_train": v_train["launches"], "vorticity_serve": v_serve["launches"],
        "vorticity_eval": v_eval["launches"],
        "cylinder_train": c_train["launches"], "cylinder_eval": c_eval["launches"],
        "cylinder_serve": c_serve["launches"], "cylinder_serve_rollout": c_rollout["launches"],
    }
    naca_paths = {"naca_train": n_train["launches"], "naca_serve": n_serve["launches"],
                  "naca_shuffle_ablation": n_serve["shuffle_ablation"]["launches"]}

    def per_step(rows, launches_key):
        """Times and bounds summed over a step's launches, and what bounds
        the larger share of the bound."""
        step = lambda key: sum(r[key] * r[launches_key] for r in rows)
        by = {kind: sum(r["bound_ms"] * r[launches_key] for r in rows if r["bound_by"] == kind)
              for kind in ("operations", "bytes")}
        return {"ms": step("ms"), "plain_ms": step("plain_ms"), "bound_ms": step("bound_ms"),
                "bound_by": max(by, key=by.get)}

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
        "replaces": "position_induced_transformer_tpu/kernels/posatt_pallas.py:341",
        "launches": serve["launches"]["posatt_fixed_fwd"],
        "launches_by_path": {"serve": serve["launches"]["posatt_fixed_fwd"],
                             "train": train["launches"]["posatt_fixed_fwd"],
                             **{k: v["posatt_fixed_fwd"] for k, v in fixed_paths.items()}},
        "max_abs_err": max_err,
        # times and bounds: one Burgers forward at batch 8, i.e. the sum of
        # 1 encoder + 5 processor + 1 decoder launches; "shapes" splits them
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": max(by, key=by.get),
        "library_ms": total("library_ms"),
        "shapes": [per[n] for n in ("encoder", "processor", "decoder")],
        # the Darcy 421^2 ZSSR encoder and decoder on the grid-ordered mesh
        "darcy_zssr_shapes": d_zssr["ops"],
        # one cylinder forward at batch 200 (1 encoder + 4 processor + 1
        # decoder launches) on the model's geometry; "cylinder_shapes" splits it
        "per_cylinder_forward": {
            **per_step(c_rows, "launches_per_forward"),
            "library_ms": sum(r["library_ms"] * r["launches_per_forward"] for r in c_rows)},
        "cylinder_shapes": c_rows,
    }]}
    replaces = {  # the pl.pallas_call of each TPU kernel
        "posatt_stats": "position_induced_transformer_tpu/kernels/posatt_pallas.py:419",
        "posatt_bwd_dscale": "position_induced_transformer_tpu/kernels/posatt_pallas.py:545",
        "posatt_bwd_du": "position_induced_transformer_tpu/kernels/posatt_pallas.py:627",
    }

    # #2: off every path (every version's forward writes M and L), held
    # and timed through the kernel API in phases 5 and 16. Times and
    # bounds: one Burgers forward's shapes (1 encoder + 5 processor + 1
    # decoder) from phase 5's rows; "schedule_shapes" adds phase 16's shapes
    rows = bwd_rows["posatt_stats"]
    v12 = per_step(rows, "count_per_burgers_forward")
    kernels["kernels"].append({
        "name": "posatt_stats",
        "route": "cuda",
        "source": "position_induced_transformer_torch/kernels/csrc/posatt_fixed_fwd.cu",
        "replaces": replaces["posatt_stats"],
        "launches": s_launched["posatt_stats"],
        "launches_by_path": {"serve": 0, "train": train["launches"]["posatt_stats"],
                             "schedules": s_launched["posatt_stats"],
                             **{k: v["posatt_stats"] for k, v in fixed_paths.items()}},
        "max_abs_err": max(bwd_errs["posatt_stats"], max(r["max_abs_err"] for r in s_stats_rows)),
        **v12,
        "library_ms": None,
        "shapes": rows,
        "schedule_shapes": s_stats_rows,
    })
    for name in BWD_KERNELS[1:]:
        rows = bwd_rows[name]
        # times and bounds: one Burgers training step at batch 8, the sum
        # over its launches; "shapes" splits them
        kernels["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": "position_induced_transformer_torch/kernels/csrc/posatt_fixed_bwd.cu",
            "replaces": replaces[name],
            "launches": train["launches"][name],
            "launches_by_path": {"serve": 0, "train": train["launches"][name],
                                 **{k: v[name] for k, v in fixed_paths.items()}},
            "max_abs_err": bwd_errs[name],
            **per_step(rows, "launches_per_step"),
            "library_ms": None,
            "shapes": rows,
            # through the kernel API, outside the Burgers step
            **({"config_shapes": bwd_config_rows[name]} if name in bwd_config_rows else {}),
            # one cylinder step at batch 200 (the config shapes' cylinder rows)
            "per_cylinder_step": per_step(
                [r for r in bwd_config_rows[name] if r["shape"].startswith("cylinder_")],
                "launches_per_step"),
        })
    # kernel #7: one elasticity training forward at batch 10 (1 encoder + 4
    # processor + 1 decoder launches); a served forward swaps the banded
    # encoder and decoder for the band-less serving shapes. NACA's at batch
    # 20 apart: its training forward, and its served one (the decoder
    # without a band)
    train_rows = [r for r in b_rows if r["config"] == "elasticity"
                  and not r["shape"].startswith("serve_")]
    serve_rows = [r for r in b_rows if r["shape"] in ("processor", "serve_encoder", "serve_decoder")]
    naca_rows = {r["shape"]: r for r in b_rows if r["config"] == "naca"}
    naca_forward = lambda names: {
        **per_step([naca_rows[n] for n in names], "launches_per_forward"),
        "library_ms": sum(naca_rows[n]["library_ms"] * naca_rows[n]["launches_per_forward"]
                          for n in names)}
    fwd = per_step(train_rows, "launches_per_forward")
    n_serve, n_train = (e_serve["launches"]["posatt_batched_fwd"],
                        e_train["launches"]["posatt_batched_fwd"])
    kernels["kernels"].append({
        "name": "posatt_batched_fwd",
        "route": "cuda",
        "source": "position_induced_transformer_torch/kernels/csrc/posatt_batched_fwd.cu",
        "replaces": "position_induced_transformer_tpu/kernels/posatt_batched.py:278",
        "launches": n_serve + n_train,
        "launches_by_path": {"serve": n_serve, "train": n_train,
                             **{k: v["posatt_batched_fwd"] for k, v in naca_paths.items()}},
        "max_abs_err": b_err,
        **fwd,
        "library_ms": sum(r["library_ms"] * r["launches_per_forward"] for r in train_rows),
        "per_serve_forward": {
            **per_step(serve_rows, "launches_per_forward"),
            "library_ms": sum(r["library_ms"] * r["launches_per_forward"] for r in serve_rows)},
        "per_naca_train_forward": naca_forward(("naca_encoder", "naca_processor", "naca_decoder")),
        "per_naca_serve_forward": naca_forward(("naca_encoder", "naca_processor",
                                                "naca_serve_decoder")),
        "shapes": b_rows,
    })
    # kernel #8: its two entry points over one elasticity training step,
    # and over one NACA step apart
    by_config = lambda k, c: [r for r in b_bwd_rows[k] if r["config"] == c]
    entry = {k: per_step(by_config(k, "elasticity"), "launches_per_step") for k in BATCHED_KERNELS[1:]}
    naca_entry = {k: per_step(by_config(k, "naca"), "launches_per_step") for k in BATCHED_KERNELS[1:]}
    kernels["kernels"].append({
        "name": "posatt_batched_bwd",
        "route": "cuda",
        "source": "position_induced_transformer_torch/kernels/csrc/posatt_batched_bwd.cu",
        "replaces": "position_induced_transformer_tpu/kernels/posatt_batched.py:415",
        "launches": sum(e_train["launches"][k] for k in BATCHED_KERNELS[1:]),
        "launches_by_path": {"serve": 0, **{k: e_train["launches"][k] for k in BATCHED_KERNELS[1:]},
                             **{f"{p}_{k}": v[k] for p, v in naca_paths.items()
                                for k in BATCHED_KERNELS[1:]}},
        "max_abs_err": max(b_bwd_errs[k] for k in BATCHED_KERNELS[1:]),
        "ms": sum(e["ms"] for e in entry.values()),
        "plain_ms": sum(e["plain_ms"] for e in entry.values()),
        "bound_ms": sum(e["bound_ms"] for e in entry.values()),
        "bound_by": max(entry.values(), key=lambda e: e["bound_ms"])["bound_by"],
        "library_ms": None,
        "entry_points": entry,
        "per_naca_step": naca_entry,
        "shapes": b_bwd_rows,
    })
    # the TF kernels: #9 over one served forward (and #10 over one step on
    # a batch without thresholds), #11 over one training forward and #12
    # over one training step, at batch 10; "shapes" splits them
    bare = t_train["launches_step_without_thresholds"]
    # the variants' position-attention coders (lite: #13, elasticity_tf #9, #11, #12)
    v_paths = variant_launch_paths(variants)
    v_launched = lambda names: {f"{p}_{k}" if len(names) > 1 else p: n[k]
                                for p, n in v_paths.items() for k in names if n.get(k)}
    tf = {
        # name: (source, pallas_call, rows, launches key, launches by path, error)
        "posatt_tf_fwd": ("posatt_tf_fwd.cu", 733, tf_fwd_rows["dist"], "launches_per_forward",
                          {"serve": t_serve["launches"]["posatt_tf_fwd"],
                           "train_without_thresholds": bare["posatt_tf_fwd"],
                           **v_launched(("posatt_tf_fwd",))}, tf_errs["dist"]),
        "posatt_tf_bwd": ("posatt_tf_bwd.cu", 779, tf_bwd_rows["dist"], "launches_per_step",
                          {"serve": 0, **{k: bare[k] for k in TF_DIST_KERNELS[1:]}},
                          max(tf_bwd_errs["dist"].values())),
        "posatt_tf_coord_fwd": ("posatt_tf_fwd.cu", 1175, tf_fwd_rows["coord"], "launches_per_forward",
                                {"serve": 0, "train": t_train["launches"]["posatt_tf_coord_fwd"],
                                 **v_launched(("posatt_tf_coord_fwd",))},
                                tf_errs["coord"]),
        "posatt_tf_coord_bwd": ("posatt_tf_bwd.cu", 1236, tf_bwd_rows["coord"], "launches_per_step",
                                {"serve": 0, **{k: t_train["launches"][k] for k in TF_COORD_KERNELS[1:]},
                                 **v_launched(TF_COORD_KERNELS[1:])},
                                max(tf_bwd_errs["coord"].values())),
    }
    for name, (source, line, rows, key, by_path, err) in tf.items():
        entry = {
            "name": name,
            "route": "cuda",
            "source": f"position_induced_transformer_torch/kernels/csrc/{source}",
            "replaces": f"position_induced_transformer_tpu/kernels/posatt_batched.py:{line}",
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": err,
            **per_step(rows, key),
            "library_ms": (sum(r["library_ms"] * r[key] for r in rows)
                           if rows[0]["library_ms"] is not None else None),
            "shapes": rows,
        }
        if name.endswith("_bwd"):
            entry["entry_points"] = {
                part: {"ms": sum(r[part]["ms"] * r[key] for r in rows),
                       "bound_ms": sum(r[part]["bound_ms"] * r[key] for r in rows)}
                for part in ("dscale", "dv")}
        kernels["kernels"].append(entry)
    # #5 and #6, the schedule variants of #1: phase 16
    kernels["kernels"] += [schedule_entry(v, s_rows, s_launched) for v in (1, 2)]
    # #13, three entry points: times and bounds summed over one naca_tf
    # forward (the forward) or training step (dscale, dv) at batch 8, the
    # largest of the five configurations; "per_config" the same for each
    tff_paths = {f"{n}_{phase}": r["launches"] for n, rep in tff.items() for phase, r in rep.items()}
    for name, part, source in (("posatt_tf_fixed_fwd", "fwd", "posatt_tf_fixed_fwd.cu"),
                               ("posatt_tf_fixed_bwd_dscale", "dscale", "posatt_tf_fixed_bwd.cu"),
                               ("posatt_tf_fixed_bwd_dv", "dv", "posatt_tf_fixed_bwd.cu")):
        def summed(config, part=part):
            rows = [r for r in tff_rows if r["config"] == config]
            total = lambda key: sum(r[part][key] * r["launches_per_forward"] for r in rows)
            by = {kind: sum(r[part]["bound_ms"] * r["launches_per_forward"] for r in rows
                            if r[part]["bound_by"] == kind) for kind in ("operations", "bytes")}
            out = {"ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
                   "bound_by": max(by, key=by.get)}
            out["library_ms"] = total("library_ms") if part == "fwd" else None
            return out
        by_path = {p: v[name] for p, v in tff_paths.items()}
        by_path.update({p: v[name] for p, v in v_paths.items() if v.get(name)})
        kernels["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": f"position_induced_transformer_torch/kernels/csrc/{source}",
            "replaces": "position_induced_transformer_tpu/models/pit_tf.py:129 (XLA, no pallas_call)",
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max([r["max_abs_err"][part] for r in tff_rows]
                               + [e[part] for e in tff_ragged_errs.values()]),
            **summed("naca_tf"),
            "per_config": {c: summed(c) for c in TF_FIXED_CONFIGS + ("darcy_tf_zssr",)},
            "function_max_abs_err": tff_fn_err,
            "shapes": [{k: v for k, v in r.items() if k not in ("fwd", "dscale", "dv")} | r[part]
                       for r in tff_rows],
        })
    # #14, three entry points: times and bounds summed over one burgers_tf
    # transformer training step (7 launches each at batch 5)
    kernels["kernels"] += dotatt_entries(dot_rows, dot_ragged_errs, dot_fn_err, variants)
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
