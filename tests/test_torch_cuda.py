"""The CUDA kernels against their plain versions, on the card: the
fixed-mesh kernels #1-#4 and the schedule variants #5 (v1) and #6 (v2) of
#1 (one body; each writes its own M and L), the per-sample-mesh kernels #7
and #8, the TF-semantics kernels #9-#12 and the fixed-mesh TF kernel #13;
kernel #14 (dot-product attention of the TF ablation variants); #9/#10
on the torch-semantics route over materialized distances (batched
non-lazy geometry); the host geometry builder's upload;
and the launches of the model paths (Burgers, Darcy, sod, elasticity,
vorticity under each remat mode, NACA, the five fixed-mesh TF
configurations, burgers_tf's lite and selfpit variants), with #1 recomputed
under checkpointing to the same bits; and bf16 models (``compute_dtype``)
launching what their float32 counterparts launch, with float32 at every
kernel.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports no JAX, so that it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance rtol 2e-5 / atol 2e-6: both sides float32, sums in another order.
The bandwidth gradient is a cancelling sum over L_out * B * D terms, so it
is held at rtol 5e-4 / atol 5e-6 (the bound tests/test_pallas.py holds the
JAX fused backward to) on terms normalised to unit scale.
"""

import contextlib
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from position_induced_transformer_torch.kernels import posatt_batched as kb
from position_induced_transformer_torch.kernels import posatt_pallas as kp
from position_induced_transformer_torch.ops import distances, locality, posatt

RTOL, ATOL = 2e-5, 2e-6
DS_RTOL, DS_ATOL = 5e-4, 5e-6

SHAPES = [
    (64, 64, 2, 2, 8, 0.3),
    (64, 64, 2, 1, 8, 1.0),
    (16, 200, 3, 2, 4, 0.1),
    (100, 48, 2, 2, 16, 0.5),
    (40, 72, 2, 8, 4, 0.2),
    (97, 1000, 3, 1, 5, 0.02),
    (1000, 97, 2, 8, 33, 1.0),
    (256, 1024, 8, 2, 2, 0.02),  # the Burgers encoder's shape
    (50, 300, 4, 8, 4, 0.2),  # B*D <= 32 tiles, eight heads
    (300, 50, 3, 4, 9, 1.0),  # four heads
    (60, 90, 2, 3, 20, 0.3),  # three heads
    (70, 150, 4, 6, 4, 0.2),  # six heads, B*D <= 32 tiles
    (40, 72, 3, 12, 16, 1.0),  # twelve heads: two groups of six
    (97, 200, 2, 12, 5, 0.1),  # twelve heads, B*D <= 32 tiles
]
# the backward kernels also at the Burgers training shapes (B 8, H 2), a
# vorticity-width processor (B*D = 5120) and a split count that does not
# divide L_in (dscale at 256 x 1000: 63 groups of 16 keys, the last of 8,
# dealt to 32 splits)
BWD_SHAPES = SHAPES + [
    (256, 256, 8, 2, 64, 1.0),  # Burgers processor
    (1024, 256, 8, 2, 64, 0.02),  # Burgers decoder
    (256, 256, 20, 2, 256, 1.0),  # vorticity processor
    (256, 1000, 4, 2, 16, 0.05),  # dscale: L_in split 32 ways
]
# the forward (#1) also where it splits L_in more than 8 ways (the split
# records go to scratch), at the full Darcy 421^2 ZSSR encoder, and at
# ragged shapes with 1, 3, 8 and 12 heads
FWD_SHAPES = [
    (64, 60000, 10, 2, 3, 0.02),  # 32 splits of L_in: the scratch combine
    (256, 177241, 10, 2, 3, 0.02),  # the ZSSR encoder
    (97, 333, 3, 1, 7, 0.1),
    (45, 1001, 2, 3, 5, 0.05),
    (77, 515, 2, 8, 9, 0.2),
    (33, 129, 2, 12, 4, 0.3),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def _inputs(dev, L_out, L_in, B, H, D, seed=0):
    rng = np.random.default_rng(seed)
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    dist = distances.euclidean_sq(to(rng.random((L_out, 2))), to(rng.random((L_in, 2))))
    return dist, to(rng.standard_normal((H, 1, 1))), to(rng.random((B, L_in, D)))


@pytest.mark.cuda
@pytest.mark.parametrize("L_out,L_in,B,H,D,loc", SHAPES + FWD_SHAPES)
def test_cuda_kernel_matches_plain(cuda, L_out, L_in, B, H, D, loc):
    """#1 against its plain version, with and without the row statistics
    out (the same output bits either way), and the same bits on two runs."""
    dist, lmda, u = _inputs(cuda, L_out, L_in, B, H, D)
    thr = (
        torch.full((L_out, 1), float("inf"), device=cuda)
        if loc >= 1 else locality.quantile_threshold(dist, loc)
    )
    scale = posatt.bandwidth_scale(lmda).reshape(H, 1)
    before = kp.posatt_fixed_cuda.launches
    got = kp.posatt_fixed_cuda(dist, thr, scale, u)
    torch.cuda.synchronize()
    assert kp.posatt_fixed_cuda.launches == before + 1
    want, M_want, L_want = kp.posatt_fixed_reference(dist, thr, scale, u, stats=True)
    want = want.permute(1, 2, 0, 3).reshape(B, L_out, H * D)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    again, M, L = kp.posatt_fixed_cuda(dist, thr, scale, u, stats=True)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(M, M_want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(L, L_want, rtol=RTOL, atol=ATOL)
    third, M2, L2 = kp.posatt_fixed_cuda(dist, thr, scale, u, stats=True)
    torch.cuda.synchronize()
    assert torch.equal(got, third) and torch.equal(M, M2) and torch.equal(L, L2)


@pytest.mark.cuda
@pytest.mark.parametrize("L_out,L_in,B,H,D,loc", BWD_SHAPES + FWD_SHAPES[:1])
def test_cuda_forward_stats_are_the_stats_kernel_bits(cuda, L_out, L_in, B, H, D, loc):
    """#1's M and L, written beside its output, are bit for bit what #2
    (its kernel without the contraction) writes at the same shape."""
    dist, thr, scale, u, _ = _stats_inputs(cuda, L_out, L_in, B, H, D, loc)
    _, M, L = kp.posatt_fixed_cuda(dist, thr, scale, u, stats=True)
    M2, L2 = kp.posatt_stats_cuda(dist, thr, scale, B, D)
    torch.cuda.synchronize()
    assert torch.equal(M, M2) and torch.equal(L, L2)


@pytest.mark.cuda
@pytest.mark.parametrize("L_out,L_in,B,H,D,loc", [
    (40, 72, 2, 2, 4, 0.2),  # one split
    (256, 256, 8, 2, 64, 1.0),  # 8 splits: the cluster combine
    (64, 60000, 10, 2, 3, 0.02),  # 32 splits: the scratch combine
])
def test_cuda_rows_that_keep_no_entry(cuda, L_out, L_in, B, H, D, loc):
    """A row whose threshold lies below its least distance and a row of +inf
    distances keep no entry: softmax over -1e38 everywhere, i.e. the mean
    of u over all L_in, M = -1e38 and L = L_in, as the plain version."""
    dist, thr, scale, u, _ = _stats_inputs(cuda, L_out, L_in, B, H, D, loc)
    thr[2] = -1.0
    dist[9] = float("inf")
    thr[9] = float("inf")
    got, M, L = kp.posatt_fixed_cuda(dist, thr, scale, u, stats=True)
    M2, L2 = kp.posatt_stats_cuda(dist, thr, scale, B, D)
    torch.cuda.synchronize()
    want, M_want, L_want = kp.posatt_fixed_reference(dist, thr, scale, u, stats=True)
    want = want.permute(1, 2, 0, 3).reshape(B, L_out, H * D)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(got[:, 2], u.mean(1).repeat(1, H), rtol=RTOL, atol=ATOL)
    assert torch.equal(M, M_want) and (M[:, [2, 9]] == -1e38).all()
    assert (L[:, [2, 9]] == L_in).all()
    torch.testing.assert_close(L, L_want, rtol=RTOL, atol=ATOL)
    assert torch.equal(M, M2) and torch.equal(L, L2)


@pytest.mark.cuda
def test_fwd_plan_splits_l_in(cuda):
    """#1 splits L_in until the grid holds about 8 warps an SM: 8 splits of
    the Burgers processor (a cluster, no scratch), 32 at the ZSSR encoder
    (split records in scratch, a counter per tile), none at the ZSSR
    decoder; the stats entry point takes the same split. Versions 2 and 1
    take the same rule on their own blocks: one head a block (v1: one
    sample's columns), one warp where those are 64 or fewer."""
    assert kp._fwd_plan(True, 2, 8, 256, 256, 64)[:3] == (0, 0, 8)
    floats, tiles, splits, warps = kp._fwd_plan(True, 2, 10, 256, 177241, 3)
    assert (tiles, splits, warps) == (8, 32, 2) and floats == 8 * 32 * 2 * 32 * (2 + 64)
    assert kp._fwd_plan(False, 2, 10, 256, 177241, 3)[:3] == (8 * 32 * 2 * 32 * 2, 8, 32)
    assert kp._fwd_plan(True, 2, 10, 177241, 256, 64)[2] == 1
    # version 2 at the Burgers processor: a head and four slabs a block,
    # the warps and splits of version 3's two heads by two slabs
    assert kp._fwd_plan(True, 2, 8, 256, 256, 64, 2) == kp._fwd_plan(True, 2, 8, 256, 256, 64)
    # the ZSSR encoder: row walks, one warp a block (version 1: a head, a
    # sample and a 4-column tile of its 3 columns; version 2: a 32-column
    # tile of B*D = 30), their split aiming at twice #1's warps: 13 and 32
    # splits through scratch
    floats, tiles, splits, warps = kp._fwd_plan(True, 2, 10, 256, 177241, 3, 1)
    assert (tiles, splits, warps) == (160, 13, 1) and floats == 160 * 13 * 32 * (2 + 4)
    floats, tiles, splits, warps = kp._fwd_plan(True, 2, 10, 256, 177241, 3, 2)
    assert (tiles, splits, warps) == (16, 32, 1) and floats == 16 * 32 * 32 * (2 + 32)
    # version 1 at the Burgers processor: four warps sharing a 64-column
    # slab's keys, 2 splits; at the ZSSR decoder a row walk, no split
    assert kp._fwd_plan(True, 2, 8, 256, 256, 64, 1) == (0, 0, 2, 4)
    assert kp._fwd_plan(True, 2, 10, 177241, 256, 64, 1) == (0, 0, 1, 1)


@pytest.mark.cuda
def test_wrapper_launches_kernel_and_matches_oracle(cuda):
    dist, lmda, u = _inputs(cuda, 48, 80, 2, 2, 6)
    before = kp.posatt_fixed_cuda.launches
    got = kp.position_attention_fixed(dist, lmda, u, 0.1)
    assert kp.posatt_fixed_cuda.launches == before + 1
    want = posatt.position_attention(dist, lmda, u, 0.1)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def _stats_inputs(dev, L_out, L_in, B, H, D, loc, seed=0):
    dist, lmda, u = _inputs(dev, L_out, L_in, B, H, D, seed)
    thr = (
        torch.full((L_out, 1), float("inf"), device=dev)
        if loc >= 1 else locality.quantile_threshold(dist, loc)
    )
    scale = posatt.bandwidth_scale(lmda).reshape(H, 1)
    rng = np.random.default_rng(seed + 1)
    g = torch.from_numpy(rng.standard_normal((B, L_out, H * D)).astype(np.float32)).to(dev)
    return dist, thr, scale, u, g


@pytest.mark.cuda
@pytest.mark.parametrize("L_out,L_in,B,H,D,loc", SHAPES)
def test_cuda_stats_matches_plain(cuda, L_out, L_in, B, H, D, loc):
    dist, thr, scale, _, _ = _stats_inputs(cuda, L_out, L_in, B, H, D, loc)
    before = kp.posatt_stats_cuda.launches
    M, L = kp.posatt_stats_cuda(dist, thr, scale, B, D)
    torch.cuda.synchronize()
    assert kp.posatt_stats_cuda.launches == before + 1
    M_want, L_want = kp.posatt_stats_reference(dist, thr, scale)
    torch.testing.assert_close(M, M_want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(L, L_want, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("L_out,L_in,B,H,D,loc", BWD_SHAPES)
def test_cuda_bwd_du_matches_plain(cuda, L_out, L_in, B, H, D, loc):
    dist, thr, scale, _, g = _stats_inputs(cuda, L_out, L_in, B, H, D, loc)
    M, L = kp.posatt_stats_reference(dist, thr, scale)
    before = kp.posatt_bwd_du_cuda.launches
    got = kp.posatt_bwd_du_cuda(dist, thr, scale, M, L, g)
    torch.cuda.synchronize()
    assert kp.posatt_bwd_du_cuda.launches == before + 1
    want = kp.posatt_bwd_du_reference(dist, thr, scale, M, L, g)
    # dU sums L_out * H signed terms: the rounding of a float32 sum scales
    # with the sum of their magnitudes, not with the (cancelled) result
    size = kp.posatt_bwd_du_reference(dist, thr, scale, M, L, g.abs())
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= ATOL + RTOL * size).all(), (got - want).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("L_out,L_in,B,H,D,loc", BWD_SHAPES)
def test_cuda_bwd_dscale_matches_plain_and_is_deterministic(cuda, L_out, L_in, B, H, D, loc):
    dist, thr, scale, u, g = _stats_inputs(cuda, L_out, L_in, B, H, D, loc)
    M, L = kp.posatt_stats_reference(dist, thr, scale)
    out = kp.posatt_fixed_reference(dist, thr, scale, u).permute(1, 2, 0, 3).reshape(g.shape)
    out = out.contiguous()
    before = kp.posatt_bwd_dscale_cuda.launches
    got = kp.posatt_bwd_dscale_cuda(dist, thr, scale, M, L, g, u, out)
    again = kp.posatt_bwd_dscale_cuda(dist, thr, scale, M, L, g, u, out)
    torch.cuda.synchronize()
    assert kp.posatt_bwd_dscale_cuda.launches == before + 2
    assert torch.equal(got, again)
    want = kp.posatt_bwd_dscale_reference(dist, thr, scale, M, L, g, u, out)
    # normalise by the size of the summed terms: sum_i |w_i| + |r_i v_i|
    p = torch.where((dist <= thr) & (dist < float("inf")),
                    torch.exp(-dist[None] * scale[:, :, None] - M), 0.0) / L
    t = torch.einsum("bihk,bjk->hij", g.reshape(B, L_out, H, D), u)
    d = torch.where(torch.isfinite(dist), dist, 0.0)
    size = ((p * t * d).sum(-1).abs() + (p * t).sum(-1).abs() * (p * d).sum(-1)).sum(-1, keepdim=True)
    torch.testing.assert_close(got / size, want / size, rtol=DS_RTOL, atol=DS_ATOL)


def _grads(fn, dist, lmda, u, loc, w):
    lmda = lmda.clone().requires_grad_(True)
    u = u.clone().requires_grad_(True)
    out = fn(dist, lmda, u, loc)
    (out * w).sum().backward()
    return out.detach(), lmda.grad, u.grad


@pytest.mark.cuda
@pytest.mark.parametrize("L_out,L_in,B,H,D,loc", SHAPES)
def test_function_gradients_match_oracle_autograd(cuda, L_out, L_in, B, H, D, loc):
    dist, lmda, u = _inputs(cuda, L_out, L_in, B, H, D)
    w = torch.from_numpy(
        np.random.default_rng(2).standard_normal((B, L_out, H * D)).astype(np.float32)
    ).to(cuda)
    counters = (kp.posatt_fixed_cuda, kp.posatt_stats_cuda,
                kp.posatt_bwd_dscale_cuda, kp.posatt_bwd_du_cuda)
    before = [f.launches for f in counters]
    got = _grads(kp.position_attention_fixed, dist, lmda, u, loc, w)
    torch.cuda.synchronize()
    # one forward + backward launches the forward, dscale and du once each;
    # the forward writes the row statistics, so the stats kernel never runs
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 0, 1, 1]
    want = _grads(posatt.position_attention, dist, lmda, u, loc, w)
    torch.testing.assert_close(got[0], want[0], rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(got[1], want[1], rtol=DS_RTOL, atol=DS_ATOL * want[1].abs().max().item())
    # dU: the tolerance of test_cuda_bwd_du_matches_plain, on the terms' magnitudes
    size = _grads(posatt.position_attention, dist, lmda, u, loc, w.abs())[2]
    assert ((got[2] - want[2]).abs() <= ATOL + RTOL * size).all()


@pytest.mark.cuda
@pytest.mark.parametrize("du", [False, True])
def test_bwd_plan_splits_the_burgers_processor(cuda, du):
    """The backward kernels split the streamed index of the Burgers
    processor (B 8, H 2, 256 x 256, D 64) 8 ways, its groups of 16 indices
    dealt to the splits in turn: dscale (its keys) with one partial per
    block and head; du (its rows) with the blocks of a tile one cluster
    that sums their tiles, and no scratch."""
    floats, splits = kp._bwd_plan(du, 2, 8, 256, 256, 64)
    # a split count that does not divide L_in: 63 groups dealt to 32 splits
    assert kp._bwd_plan(False, 2, 4, 256, 1000, 16)[1] == 32
    if du:  # at most 8 splits (the portable cluster size)
        assert (floats, splits) == (0, 8)
        assert kp._bwd_plan(True, 2, 8, 1024, 256, 64)[1] == 8
    else:  # 8 row tiles x 4 column tiles of 128 x 8 splits, 2 heads
        assert (floats, splits) == (8 * 4 * 8 * 2, 8)


@pytest.mark.cuda
def test_burgers_forward_backward_launches_each_kernel_once(cuda):
    """One forward + backward of each Burgers attention op through
    position_attention_fixed, on the model's own geometry, launches the
    forward, dscale and du kernels exactly once each and the stats kernel
    never (the forward writes the row statistics; dscale is one launch: no
    separate sum of its partials), and the gradients agree with autograd
    of the oracle."""
    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.data import meshes
    from position_induced_transformer_torch.models import build_geometry

    cfg = configs.BURGERS
    mesh, ltt = meshes.grid_1d(cfg.grid[0]), meshes.grid_1d(cfg.latent_grid[0])
    geom = build_geometry(mesh, ltt, mesh, metric=cfg.metric, en_loc=cfg.model.en_loc,
                          de_loc=cfg.model.de_loc, device=cuda)
    H, B, D = cfg.model.n_head, 8, cfg.model.hid_dim
    rng = np.random.default_rng(4)
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)
    counters = (kp.posatt_fixed_cuda, kp.posatt_stats_cuda,
                kp.posatt_bwd_dscale_cuda, kp.posatt_bwd_du_cuda)
    for dist, loc, thr in ((geom.dist_proc, 1.0, None),
                           (geom.dist_up, cfg.model.de_loc, geom.thr_up)):
        lmda = to(rng.random((H, 1, 1)))
        u = to(rng.standard_normal((B, dist.shape[1], D)))
        w = to(rng.standard_normal((B, dist.shape[0], H * D)))
        before = [f.launches for f in counters]
        got = _grads(lambda *a: kp.position_attention_fixed(*a, thr=thr), dist, lmda, u, loc, w)
        torch.cuda.synchronize()
        assert [f.launches - b for f, b in zip(counters, before)] == [1, 0, 1, 1]
        want = _grads(lambda *a: posatt.position_attention(*a, thr=thr), dist, lmda, u, loc, w)
        torch.testing.assert_close(got[1], want[1], rtol=DS_RTOL,
                                   atol=DS_ATOL * want[1].abs().max().item())
        size = _grads(lambda *a: posatt.position_attention(*a, thr=thr), dist, lmda, u, loc,
                      w.abs())[2]
        assert ((got[2] - want[2]).abs() <= ATOL + RTOL * size).all()


@pytest.mark.cuda
def test_no_grad_forward_launches_the_forward_kernel_only(cuda):
    dist, lmda, u = _inputs(cuda, 16, 24, 2, 2, 3)
    lmda.requires_grad_(True)
    before = kp.posatt_fixed_cuda.launches, kp.posatt_stats_cuda.launches
    with torch.inference_mode():
        assert kp.position_attention_fixed(dist, lmda, u, 0.3).shape == (2, 16, 6)
    with torch.no_grad():
        kp.position_attention_fixed(dist, lmda, u, 0.3)
    assert (kp.posatt_fixed_cuda.launches, kp.posatt_stats_cuda.launches) == (
        before[0] + 2, before[1]
    )


# ------------------------------ fixed-mesh schedule variants: #5 (v1), #6 (v2)

SCHEDULE_SHAPES = [
    # L_out, L_in, B, H, D, locality; no L_out a multiple of a row tile
    (100, 48, 2, 1, 2, 0.5),  # one head, D 2: row walks (v1, v2), 3 splits
    (97, 200, 3, 2, 64, 0.1),  # D 64: key-split warps (v1, 7 splits), four slabs (v2, 13)
    (33, 65, 2, 3, 5, 1.0),  # three heads, global
    (50, 300, 4, 8, 64, 0.2),  # eight heads
    (70, 130, 3, 2, 100, 0.3),  # two slabs (v1)
    (40, 72, 2, 2, 300, 0.2),  # D above 256: v1 cuts a sample's columns in two tiles
    (64, 60000, 10, 2, 3, 0.02),  # row walks, 32 splits: the scratch combine
    (4003, 100, 4, 2, 8, 0.05),  # row walks: 2 splits (v1, 16-byte u rows), 7 (v2)
    (4003, 100, 4, 2, 64, 0.05),  # one split: key-split warps (v1), four slabs (v2)
    (40, 5000, 2, 1, 64, 0.05),  # key-split warps (v1), 32 splits: the scratch combine
    (8500, 100, 8, 2, 40, 0.05),  # v1: a row walk over 64 columns, 40 live, one split
    (8500, 100, 8, 2, 33, 0.05),  # the same at D 33: 4-byte u and output pieces
]
SCHEDULE_LAUNCHERS = {1: kp.posatt_fixed_v1_cuda, 2: kp.posatt_fixed_v2_cuda, 3: kp.posatt_fixed_cuda}


def _schedule_inputs(dev, L_out, L_in, B, H, D, loc, inf_row=True):
    """As _stats_inputs, with row 5 global (thr +inf) and, with
    ``inf_row``, row 3 all +inf distances but one kept entry (autograd of
    the oracle meets inf * 0 there), row 6 all +inf distances and row 8 a
    threshold below all its distances (both keep no entry)."""
    dist, thr, scale, u, g = _stats_inputs(dev, L_out, L_in, B, H, D, loc)
    thr[5] = float("inf")
    if inf_row:
        dist[3] = float("inf")
        dist[3, 7] = 0.5
        thr[3] = 1.0
        dist[6] = float("inf")
        thr[8] = -1.0
    return dist, thr, scale, u, g


@pytest.mark.cuda
@pytest.mark.parametrize("version", [1, 2, 3])
@pytest.mark.parametrize("L_out,L_in,B,H,D,loc", SCHEDULE_SHAPES)
def test_cuda_schedule_kernel_matches_plain(cuda, L_out, L_in, B, H, D, loc, version):
    """Each version's forward against the plain version, and with the row
    statistics out (one launch, the same output bits) its M and L against
    the plain version's; rows 6 and 8 keep no entry: the mean of u,
    M = -1e38 and L = L_in."""
    dist, thr, scale, u, _ = _schedule_inputs(cuda, L_out, L_in, B, H, D, loc)
    launcher = SCHEDULE_LAUNCHERS[version]
    before = [f.launches for f in (*SCHEDULE_LAUNCHERS.values(), kp.posatt_stats_cuda)]
    got = launcher(dist, thr, scale, u)
    again, M, L = launcher(dist, thr, scale, u, stats=True)
    torch.cuda.synchronize()
    after = [f.launches for f in (*SCHEDULE_LAUNCHERS.values(), kp.posatt_stats_cuda)]
    assert [a - b for a, b in zip(after, before)] == [
        2 * int(v == version) for v in SCHEDULE_LAUNCHERS] + [0]
    want, M_want, L_want = kp.posatt_fixed_reference(dist, thr, scale, u, stats=True)
    want = want.permute(1, 2, 0, 3).reshape(B, L_out, H * D)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert torch.equal(got, again)
    torch.testing.assert_close(M, M_want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(L, L_want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(got[:, 8], u.mean(1).repeat(1, H), rtol=RTOL, atol=ATOL)
    assert (M[:, [6, 8]] == -1e38).all() and (L[:, [6, 8]] == L_in).all()


@pytest.mark.cuda
@pytest.mark.parametrize("L_out,L_in,B,H,D,loc", SCHEDULE_SHAPES)
def test_schedule_versions_share_one_backward(cuda, L_out, L_in, B, H, D, loc):
    """One forward + backward per version launches that version's forward,
    #3 and #4 once each and #2 never: every version's forward writes M and
    L itself, on its own plan. dU reads M and L and not the forward's
    output, so where a version's M and L are #1's bits its dU is #1's;
    elsewhere its M and L are held to #2's and its dU to autograd of the
    oracle on the magnitude of the summed terms. dscale reads the output,
    so under each version it is held to autograd of the oracle."""
    dist, thr, _, u, w = _schedule_inputs(cuda, L_out, L_in, B, H, D, loc, inf_row=False)
    lmda = torch.from_numpy(np.random.default_rng(3).random((H, 1, 1)).astype(np.float32)).to(cuda)
    backward = (kp.posatt_stats_cuda, kp.posatt_bwd_dscale_cuda, kp.posatt_bwd_du_cuda)
    results = {}
    for version, launcher in SCHEDULE_LAUNCHERS.items():
        before = [f.launches for f in (*SCHEDULE_LAUNCHERS.values(), *backward)]
        fn = lambda *a: kp.position_attention_fixed(*a, thr=thr, version=version)
        results[version] = _grads(fn, dist, lmda, u, loc, w)
        torch.cuda.synchronize()
        after = [f.launches for f in (*SCHEDULE_LAUNCHERS.values(), *backward)]
        assert [a - b for a, b in zip(after, before)] == [
            int(v == version) for v in SCHEDULE_LAUNCHERS] + [0, 1, 1]
    oracle = lambda *a: posatt.position_attention(*a, thr=thr)
    want = _grads(oracle, dist, lmda, u, loc, w)
    size = _grads(oracle, dist, lmda, u, loc, w.abs())[2]
    scale = posatt.bandwidth_scale(lmda).reshape(H, 1)
    stats = {v: f(dist, thr, scale, u, stats=True)[1:] for v, f in SCHEDULE_LAUNCHERS.items()}
    M2, L2 = kp.posatt_stats_cuda(dist, thr, scale, B, D)
    torch.cuda.synchronize()
    for version in (1, 2):
        torch.testing.assert_close(results[version][0], results[3][0], rtol=RTOL, atol=ATOL)
        (M, L), (M3, L3) = stats[version], stats[3]
        if torch.equal(M, M3) and torch.equal(L, L3):
            assert torch.equal(results[version][2], results[3][2])
        torch.testing.assert_close(M, M2, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(L, L2, rtol=RTOL, atol=ATOL)
    for version in SCHEDULE_LAUNCHERS:
        assert ((results[version][2] - want[2]).abs() <= ATOL + RTOL * size).all()
        torch.testing.assert_close(results[version][1], want[1], rtol=DS_RTOL,
                                   atol=DS_ATOL * want[1].abs().max().item())


@pytest.mark.cuda
def test_unknown_version_raises_before_any_launch_on_cuda(cuda):
    dist, lmda, u = _inputs(cuda, 16, 24, 2, 2, 3)
    before = [f.launches for f in SCHEDULE_LAUNCHERS.values()]
    for version in (0, 4):
        with pytest.raises(ValueError, match="version"):
            kp.position_attention_fixed(dist, lmda, u, 0.3, version=version)
    assert [f.launches for f in SCHEDULE_LAUNCHERS.values()] == before


# ------------------------------------------- per-sample meshes: kernels #7, #8

BATCHED_SHAPES = [
    # B, L_q, L_k, H, D, locality, thresholds: "none" (in-kernel keep
    # count, or global), "robust" (precomputed) or "ring" (circular band)
    (2, 64, 64, 2, 8, 0.1, "none"),  # masked-min, c = 7
    (2, 64, 64, 1, 8, 1.0, "none"),  # global
    (3, 37, 53, 2, 19, 0.1, "none"),  # nothing tile-aligned
    (2, 300, 120, 1, 4, 0.02, "none"),  # c = 3
    (2, 300, 120, 4, 44, 0.1, "robust"),
    (1, 97, 1000, 8, 19, 0.02, "robust"),
    (2, 900, 700, 2, 8, 0.02, "ring"),  # the band crosses the seam
    (2, 1000, 800, 8, 33, 0.02, "ring"),  # L_out not a multiple of 256
    (2, 64, 80, 3, 8, 0.1, "robust"),  # three heads
    (2, 50, 60, 6, 40, 0.2, "none"),  # six heads, in-kernel keep count
    (2, 900, 700, 6, 12, 0.02, "ring"),  # six heads, band
    (1, 70, 1500, 2, 256, 1.0, "none"),  # a window past the 1024-column list
    # queries on an arc across the key ring's seam: one band tile of 200
    # rows, a short last 32-row block
    (2, 200, 300, 2, 8, 0.02, "arc"),
]


def _ring(rng, B, L):
    th = np.sort(rng.uniform(0, 2 * np.pi, (B, L)), axis=1)
    rad = 1.0 + 0.1 * rng.random((B, 1))
    return np.stack([rad * np.cos(th), rad * np.sin(th)], -1).astype(np.float32)


def _arc(rng, B, L):
    """Points on the arc of a ring from -60 to 60 degrees, angle-sorted:
    across the seam of _ring's angle order."""
    th = np.sort(rng.uniform(-np.pi / 3, np.pi / 3, (B, L)), axis=1)
    rad = 1.0 + 0.1 * rng.random((B, 1))
    return np.stack([rad * np.cos(th), rad * np.sin(th)], -1).astype(np.float32)


def _batched_case(dev, B, Lq, Lk, H, D, loc, kind, seed=0):
    """Launcher arguments (mq, mk_ext, scale, u_ext, thr, starts, keep_count,
    width), the wrapper's (mq, mk, lmda, u, loc, thr, band) and a cotangent."""
    rng = np.random.default_rng(seed)
    to = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    if kind in ("ring", "arc"):
        mq = to((_ring if kind == "ring" else _arc)(rng, B, Lq))
        mk = to(_ring(rng, B, Lk))
    else:
        mq, mk = to(rng.random((B, Lq, 2))), to(rng.random((B, Lk, 2)))
    lmda = to(rng.standard_normal((H, 1, 1)))
    u = to(rng.random((B, Lk, D)))
    g = to(rng.standard_normal((B, Lq, H * D)))
    thr = band = None
    if kind != "none":
        thr = locality.batched_topk_thresholds(mq, mk, loc)
    if kind in ("ring", "arc"):
        starts, width, wrap = locality.batched_band_starts(
            mq, mk, thr, kb.band_tile_rows(Lq), circular=True
        )
        assert (starts.numpy() + width > Lk).any(), "no band crosses the seam"
        band = kb.BandSpec(starts.to(dev), width, wrap)
    scale = posatt.bandwidth_scale(lmda).reshape(H, 1)
    mk_e, u_e = mk, u
    if band is not None:
        mk_e = torch.cat([mk, mk[:, : band.wrap]], 1)
        u_e = torch.cat([u, u[:, : band.wrap]], 1)
    kc = locality.topk_keep_count(Lk, loc)
    launch = (mq, mk_e, scale, u_e, thr, None if band is None else band.starts, kc,
              0 if band is None else band.width)
    return launch, (mq, mk, lmda, u, loc, thr, band), g


def _fwd(args):
    """The launcher's keywords and positional arguments."""
    mq, mk, scale, u, thr, starts, kc, width = args
    return dict(keep_count=kc, width=width), (mq, mk, scale, u, thr, starts)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Lq,Lk,H,D,loc,kind", BATCHED_SHAPES)
def test_cuda_batched_fwd_matches_plain(cuda, B, Lq, Lk, H, D, loc, kind):
    args, _, _ = _batched_case(cuda, B, Lq, Lk, H, D, loc, kind)
    kw, pos = _fwd(args)
    before = kb.posatt_batched_cuda.launches
    out, stats = kb.posatt_batched_cuda(*pos, stats=True, **kw)
    again = kb.posatt_batched_cuda(*pos, **kw)
    torch.cuda.synchronize()
    assert kb.posatt_batched_cuda.launches == before + 2
    assert torch.equal(out, again)
    torch.testing.assert_close(out, kb.posatt_batched_reference(*pos, **kw), rtol=RTOL, atol=ATOL)
    want = kb.posatt_batched_stats_reference(*pos[:3], *pos[4:], **kw)
    # dmin and the keep threshold come from bit-equal distances
    assert torch.equal(stats[:, :2], want[:, :2])
    torch.testing.assert_close(stats[:, 2:], want[:, 2:], rtol=RTOL, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Lq,Lk,H,D,loc,kind", BATCHED_SHAPES)
def test_cuda_batched_bwd_matches_plain(cuda, B, Lq, Lk, H, D, loc, kind):
    args, _, g = _batched_case(cuda, B, Lq, Lk, H, D, loc, kind)
    kw, (mq, mk, scale, u, thr, starts) = _fwd(args)
    stats = kb.posatt_batched_stats_reference(mq, mk, scale, thr, starts, **kw)
    out = kb.posatt_batched_reference(mq, mk, scale, u, thr, starts, **kw)
    w = dict(width=kw["width"])
    before = (kb.posatt_batched_bwd_dscale_cuda.launches, kb.posatt_batched_bwd_du_cuda.launches)
    ds = kb.posatt_batched_bwd_dscale_cuda(mq, mk, scale, u, out, g, stats, starts, **w)
    ds2 = kb.posatt_batched_bwd_dscale_cuda(mq, mk, scale, u, out, g, stats, starts, **w)
    du = kb.posatt_batched_bwd_du_cuda(mq, mk, scale, g, stats, starts, **w)
    torch.cuda.synchronize()
    assert (kb.posatt_batched_bwd_dscale_cuda.launches, kb.posatt_batched_bwd_du_cuda.launches) == (
        before[0] + 2, before[1] + 1)
    assert torch.equal(ds, ds2)
    want_du = kb.posatt_batched_bwd_du_reference(mq, mk, scale, g, stats, starts, **w)
    size = kb.posatt_batched_bwd_du_reference(mq, mk, scale, g.abs(), stats, starts, **w)
    assert torch.isfinite(du).all()
    assert ((du - want_du).abs() <= ATOL + RTOL * size).all(), (du - want_du).abs().max()
    want_ds = kb.posatt_batched_bwd_dscale_reference(mq, mk, scale, u, g, stats, starts, **w)
    size = _dscale_size(mq, mk, scale, u, g, stats, starts, kw["width"])
    torch.testing.assert_close(ds / size, want_ds / size, rtol=DS_RTOL, atol=DS_ATOL)


def _dscale_size(mq, mk, scale, u, g, stats, starts, width):
    """The size of dscale's summed terms per sample and head, (B, H):
    sum_i |w_i| + |r_i v_i|, as the fixed-mesh test normalises."""
    att, keep, dist = kb._weights_from_stats(mq, mk, scale, stats, starts, width)
    B, L_out, HD = g.shape
    t = torch.einsum("bihd,bjd->bhij", g.reshape(B, L_out, scale.shape[0], -1), u)
    nd = torch.where(keep, dist, 0.0)[:, None]
    return ((att * t * nd).sum(-1).abs() + (att * t).sum(-1).abs() * (att * nd).sum(-1)).sum(-1)


def _oracle(mq, mk, lmda, u, loc, thr, band):
    dist = distances.euclidean_sq(mq, mk)
    if thr is None and loc < 1:
        thr = locality.topk_threshold(dist, loc)
    return posatt.position_attention(dist, lmda, u, loc, thr=thr)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Lq,Lk,H,D,loc,kind", BATCHED_SHAPES)
def test_batched_function_gradients_match_oracle_autograd(cuda, B, Lq, Lk, H, D, loc, kind):
    _, wrapper_args, w = _batched_case(cuda, B, Lq, Lk, H, D, loc, kind)
    mq, mk, lmda, u, loc, thr, band = wrapper_args

    def grads(fn, w):
        lm = lmda.clone().requires_grad_(True)
        x = u.clone().requires_grad_(True)
        out = fn(mq, mk, lm, x, loc, thr, band)
        (out * w).sum().backward()
        return out.detach(), lm.grad, x.grad

    counters = (kb.posatt_batched_cuda, kb.posatt_batched_bwd_dscale_cuda, kb.posatt_batched_bwd_du_cuda)
    before = [f.launches for f in counters]
    got = grads(kb.position_attention_batched, w)
    torch.cuda.synchronize()
    # one forward + backward launches each entry point exactly once
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1]
    want = grads(_oracle, w)
    torch.testing.assert_close(got[0], want[0], rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(got[1], want[1], rtol=DS_RTOL, atol=DS_ATOL * want[1].abs().max().item())
    size = grads(_oracle, w.abs())[2]
    assert ((got[2] - want[2]).abs() <= ATOL + RTOL * size).all(), (got[2] - want[2]).abs().max()


# the elasticity and elasticity_tf op shapes: 972-point angle-sorted clouds
# (972 rows: 30 blocks of 32 and a ragged 12), the processor (every column
# kept) and the banded encoder / decoder (setup thresholds at locality 0.02
# and a circular band); head counts from one to two groups of six, value
# widths of one 32-column slab and of the processor's 256
CLOUD_OPS = ["processor", "banded"]
CLOUD_HEADS = [1, 3, 8, 12]
CLOUD_WIDTHS = [32, 256]


def _cloud_case(dev, op, H, D, seed=0, B=2, L=972):
    """Self-attention on angle-sorted clouds: the batched launcher's
    arguments at one elasticity op shape and a cotangent."""
    rng = np.random.default_rng(seed)
    to = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    c = to(_ring(rng, B, L))
    u = to(rng.random((B, L, D)))
    g = to(rng.standard_normal((B, L, H * D)))
    scale = posatt.bandwidth_scale(to(rng.standard_normal((H, 1, 1)))).reshape(H, 1)
    if op == "processor":
        return (c, c, scale, u, None, None, L, 0), g
    thr = locality.batched_topk_thresholds(c, c, 0.02)
    starts, width, wrap = locality.batched_band_starts(c, c, thr, kb.band_tile_rows(L), circular=True)
    assert (starts.numpy() + width > L).any(), "no band crosses the seam"
    mk = torch.cat([c, c[:, :wrap]], 1)
    u = torch.cat([u, u[:, :wrap]], 1)
    return (c, mk, scale, u, thr, starts.to(dev), locality.topk_keep_count(L, 0.02), width), g


@pytest.mark.cuda
@pytest.mark.parametrize("D", CLOUD_WIDTHS)
@pytest.mark.parametrize("H", CLOUD_HEADS)
@pytest.mark.parametrize("op", CLOUD_OPS)
def test_cuda_batched_bwd_at_elasticity_shapes(cuda, op, H, D):
    """#8's dscale (through the forward kernel's output) and du against
    their plain versions at the elasticity op shapes; dscale bitwise equal
    over two runs."""
    args, g = _cloud_case(cuda, op, H, D)
    kw, (mq, mk, scale, u, thr, starts) = _fwd(args)
    out, stats = kb.posatt_batched_cuda(mq, mk, scale, u, thr, starts, stats=True, **kw)
    w = dict(width=kw["width"])
    ds = kb.posatt_batched_bwd_dscale_cuda(mq, mk, scale, u, out, g, stats, starts, **w)
    ds2 = kb.posatt_batched_bwd_dscale_cuda(mq, mk, scale, u, out, g, stats, starts, **w)
    du = kb.posatt_batched_bwd_du_cuda(mq, mk, scale, g, stats, starts, **w)
    torch.cuda.synchronize()
    assert torch.equal(ds, ds2)
    want_du = kb.posatt_batched_bwd_du_reference(mq, mk, scale, g, stats, starts, **w)
    size = kb.posatt_batched_bwd_du_reference(mq, mk, scale, g.abs(), stats, starts, **w)
    assert torch.isfinite(du).all()
    assert ((du - want_du).abs() <= ATOL + RTOL * size).all(), (du - want_du).abs().max()
    want_ds = kb.posatt_batched_bwd_dscale_reference(mq, mk, scale, u, g, stats, starts, **w)
    size = _dscale_size(mq, mk, scale, u, g, stats, starts, kw["width"])
    torch.testing.assert_close(ds / size, want_ds / size, rtol=DS_RTOL, atol=DS_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("D", CLOUD_WIDTHS)
@pytest.mark.parametrize("H", CLOUD_HEADS)
@pytest.mark.parametrize("op", CLOUD_OPS + ["served"])
def test_cuda_batched_fwd_at_elasticity_shapes(cuda, op, H, D):
    """#7 against its plain version at the elasticity op shapes, and at a
    served op (robust thresholds, no band), with its row statistics; the
    same bits over two runs."""
    if op == "served":
        (c, _, scale, u, _, _, _, _), _ = _cloud_case(cuda, "processor", H, D)
        thr = locality.robust_topk_threshold(distances.euclidean_sq(c, c), 0.02)
        args = (c, c, scale, u, thr, None, locality.topk_keep_count(c.shape[1], 0.02), 0)
    else:
        args, _ = _cloud_case(cuda, op, H, D)
    kw, pos = _fwd(args)
    out, stats = kb.posatt_batched_cuda(*pos, stats=True, **kw)
    again = kb.posatt_batched_cuda(*pos, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    torch.testing.assert_close(out, kb.posatt_batched_reference(*pos, **kw), rtol=RTOL, atol=ATOL)
    want = kb.posatt_batched_stats_reference(*pos[:3], *pos[4:], **kw)
    assert torch.equal(stats[:, :2], want[:, :2])  # bit-equal distances
    torch.testing.assert_close(stats[:, 2:], want[:, 2:], rtol=RTOL, atol=0.0)


@pytest.mark.cuda
def test_batched_no_grad_launches_the_forward_only(cuda):
    _, (mq, mk, lmda, u, loc, thr, band), _ = _batched_case(cuda, 2, 40, 50, 2, 5, 0.1, "none")
    lmda.requires_grad_(True)
    before = [f.launches for f in (kb.posatt_batched_cuda, kb.posatt_batched_bwd_dscale_cuda)]
    with torch.inference_mode():
        assert kb.position_attention_batched(mq, mk, lmda, u, loc).shape == (2, 40, 10)
    assert [f.launches for f in (kb.posatt_batched_cuda, kb.posatt_batched_bwd_dscale_cuda)] == [
        before[0] + 1, before[1]]


@pytest.mark.cuda
def test_three_head_elasticity_trains_on_the_card(cuda):
    """An elasticity model with ``model.n_head=3`` (narrow, two blocks):
    two training steps on the card launch #7 and #8 (4 / 4 / 3 launches of
    forward / dscale / du per step) and agree with the same steps on the
    CPU at the training bounds of test_torch_train.py."""
    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.train import benchmarks, loop

    cfg = configs.apply_overrides(
        configs.ELASTICITY, ["model.hid_dim=24", "model.n_head=3", "model.n_blocks=2"])
    perm = torch.tensor([[0, 1], [2, 3]])
    runs = {}
    for dev in ("cpu", cuda):
        problem = benchmarks.setup(cfg, ntrain=4, ntest=2, device=dev)
        if dev != "cpu":
            problem.model.load_state_dict(runs["cpu"][1])
        data = {k: torch.as_tensor(v, device=dev) for k, v in problem.train_data.items()}
        state = loop.TrainState(problem.model, loop.make_optimizer(problem.model.parameters(), 1e-3))
        epoch = loop.make_train_epoch(problem.task, loop.make_lr_schedule(1e-3, 10))
        counters = (kb.posatt_batched_cuda, kb.posatt_batched_bwd_dscale_cuda,
                    kb.posatt_batched_bwd_du_cuda)
        start = {k: v.detach().cpu().clone() for k, v in problem.model.state_dict().items()}
        before = [f.launches for f in counters]
        state, losses = epoch(state, None, data, perm.to(dev))
        torch.cuda.synchronize()
        launches = [f.launches - b for f, b in zip(counters, before)]
        assert launches == ([0, 0, 0] if dev == "cpu" else [8, 8, 6])
        runs["cpu" if dev == "cpu" else "cuda"] = (
            losses.cpu(), start, {k: v.cpu() for k, v in problem.model.state_dict().items()})
    torch.testing.assert_close(runs["cuda"][0], runs["cpu"][0], rtol=2e-4, atol=0.0)
    for k, v in runs["cpu"][2].items():
        torch.testing.assert_close(runs["cuda"][2][k], v, rtol=5e-3, atol=2e-5, msg=k)


@pytest.mark.cuda
def test_cuda_tensors_never_reach_the_plain_versions(cuda):
    """Every plain version raises here: a forward and backward on CUDA
    tensors still runs, through the kernels alone."""
    _, (mq, mk, lmda, u, loc, thr, band), w = _batched_case(cuda, 2, 900, 700, 2, 6, 0.02, "ring")
    names = [n for n in dir(kb) if n.endswith("_reference")]
    assert len(names) == 10  # five of #7/#8, five of #9-#12
    boom = mock.Mock(side_effect=AssertionError("a plain version ran on CUDA tensors"))
    patches = [mock.patch.object(kb, n, boom) for n in names]
    for p in patches:
        p.start()
    try:
        lm = lmda.clone().requires_grad_(True)
        x = u.clone().requires_grad_(True)
        (kb.position_attention_batched(mq, mk, lm, x, loc, thr, band) * w).sum().backward()
        with torch.no_grad():
            kb.position_attention_batched(mq, mk, lm, x, loc, thr, band)
        torch.cuda.synchronize()
    finally:
        for p in patches:
            p.stop()
    assert boom.call_count == 0
    assert torch.isfinite(lm.grad).all() and torch.isfinite(x.grad).all()


# ---------------------------------------- TF semantics: kernels #9 - #12

TF_SHAPES = [
    # B, L_q, L_k, H, V, thresholds: "none" (global), "thr" (a percentile
    # per row) or "ring" (angle-sorted rings with a circular band; the
    # coordinate kernels only)
    (2, 48, 48, 2, 3, "none"),
    (2, 37, 53, 8, 3, "thr"),
    (2, 300, 200, 2, 64, "none"),
    (1, 97, 1000, 4, 19, "thr"),
    (2, 1000, 97, 1, 130, "none"),  # two value tiles per head
    (3, 64, 64, 8, 64, "thr"),
    (2, 900, 700, 2, 8, "ring"),
    (2, 1000, 800, 8, 33, "ring"),  # L_out not a multiple of 256
    (2, 900, 700, 3, 80, "ring"),  # V not a multiple of the 64-column tile
    (2, 300, 200, 5, 100, "thr"),  # two head groups, the second short
    (1, 70, 1500, 8, 64, "none"),  # a window past the 1024-column list
]


def _tf_case(dev, B, Lq, Lk, H, V, kind, seed=0):
    """Coordinates (mq, mk on the extended key axis), pre-built halved
    distances, (H, 1) scales, values on the extended axis, thresholds on
    the full squared distances, starts, width; the wrapper's (mq, mk,
    scales, values, thr on the halved distances, band); a cotangent."""
    rng = np.random.default_rng(seed)
    to = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    if kind == "ring":
        mq, mk = to(_ring(rng, B, Lq)), to(_ring(rng, B, Lk))
    else:
        mq, mk = to(rng.random((B, Lq, 2))), to(rng.random((B, Lk, 2)))
    scales = to(rng.standard_normal((H, 1)) ** 2)
    values = to(rng.standard_normal((B, Lk, H * V)))
    g = to(rng.standard_normal((B, Lq, H * V)))
    half = 0.5 * distances.euclidean_sq(mq, mk)
    thr = band = None
    if kind == "thr":
        thr = locality.quantile_threshold(half, 0.3)
    elif kind == "ring":
        thr = locality.robust_topk_threshold(half, 0.02)
        starts, width, wrap = locality.batched_band_starts(
            mq, mk, 2.0 * thr, kb.band_tile_rows(Lq), circular=True)
        assert (starts.numpy() + width > Lk).any(), "no band crosses the seam"
        band = kb.BandSpec(starts.to(dev), width, wrap)
    mk_e, v_e = mk, values
    if band is not None:
        mk_e = torch.cat([mk, mk[:, : band.wrap]], 1)
        v_e = torch.cat([values, values[:, : band.wrap]], 1)
    launch = (mq, mk_e, 0.5 * scales, v_e, None if thr is None else 2.0 * thr,
              None if band is None else band.starts, 0 if band is None else band.width)
    return launch, half, (mq, mk, scales, values, thr, band), g


def _tf_size(att, keep, dist, values, g):
    """The size of dscale's summed terms per sample and head, (B, H):
    sum_i |w_i| + |r_i v_i| with T = G_h V_h^T, as the other kernels'
    tests normalise."""
    B, H, Lo, Li = att.shape
    t = torch.einsum("bihv,bjhv->bhij", g.reshape(B, Lo, H, -1), values.reshape(B, Li, H, -1))
    nd = torch.where(keep, dist, 0.0)[:, None]
    return ((att * t * nd).sum(-1).abs() + (att * t).sum(-1).abs() * (att * nd).sum(-1)).sum(-1)


def _check_tf_bwd(ds, ds2, dv, want_dv, size_dv, want_ds, size_ds):
    assert torch.equal(ds, ds2)
    assert torch.isfinite(dv).all()
    assert ((dv - want_dv).abs() <= ATOL + RTOL * size_dv).all(), (dv - want_dv).abs().max()
    torch.testing.assert_close(ds / size_ds, want_ds / size_ds, rtol=DS_RTOL, atol=DS_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Lq,Lk,H,V,kind", [s for s in TF_SHAPES if s[-1] != "ring"])
def test_cuda_tf_dist_kernels_match_plain(cuda, B, Lq, Lk, H, V, kind):
    """Kernel #9 and #10's two entry points against their plain versions."""
    _, dist, (_, _, scales, values, thr, _), g = _tf_case(cuda, B, Lq, Lk, H, V, kind)
    before = [f.launches for f in (kb.posatt_tf_cuda, kb.posatt_tf_bwd_dscale_cuda,
                                   kb.posatt_tf_bwd_dv_cuda)]
    out, stats = kb.posatt_tf_cuda(dist, thr, scales, values, stats=True)
    again = kb.posatt_tf_cuda(dist, thr, scales, values)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    torch.testing.assert_close(out, kb.posatt_tf_reference(dist, thr, scales, values), rtol=RTOL, atol=ATOL)
    want_st = kb.posatt_tf_stats_reference(dist, thr, scales)
    assert torch.equal(stats[:, :2], want_st[:, :2])
    torch.testing.assert_close(stats[:, 2:], want_st[:, 2:], rtol=RTOL, atol=0.0)
    ds = kb.posatt_tf_bwd_dscale_cuda(dist, scales, values, out, g, stats)
    ds2 = kb.posatt_tf_bwd_dscale_cuda(dist, scales, values, out, g, stats)
    dv = kb.posatt_tf_bwd_dv_cuda(dist, scales, g, stats)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip((kb.posatt_tf_cuda, kb.posatt_tf_bwd_dscale_cuda,
                                            kb.posatt_tf_bwd_dv_cuda), before)] == [2, 2, 1]
    want_dv, want_ds = kb.posatt_tf_bwd_reference(dist, thr, scales, values, g)
    size_dv, _ = kb.posatt_tf_bwd_reference(dist, thr, scales, values, g.abs())
    keep, dmin, _ = kb._tf_keep(dist, thr)
    size_ds = _tf_size(kb._tf_attention(dist, keep, dmin, scales), keep, dist, values, g)
    _check_tf_bwd(ds, ds2, dv, want_dv, size_dv, want_ds, size_ds)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Lq,Lk,H,V,kind", TF_SHAPES)
def test_cuda_tf_coord_kernels_match_plain(cuda, B, Lq, Lk, H, V, kind):
    """Kernel #11 and #12's two entry points against their plain versions."""
    (mq, mk, scale, v, thr, starts, width), _, _, g = _tf_case(cuda, B, Lq, Lk, H, V, kind)
    w = dict(width=width)
    out, stats = kb.posatt_tf_coord_cuda(mq, mk, scale, v, thr, starts, stats=True, **w)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, kb.posatt_tf_coord_reference(mq, mk, scale, v, thr, starts, **w),
                               rtol=RTOL, atol=ATOL)
    want_st = kb.posatt_batched_stats_reference(mq, mk, scale, thr, starts, keep_count=mk.shape[1], **w)
    assert torch.equal(stats[:, :2], want_st[:, :2])  # bit-equal distances
    torch.testing.assert_close(stats[:, 2:], want_st[:, 2:], rtol=RTOL, atol=0.0)
    ds = kb.posatt_tf_coord_bwd_dscale_cuda(mq, mk, scale, v, out, g, stats, starts, **w)
    ds2 = kb.posatt_tf_coord_bwd_dscale_cuda(mq, mk, scale, v, out, g, stats, starts, **w)
    dv = kb.posatt_tf_coord_bwd_dv_cuda(mq, mk, scale, g, stats, starts, **w)
    torch.cuda.synchronize()
    want_dv, want_ds = kb.posatt_tf_coord_bwd_reference(mq, mk, scale, v, g, thr, starts, **w)
    size_dv, _ = kb.posatt_tf_coord_bwd_reference(mq, mk, scale, v, g.abs(), thr, starts, **w)
    dist, keep, dmin = kb._tf_coord_rows(mq, mk, thr, starts, width)
    size_ds = _tf_size(kb._tf_attention(dist, keep, dmin, scale), keep, dist, v, g)
    _check_tf_bwd(ds, ds2, dv, want_dv, size_dv, want_ds, size_ds)


@pytest.mark.cuda
@pytest.mark.parametrize("V", CLOUD_WIDTHS)
@pytest.mark.parametrize("H", CLOUD_HEADS)
@pytest.mark.parametrize("op", CLOUD_OPS)
def test_cuda_tf_coord_fwd_at_elasticity_tf_shapes(cuda, op, H, V):
    """#11 against its plain version at the elasticity_tf op shapes (the
    coordinate launcher's folded scale and thresholds), with its row
    statistics; the same bits over two runs."""
    rng = np.random.default_rng(1)
    to = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda)
    (mq, mk, scale, _, thr, starts, _, width), _ = _cloud_case(cuda, op, H, 1)
    v = to(rng.standard_normal((mq.shape[0], mk.shape[1], H * V)))
    w = dict(width=width)
    out, stats = kb.posatt_tf_coord_cuda(mq, mk, scale, v, thr, starts, stats=True, **w)
    again = kb.posatt_tf_coord_cuda(mq, mk, scale, v, thr, starts, **w)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    torch.testing.assert_close(out, kb.posatt_tf_coord_reference(mq, mk, scale, v, thr, starts, **w),
                               rtol=RTOL, atol=ATOL)
    want_st = kb.posatt_batched_stats_reference(mq, mk, scale, thr, starts, keep_count=mk.shape[1], **w)
    assert torch.equal(stats[:, :2], want_st[:, :2])  # bit-equal distances
    torch.testing.assert_close(stats[:, 2:], want_st[:, 2:], rtol=RTOL, atol=0.0)


# the served elasticity_tf ops of #9: the processor (every column kept) and
# the encoder / decoder (a quantile threshold per row at 2 %) on the
# model's pre-built halved distances of an angle-sorted or an unsorted
# cloud; head counts from one to three groups of four
TF_DIST_OPS = ["processor", "served", "unsorted"]
TF_DIST_HEADS = [1, 3, 6, 8, 12]


@pytest.mark.cuda
@pytest.mark.parametrize("V", CLOUD_WIDTHS)
@pytest.mark.parametrize("H", TF_DIST_HEADS)
@pytest.mark.parametrize("op", TF_DIST_OPS)
def test_cuda_tf_dist_fwd_at_elasticity_tf_shapes(cuda, op, H, V):
    """#9 against its plain version at the served elasticity_tf op shapes,
    with its row statistics; the same bits over two runs."""
    rng = np.random.default_rng(2)
    to = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda)
    c = _ring(rng, 2, 972)
    if op == "unsorted":
        c = c[:, rng.permutation(972)]
    c = to(c)
    half = 0.5 * distances.euclidean_sq(c, c)
    thr = None if op == "processor" else locality.quantile_threshold(half, 0.02)
    scales = to(rng.standard_normal((H, 1)) ** 2)
    v = to(rng.standard_normal((2, 972, H * V)))
    out, stats = kb.posatt_tf_cuda(half, thr, scales, v, stats=True)
    again = kb.posatt_tf_cuda(half, thr, scales, v)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    torch.testing.assert_close(out, kb.posatt_tf_reference(half, thr, scales, v), rtol=RTOL, atol=ATOL)
    want_st = kb.posatt_tf_stats_reference(half, thr, scales)
    assert torch.equal(stats[:, :2], want_st[:, :2])
    torch.testing.assert_close(stats[:, 2:], want_st[:, 2:], rtol=RTOL, atol=0.0)


def _tf_oracle(mq, mk, scales, values, thr, band=None):
    """TF attention over materialized halved distances with autograd: the
    band holds every kept column, so the oracle needs none."""
    return kb.posatt_tf_reference(0.5 * distances.euclidean_sq(mq, mk), thr, scales, values)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Lq,Lk,H,V,kind", TF_SHAPES)
def test_tf_function_gradients_match_oracle_autograd(cuda, B, Lq, Lk, H, V, kind):
    """PosAttTFCoord and PosAttTF: one forward + backward launches the
    forward and each backward entry point once; gradients match autograd
    of the oracle."""
    _, half, (mq, mk, scales, values, thr, band), w = _tf_case(cuda, B, Lq, Lk, H, V, kind)

    def grads(fn, w):
        s = scales.clone().requires_grad_(True)
        x = values.clone().requires_grad_(True)
        out = fn(s, x)
        (out * w).sum().backward()
        return out.detach(), s.grad, x.grad

    paths = {
        "coords": ((kb.posatt_tf_coord_cuda, kb.posatt_tf_coord_bwd_dscale_cuda,
                    kb.posatt_tf_coord_bwd_dv_cuda),
                   lambda s, x: kb.position_attention_batched_tf_coords(mq, mk, s, x, thr, band)),
        "dist": ((kb.posatt_tf_cuda, kb.posatt_tf_bwd_dscale_cuda, kb.posatt_tf_bwd_dv_cuda),
                 lambda s, x: kb.position_attention_batched_dist(half, s, x, thr)),
    }
    want = grads(lambda s, x: _tf_oracle(mq, mk, s, x, thr), w)
    size = grads(lambda s, x: _tf_oracle(mq, mk, s, x, thr), w.abs())[2]
    for name, (counters, fn) in paths.items():
        before = [f.launches for f in counters]
        got = grads(fn, w)
        torch.cuda.synchronize()
        assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1], name
        torch.testing.assert_close(got[0], want[0], rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(got[1], want[1], rtol=DS_RTOL, atol=DS_ATOL * want[1].abs().max().item())
        assert ((got[2] - want[2]).abs() <= ATOL + RTOL * size).all(), (name, (got[2] - want[2]).abs().max())


@pytest.mark.cuda
def test_tf_model_launches_the_tf_kernels_only(cuda):
    """A small PiTTFPointCloud on the card: with thresholds every op runs
    #11 and #12, without them #9 and #10; no plain version runs."""
    from position_induced_transformer_torch.models import PiTTFPointCloud

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 64, 5)).astype(np.float32)).to(cuda)
    model = PiTTFPointCloud(5, 1, 16, 4, 10.0, 10.0, n_blocks=2,
                            generator=torch.Generator().manual_seed(0)).to(cuda)
    thr = locality.batched_halfdist_percentile_thresholds(x[..., :2].contiguous(), 10.0)
    names = [n for n in dir(kb) if n.endswith("_reference")]
    boom = mock.Mock(side_effect=AssertionError("a plain version ran on CUDA tensors"))
    counters = [kb.posatt_tf_coord_cuda, kb.posatt_tf_coord_bwd_dscale_cuda,
                kb.posatt_tf_coord_bwd_dv_cuda, kb.posatt_tf_cuda, kb.posatt_tf_bwd_dscale_cuda,
                kb.posatt_tf_bwd_dv_cuda, kb.posatt_batched_cuda]
    with mock.patch.multiple(kb, **{n: boom for n in names}):
        for args, expect in (((thr, thr), [4, 4, 4, 0, 0, 0, 0]), ((), [0, 0, 0, 4, 4, 4, 0])):
            before = [f.launches for f in counters]
            model(x, *args).sum().backward()
            torch.cuda.synchronize()
            assert [f.launches - b for f, b in zip(counters, before)] == expect
    assert boom.call_count == 0
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


@pytest.mark.cuda
@pytest.mark.parametrize("name,per_step", [("darcy", [6, 0, 6, 5]), ("sod", [4, 0, 4, 3]),
                                           ("cylinder", [6, 0, 6, 5])])
def test_fixed_mesh_training_step_launch_counts(cuda, name, per_step):
    """Two training steps of full-width Darcy (43^2, 4 blocks), sod (1
    head, 2 blocks) or cylinder (4390 -> 896 points, hid 256, 1 head, 4
    blocks) at batch 8 on the card launch #1/#2/#3/#4 ``per_step`` times a
    step (one forward and one dscale a layer, du for every layer but the
    encoder, whose input needs no gradient; no #2) and agree with the same
    steps on the CPU at the training bounds of test_torch_train.py."""
    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.train import benchmarks, loop

    cfg = configs.get(name)
    perm = torch.arange(16).reshape(2, 8)
    counters = (kp.posatt_fixed_cuda, kp.posatt_stats_cuda,
                kp.posatt_bwd_dscale_cuda, kp.posatt_bwd_du_cuda)
    runs = {}
    for dev in ("cpu", cuda):
        problem = benchmarks.setup(cfg, ntrain=16, ntest=2, device=dev)
        if dev != "cpu":
            problem.model.load_state_dict(runs["cpu"][1])
        data = {k: torch.as_tensor(v, device=dev) for k, v in problem.train_data.items()}
        state = loop.TrainState(problem.model, loop.make_optimizer(problem.model.parameters(), 1e-3))
        epoch = loop.make_train_epoch(problem.task, loop.make_lr_schedule(1e-3, 10))
        start = {k: v.detach().cpu().clone() for k, v in problem.model.state_dict().items()}
        before = [f.launches for f in counters]
        state, losses = epoch(state, problem.geom, data, perm.to(dev))
        if dev != "cpu":
            torch.cuda.synchronize()
        launches = [f.launches - b for f, b in zip(counters, before)]
        assert launches == ([0, 0, 0, 0] if dev == "cpu" else [2 * n for n in per_step])
        runs["cpu" if dev == "cpu" else "cuda"] = (
            losses.cpu(), start, {k: v.cpu() for k, v in problem.model.state_dict().items()})
    torch.testing.assert_close(runs["cuda"][0], runs["cpu"][0], rtol=2e-4, atol=0.0)
    for k, v in runs["cpu"][2].items():
        torch.testing.assert_close(runs["cuda"][2][k], v, rtol=5e-3, atol=2e-5, msg=k)


@pytest.mark.cuda
def test_darcy_zssr_forward_at_421_matches_plain(cuda):
    """The full-width Darcy model bound to the 421^2 grid (177,241 points):
    one no-grad forward launches #1 six times (encoder, 4 blocks, decoder)
    and nothing else, and agrees with the plain attention on the card at
    rtol 1e-4 / atol 1e-5 (the model-level bound)."""
    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.models import pit
    from position_induced_transformer_torch.train import benchmarks

    problem = benchmarks.setup(configs.DARCY, ntrain=2, ntest=2, downsampling=1, device=cuda)
    batch = {"x": torch.from_numpy(problem.test_data["x"]).to(cuda)}
    counters = (kp.posatt_fixed_cuda, kp.posatt_stats_cuda,
                kp.posatt_bwd_dscale_cuda, kp.posatt_bwd_du_cuda)
    before = [f.launches for f in counters]
    with torch.inference_mode():
        got = problem.task.forward(problem.geom, batch)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [6, 0, 0, 0]
    plain = lambda dist, lmda, inputs, locality, thr=None: posatt.position_attention(
        dist, lmda, inputs, locality, thr=thr)
    with torch.inference_mode(), mock.patch.object(pit, "position_attention_fixed", plain):
        want = problem.task.forward(problem.geom, batch)
    assert got.shape == (2, 421, 421, 1)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


# ------------------------------------------------ vorticity and NACA paths

FIXED_COUNTERS = (kp.posatt_fixed_cuda, kp.posatt_stats_cuda,
                  kp.posatt_bwd_dscale_cuda, kp.posatt_bwd_du_cuda)


def _one_step(problem, dev, state_dict=None):
    """One optimizer step on the first two training samples: the loss, the
    weights before and after, and each fixed-mesh kernel's launches."""
    from position_induced_transformer_torch.train import loop

    if state_dict is not None:
        problem.model.load_state_dict(state_dict)
    data = {k: torch.as_tensor(v, device=dev) for k, v in problem.train_data.items()}
    state = loop.TrainState(problem.model, loop.make_optimizer(problem.model.parameters(), 1e-3))
    epoch = loop.make_train_epoch(problem.task, loop.make_lr_schedule(1e-3, 10))
    start = {k: v.detach().cpu().clone() for k, v in problem.model.state_dict().items()}
    before = [f.launches for f in FIXED_COUNTERS]
    state, losses = epoch(state, problem.geom, data, torch.tensor([[0, 1]], device=dev))
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    launches = [f.launches - b for f, b in zip(FIXED_COUNTERS, before)]
    return losses.cpu(), start, {k: v.cpu() for k, v in problem.model.state_dict().items()}, launches


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["full", "dots", "none"])
def test_vorticity_rollout_step_launch_counts(cuda, mode):
    """One BPTT step of a narrow vorticity model (hid 32, 2 blocks: 4
    attention ops a forward; 3 rollout steps, B 2) on the 64^2 grid under
    each remat mode: the forward #1 runs 12 times, and 12 more under
    ``full`` and ``dots`` (the checkpointed forward is recomputed in the
    backward; a ctypes launch is no matmul ``dots`` could keep); #2 never;
    #3 12 times; #4 11 times (the first window needs no gradient, so the
    first encoder takes no du). Loss and weights agree with the CPU at the
    training bounds."""
    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.train import benchmarks

    cfg = configs.apply_overrides(
        configs.VORTICITY, ["model.hid_dim=32", "model.n_blocks=2", "rollout_steps=3"])
    runs = {}
    for dev in ("cpu", cuda):
        problem = benchmarks.setup(cfg, ntrain=2, ntest=1, device=dev)
        problem.task = dataclasses.replace(problem.task, remat_rollout=mode)
        runs[str(dev)] = _one_step(problem, dev, runs.get("cpu", (None, None))[1])
    assert runs["cpu"][3] == [0, 0, 0, 0]
    assert runs["cuda"][3] == [24 if mode != "none" else 12, 0, 12, 11]
    torch.testing.assert_close(runs["cuda"][0], runs["cpu"][0], rtol=2e-4, atol=0.0)
    for k, v in runs["cpu"][2].items():
        torch.testing.assert_close(runs["cuda"][2][k], v, rtol=5e-3, atol=2e-5, msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("L_out,L_in,B,H,D,loc", [
    (256, 4096, 20, 2, 12, 0.02),  # vorticity encoder
    (256, 256, 20, 2, 256, 1.0),  # vorticity processor
    (4096, 256, 20, 2, 256, 0.02),  # vorticity decoder
    (64, 60000, 10, 2, 3, 0.02),  # splits of L_in through scratch
])
def test_recomputed_forward_gives_the_first_forwards_bits(cuda, L_out, L_in, B, H, D, loc):
    """Under ``torch.utils.checkpoint`` the backward reruns #1: the
    recomputed output, M and L are the first forward's bits (fresh split
    scratch, the per-stream counters left at zero), and the gradients are
    those of the same op without a checkpoint."""
    from torch.utils.checkpoint import checkpoint

    dist, lmda, u = _inputs(cuda, L_out, L_in, B, H, D)
    thr = locality.quantile_threshold(dist, loc) if loc < 1.0 else None
    seen = []
    launch = kp._FORWARDS[3]

    def recording(*a, **kw):
        got = launch(*a, **kw)
        seen.append([t.clone() for t in got] if isinstance(got, tuple) else [got.clone()])
        return got

    w = torch.randn(B, L_out, H * D, device=cuda)

    def grads(wrap):
        lm, x = lmda.clone().requires_grad_(True), u.clone().requires_grad_(True)
        f = lambda x: kp.position_attention_fixed(dist, lm, x, loc, thr=thr)
        out = wrap(f, x)
        (out * w).sum().backward()
        return out.detach(), lm.grad, x.grad

    with mock.patch.dict(kp._FORWARDS, {3: recording}):
        ckpt = grads(lambda f, x: checkpoint(f, x, use_reentrant=False))
    torch.cuda.synchronize()
    assert len(seen) == 2 and len(seen[0]) == 3
    for first, again in zip(*seen):
        assert torch.equal(first, again)
    plain = grads(lambda f, x: f(x))
    for a, b in zip(ckpt, plain):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_naca_step_launch_counts(cuda):
    """One training step of a narrow NACA model (hid 32, 2 blocks; the full
    221 x 51 C-grid and 56 x 13 latent, setup-time thresholds and decoder
    band) on the card launches #7 4 times, #8's dscale 4 and du 3 (the
    encoder's input needs no gradient), and agrees with the CPU."""
    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.train import benchmarks

    cfg = configs.apply_overrides(configs.NACA, ["model.hid_dim=32", "model.n_blocks=2"])
    counters = (kb.posatt_batched_cuda, kb.posatt_batched_bwd_dscale_cuda,
                kb.posatt_batched_bwd_du_cuda)
    runs = {}
    for dev in ("cpu", cuda):
        problem = benchmarks.setup(cfg, ntrain=2, ntest=1, device=dev)
        assert "band_up" in problem.train_data
        before = [f.launches for f in counters]
        runs[str(dev)] = _one_step(problem, dev, runs.get("cpu", (None, None))[1])
        runs[str(dev)] += ([f.launches - b for f, b in zip(counters, before)],)
    assert runs["cpu"][4] == [0, 0, 0] and runs["cuda"][4] == [4, 4, 3]
    torch.testing.assert_close(runs["cuda"][0], runs["cpu"][0], rtol=2e-4, atol=0.0)
    for k, v in runs["cpu"][2].items():
        torch.testing.assert_close(runs["cuda"][2][k], v, rtol=5e-3, atol=2e-5, msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["encoder", "processor", "decoder"])
def test_cuda_batched_kernels_at_the_naca_shapes(cuda, op):
    """#7 and #8 at NACA's three ops on ``setup_naca``'s synthetic data at
    B 20, H 1: the encoder 728 x 120 (D 2, thresholds, no band), the
    processor 728^2 (D 128, global) and the decoder 11,271 x 728 (D 128,
    thresholds and the plain band of 256-row tiles; L_out is no multiple of
    256) against their plain versions."""
    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.train import benchmarks

    problem = benchmarks.setup(configs.NACA, ntrain=20, ntest=1, device=cuda)
    batch = {k: torch.from_numpy(np.asarray(v)).to(cuda) for k, v in problem.train_data.items()}
    geom = problem.task.geom_fn(batch)
    rng = np.random.default_rng(5)
    D = {"encoder": 2, "processor": 128, "decoder": 128}[op]
    mq, mk = {"encoder": (geom.mesh_ltt, geom.mesh_in), "processor": (geom.mesh_ltt, geom.mesh_ltt),
              "decoder": (geom.mesh_out, geom.mesh_ltt)}[op]
    loc = 1.0 if op == "processor" else 0.02
    thr = {"encoder": geom.thr_down, "processor": None, "decoder": geom.thr_up}[op]
    band = geom.band_up if op == "decoder" else None
    u = torch.from_numpy(rng.standard_normal((20, mk.shape[1], D)).astype(np.float32)).to(cuda)
    if op == "encoder":
        u = batch["x"]
    scale = posatt.bandwidth_scale(torch.tensor([[[0.7]]], device=cuda)).reshape(1, 1)
    starts, width = (None, 0) if band is None else (band.starts, band.width)
    kw = dict(keep_count=locality.topk_keep_count(mk.shape[1], loc), width=width)
    out, stats = kb.posatt_batched_cuda(mq, mk, scale, u, thr, starts, stats=True, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, kb.posatt_batched_reference(mq, mk, scale, u, thr, starts, **kw),
                               rtol=RTOL, atol=ATOL)
    want = kb.posatt_batched_stats_reference(mq, mk, scale, thr, starts, **kw)
    assert torch.equal(stats[:, :2], want[:, :2])
    g = torch.from_numpy(rng.standard_normal((20, mq.shape[1], D)).astype(np.float32)).to(cuda)
    w = dict(width=width)
    ds = kb.posatt_batched_bwd_dscale_cuda(mq, mk, scale, u, out, g, stats, starts, **w)
    du = kb.posatt_batched_bwd_du_cuda(mq, mk, scale, g, stats, starts, **w)
    torch.cuda.synchronize()
    want_du = kb.posatt_batched_bwd_du_reference(mq, mk, scale, g, stats, starts, **w)
    size = kb.posatt_batched_bwd_du_reference(mq, mk, scale, g.abs(), stats, starts, **w)
    assert ((du - want_du).abs() <= ATOL + RTOL * size).all(), (du - want_du).abs().max()
    want_ds = kb.posatt_batched_bwd_dscale_reference(mq, mk, scale, u, g, stats, starts, **w)
    size = _dscale_size(mq, mk, scale, u, g, stats, starts, width)
    torch.testing.assert_close(ds / size, want_ds / size, rtol=DS_RTOL, atol=DS_ATOL)


# cylinder's three ops at its training batch (B 200, H 1): the encoder
# 896 x 4390 (D 5, locality 0.01), the processor 896^2 (every entry kept,
# D 256) and the decoder 4390 x 896 (D 256), on its own cloud
CYLINDER_OPS = ["encoder", "processor", "decoder"]


def _cylinder_op(dev, op, seed=0):
    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.data import synthetic
    from position_induced_transformer_torch.models import build_geometry

    cfg = configs.CYLINDER
    m = cfg.model
    _, mesh, ltt = synthetic.cylinder(n_traj=1)
    geom = build_geometry(mesh, ltt, mesh, metric=cfg.metric, en_loc=m.en_loc,
                          de_loc=m.de_loc, device=dev)
    dist, thr, D = {
        "encoder": (geom.dist_down, geom.thr_down, m.in_dim + m.space_dim),
        "processor": (geom.dist_proc, None, m.hid_dim),
        "decoder": (geom.dist_up, geom.thr_up, m.hid_dim),
    }[op]
    if thr is None:
        thr = torch.full((dist.shape[0], 1), float("inf"), device=dev)
    rng = np.random.default_rng(seed)
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    B, H = cfg.batch_size, m.n_head
    scale = posatt.bandwidth_scale(to(rng.random((H, 1, 1)))).reshape(H, 1)
    u = to(rng.random((B, dist.shape[1], D)))
    g = to(rng.standard_normal((B, dist.shape[0], H * D)))
    return dist, thr, scale, u, g


@pytest.mark.cuda
@pytest.mark.parametrize("op", CYLINDER_OPS)
def test_cuda_fixed_kernels_at_the_cylinder_shapes(cuda, op):
    """#1 (with M and L), #3 and #4 against their plain versions at one of
    cylinder's ops, each launched once."""
    dist, thr, scale, u, g = _cylinder_op(cuda, op)
    B, L_out, HD = g.shape
    counters = (kp.posatt_fixed_cuda, kp.posatt_bwd_dscale_cuda, kp.posatt_bwd_du_cuda)
    before = [f.launches for f in counters]
    out, M, L = kp.posatt_fixed_cuda(dist, thr, scale, u, stats=True)
    ds = kp.posatt_bwd_dscale_cuda(dist, thr, scale, M, L, g, u, out)
    du = kp.posatt_bwd_du_cuda(dist, thr, scale, M, L, g)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1]
    want, M_want, L_want = kp.posatt_fixed_reference(dist, thr, scale, u, stats=True)
    H = scale.shape[0]
    torch.testing.assert_close(out, want.permute(1, 2, 0, 3).reshape(B, L_out, HD),
                               rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(M, M_want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(L, L_want, rtol=RTOL, atol=ATOL)
    want_du = kp.posatt_bwd_du_reference(dist, thr, scale, M_want, L_want, g)
    size = kp.posatt_bwd_du_reference(dist, thr, scale, M_want, L_want, g.abs())
    assert ((du - want_du).abs() <= ATOL + RTOL * size).all(), (du - want_du).abs().max()
    want_ds = kp.posatt_bwd_dscale_reference(dist, thr, scale, M_want, L_want, g, u, out)
    keep = (dist <= thr) & (dist < float("inf"))
    p = torch.where(keep, torch.exp(-dist[None] * scale[:, :, None] - M_want), 0.0) / L_want
    t = torch.einsum("bihk,bjk->hij", g.reshape(B, L_out, H, -1), u)
    d = torch.where(keep, dist, 0.0)
    size = ((p * t * d).sum(-1).abs() + (p * t).sum(-1).abs() * (p * d).sum(-1)).sum(-1, keepdim=True)
    torch.testing.assert_close(ds / size, want_ds / size, rtol=DS_RTOL, atol=DS_ATOL)


@pytest.mark.cuda
def test_cli_trains_cylinder_on_the_card(cuda, tmp_path, capsys):
    """``train --benchmark cylinder`` through the command line with the
    default device: 2 steps at batch 200 and one eval batch, 6/0/6/5
    launches of #1-#4 a step and 6 of #1 for the eval batch; finite
    metrics and a checkpoint that evaluates on the card."""
    import json

    from position_induced_transformer_torch import cli
    from position_induced_transformer_torch.train import evaluate

    counters = (kp.posatt_fixed_cuda, kp.posatt_stats_cuda,
                kp.posatt_bwd_dscale_cuda, kp.posatt_bwd_du_cuda)
    before = [f.launches for f in counters]
    ckpt = str(tmp_path / "cylinder.pt")
    assert cli.main(["train", "--benchmark", "cylinder", "--epochs", "1", "--ntrain", "400",
                     "--ntest", "200", "--checkpoint", ckpt]) == 0
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [2 * 6 + 6, 0, 2 * 6, 2 * 5]
    final = json.loads(capsys.readouterr().out.splitlines()[-1])["final"]
    assert np.isfinite([final[k] for k in ("train_loss", "rel_l2")]).all()
    from position_induced_transformer_torch import configs

    cfg = dataclasses.replace(configs.CYLINDER, ntrain=400)
    result = evaluate.evaluate(cfg, ckpt, ntest=200)
    assert len(result["rollout_rel_l2_step"]) == 10 and np.isfinite(result["rollout_rel_l2_mean"])


# ------------------------------------- #13: the fixed-mesh TF family

# L_out, L_in, B, H, V, bandwidth, locality, r of each head (None: drawn),
# rows that keep nothing ("half": every other row; "one": one row of one
# tile)
TF_FIXED_SHAPES = [
    (1024, 1024, 5, 2, 32, "tan_sin", 1.0, None, None),  # burgers_tf's encoder
    (256, 4096, 8, 1, 256, "tan_sin", 1.0, None, None),  # vorticity_tf's encoder: L_in split
    (4096, 256, 8, 1, 256, "tan_sin", 8.0, None, None),  # its decoder: dv splits L_out
    (300, 700, 3, 2, 64, "tan", 2.0, (-0.35, 0.25), None),  # naca_tf's signs
    (130, 77, 2, 3, 33, "tan", 20.0, (-0.5, 0.0, 0.4), None),  # a zero-scale head
    (100, 300, 9, 8, 16, "square", 200.0, None, None),  # nine samples: two tiles
    (64, 64, 2, 2, 12, "square", 1.0, None, "half"),  # rows that keep nothing
    (300, 1100, 4, 2, 16, "tan_sin", 2.0, None, "one"),  # one such row in a tile
    (520, 333, 8, 2, 8, "tan", 3.0, (0.0, -0.2), None),  # zero and negative heads
    (301, 5003, 2, 2, 20, "tan", 0.5, (0.3, 0.6), "one"),  # a split cuts ragged lists
]


def _tf_fixed_case(dev, L_out, L_in, B, H, V, kind, loc, r, empty=None, seed=0, ordered=False):
    """One op's arguments: random distances or, ``ordered``, those between
    two sorted point sets on a line (a row keeps a band of neighbouring
    columns, as on a grid)."""
    from position_induced_transformer_torch.kernels import posatt_tf_fixed as kf
    from position_induced_transformer_torch.models import pit_tf

    rng = np.random.default_rng(seed)
    if ordered:
        a, b = np.sort(rng.random(L_out)), np.sort(rng.random(L_in))
        dist = np.abs(a[:, None] - b[None, :]).astype(np.float32)
    else:
        dist = rng.random((L_out, L_in)).astype(np.float32)
    dist = torch.from_numpy(dist).to(dev)
    thr = kf.percentile_thresholds(dist, loc)
    if empty == "half":  # half the rows below their minimum
        thr[::2] = dist[::2].amin(-1, keepdim=True) * 0.5
    elif empty == "one":  # one row of the second row tile, every head
        thr[130] = torch.stack([dist[130].amin() * 0.5, dist[130].amax() * 2.0])
    if r is None:
        r = rng.uniform(-0.8, 0.8, H)
    r = torch.tensor(np.asarray(r, np.float32).reshape(H, 1), device=dev)
    values = torch.from_numpy(rng.standard_normal((B, L_in, H * V)).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((B, L_out, H * V)).astype(np.float32)).to(dev)
    return dist, thr, r, pit_tf._bandwidth(r, kind), values, g, kf.KINDS[kind]


def _tf_fixed_ds_size(dist, thr, scale, values, out, g, mode):
    """The size of dscale's summed terms per head, sum_ij att |T d| + att d
    |r|: the float32 rounding of the cancelling sum scales with these."""
    from position_induced_transformer_torch.kernels import posatt_tf_fixed as kf

    att, keep = kf._attention(dist, thr, scale, mode)
    H, L_out, L_in = att.shape
    B = values.shape[0]
    gh = g.reshape(B, L_out, H, -1)
    t = torch.einsum("bihv,bjhv->hij", gh, values.reshape(B, L_in, H, -1))
    rr = torch.einsum("bihv,bihv->hi", gh, out.reshape(B, L_out, H, -1))
    d = dist if keep is None else torch.where(keep, dist, 0.0)
    return (att * (t * d).abs()).sum((-1, -2)) + ((att * d).sum(-1) * rr.abs()).sum(-1) + 1e-30


def _check_tf_fixed(dist, thr, scale, values, g, mode):
    """#13's forward (its row statistics and kept-step lists), dv and
    dscale against their plain versions, each launched once with the
    forward's lists and run again to the same bits; returns the lists."""
    from position_induced_transformer_torch.kernels import posatt_tf_fixed as kf

    counters = (kf.posatt_tf_fixed_cuda, kf.posatt_tf_fixed_bwd_dscale_cuda,
                kf.posatt_tf_fixed_bwd_dv_cuda)
    before = [f.launches for f in counters]
    out, stats, steps = kf.posatt_tf_fixed_cuda(dist, thr, scale, values, mode)
    ds = kf.posatt_tf_fixed_bwd_dscale_cuda(dist, thr, scale, values, out, g, stats, mode, steps)
    dv = kf.posatt_tf_fixed_bwd_dv_cuda(dist, thr, scale, g, stats, mode, steps)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1]
    # the same bits again, the backward without lists walking every step
    # (an unlisted step's weights are all 0: skipping it changes no bit)
    assert torch.equal(out, kf.posatt_tf_fixed_cuda(dist, thr, scale, values, mode)[0])
    assert torch.equal(ds, kf.posatt_tf_fixed_bwd_dscale_cuda(dist, thr, scale, values, out, g,
                                                              stats, mode))
    assert torch.equal(dv, kf.posatt_tf_fixed_bwd_dv_cuda(dist, thr, scale, g, stats, mode))
    if thr is None:
        assert steps is None
    else:
        want_steps = kf.posatt_tf_fixed_lists_reference(dist, thr, scale, mode, steps.fwd_tile,
                                                        steps.dv_tile)
        for name, got_l, want_l in zip(kf.KeptSteps._fields, steps, want_steps):
            assert torch.equal(got_l, want_l) if torch.is_tensor(got_l) else got_l == want_l, name
    want = kf.posatt_tf_fixed_reference(dist, thr, scale, values, mode)
    torch.testing.assert_close(out, want, rtol=RTOL, atol=ATOL)
    want_stats = kf.posatt_tf_fixed_stats_reference(dist, thr, scale, mode)
    assert torch.equal(torch.isinf(stats), torch.isinf(want_stats))
    finite = ~torch.isinf(want_stats)
    torch.testing.assert_close(stats[finite], want_stats[finite], rtol=RTOL, atol=ATOL)
    want_dv = kf.posatt_tf_fixed_bwd_dv_reference(dist, thr, scale, g, mode)
    size = kf.posatt_tf_fixed_bwd_dv_reference(dist, thr, scale, g.abs(), mode)
    assert ((dv - want_dv).abs() <= ATOL + RTOL * size).all(), (dv - want_dv).abs().max()
    want_ds = kf.posatt_tf_fixed_bwd_dscale_reference(dist, thr, scale, values, want, g, mode)
    size = _tf_fixed_ds_size(dist, thr, scale, values, want, g, mode)
    torch.testing.assert_close(ds / size, want_ds / size, rtol=DS_RTOL, atol=DS_ATOL)
    return steps


@pytest.mark.cuda
@pytest.mark.parametrize("L_out,L_in,B,H,V,kind,loc,r,empty", TF_FIXED_SHAPES)
def test_cuda_tf_fixed_kernels_match_plain(cuda, L_out, L_in, B, H, V, kind, loc, r, empty):
    """#13's forward (its row statistics and kept-step lists, equal to the
    plain version's), dv and dscale against their plain versions, each
    launched once; each run twice gives the same bits."""
    dist, thr, _, scale, values, g, mode = _tf_fixed_case(cuda, L_out, L_in, B, H, V, kind, loc, r,
                                                          empty)
    _check_tf_fixed(dist, thr, scale, values, g, mode)


@pytest.mark.cuda
def test_tf_fixed_split_cuts_the_lists(cuda):
    """On ordered points (1024 rows, 8192 columns, 1 % kept) the forward
    splits its reduction into ranges, each block walking the listed steps
    of its range, and the lists hold a small share of the steps; the splits
    still sum to the plain version."""
    from position_induced_transformer_torch.kernels import posatt_tf_fixed as kf

    shape = (1024, 8192, 8, 1, 64, "tan_sin", 1.0, None)
    dist, thr, _, scale, values, g, mode = _tf_fixed_case(cuda, *shape, ordered=True)
    assert kf._split_plan(8, 1024, 8192, 1, 64)[0] > 1
    steps = _check_tf_fixed(dist, thr, scale, values, g, mode)
    assert 0 < steps.fwd_cnt.sum() < steps.fwd_idx.numel() // 4


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [TF_FIXED_SHAPES[0], TF_FIXED_SHAPES[3], TF_FIXED_SHAPES[5]])
def test_tf_fixed_row_tile_changes_no_bit(cuda, shape):
    """The forward and dv give the same bits whether a block owns 128, 64
    or 32 rows (columns): each output sums its terms in one thread, in
    order."""
    from position_induced_transformer_torch.kernels import posatt_tf_fixed as kf

    dist, thr, _, scale, values, g, mode = _tf_fixed_case(cuda, *shape)
    runs = []
    for bm in (128, 64, 32):
        with mock.patch.object(kf, "_row_tile", lambda *a, bm=bm: bm):
            out, stats, steps = kf.posatt_tf_fixed_cuda(dist, thr, scale, values, mode)
            runs.append((out, kf.posatt_tf_fixed_bwd_dv_cuda(dist, thr, scale, g, stats, mode, steps)))
    for out, dv in runs[1:]:
        assert torch.equal(out, runs[0][0]) and torch.equal(dv, runs[0][1])


@pytest.mark.cuda
@pytest.mark.parametrize("op,r", [("down", (-0.35, 0.25)), ("up", (0.3, 0.0))])
def test_tf_fixed_on_the_naca_tf_cgrid(cuda, op, r):
    """#13 at naca_tf's encoder (0.5 % of a row kept) and decoder (2 %) on
    its C-grid-ordered geometry at full size, with heads of either sign and
    of scale 0; a positive head lists a small share of the steps."""
    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.kernels import posatt_tf_fixed as kf
    from position_induced_transformer_torch.models import pit_tf
    from position_induced_transformer_torch.train import benchmarks

    cfg = configs.NACA_TF
    problem = benchmarks.setup(cfg, ntrain=cfg.batch_size, ntest=2, device=cuda)
    geom = problem.geom
    dist, thr = (geom.m_cross_t, geom.thr_down) if op == "down" else (geom.m_cross, geom.thr_up)
    rng = np.random.default_rng(5)
    H, V = 2, 32
    rr = torch.tensor(np.asarray(r, np.float32).reshape(H, 1), device=cuda)
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)
    values = to(rng.standard_normal((cfg.batch_size, dist.shape[1], H * V)))
    g = to(rng.standard_normal((cfg.batch_size, dist.shape[0], H * V)))
    steps = _check_tf_fixed(dist, thr, pit_tf._bandwidth(rr, "tan"), values, g, 1)
    positive = int(np.argmax(r))
    share = steps.fwd_cnt[positive].sum().item() / steps.fwd_idx[positive].numel()
    assert share < 0.25, share


@pytest.mark.cuda
@pytest.mark.parametrize("L_out,L_in,B,H,V,kind,loc,r,empty", TF_FIXED_SHAPES[:5])
def test_tf_fixed_function_gradients_match_plain_autograd(cuda, L_out, L_in, B, H, V, kind, loc, r,
                                                          empty):
    """One forward + backward of ``position_attention_tf_fixed`` with r
    through the bandwidth launches each entry point once; the gradients in
    r and the values against torch.autograd of the plain version."""
    from position_induced_transformer_torch.kernels import posatt_tf_fixed as kf
    from position_induced_transformer_torch.models import pit_tf

    dist, thr, r0, scale, values, g, mode = _tf_fixed_case(cuda, L_out, L_in, B, H, V, kind, loc, r,
                                                           empty)

    def grads(fn, w=g):
        rr = r0.clone().requires_grad_(True)
        x = values.clone().requires_grad_(True)
        out = fn(dist, thr, pit_tf._bandwidth(rr, kind), x, kind, loc)
        (out * w).sum().backward()
        return out.detach(), rr.grad, x.grad

    def plain(dist, thr, s, x, kind, loc):
        return kf.posatt_tf_fixed_reference(dist, None if loc > 100 else thr, s, x, kf.KINDS[kind])

    counters = (kf.posatt_tf_fixed_cuda, kf.posatt_tf_fixed_bwd_dscale_cuda,
                kf.posatt_tf_fixed_bwd_dv_cuda)
    before = [f.launches for f in counters]
    got = grads(kf.position_attention_tf_fixed)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1]
    want = grads(plain)
    torch.testing.assert_close(got[0], want[0], rtol=RTOL, atol=ATOL)
    # d r = dscale * |d scale / d r|, normalised by dscale's terms' size
    rr = r0.clone().requires_grad_(True)
    pit_tf._bandwidth(rr, kind).sum().backward()
    thr_used = None if loc > 100 else thr
    size_r = _tf_fixed_ds_size(dist, thr_used, scale, values, want[0], g, mode).reshape(H, 1)
    size_r = size_r * rr.grad.abs() + 1e-30
    torch.testing.assert_close(got[1] / size_r, want[1] / size_r, rtol=DS_RTOL, atol=DS_ATOL)
    size_x = grads(plain, g.abs())[2]
    assert ((got[2] - want[2]).abs() <= ATOL + RTOL * size_x).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name,overrides,per_step", [
    ("burgers_tf", ["grid=256", "latent_grid=128", "model.hid_dim=32"], 7),
    ("naca_tf", ["grid=45,11", "latent_grid=23,6", "model.hid_dim=32"], 6),
])
def test_tf_fixed_training_step_and_forward_launch_counts(cuda, name, overrides, per_step):
    """A training step of a narrow PiTTF configuration launches #13's
    forward, dscale and dv once per attention op and nothing else, and a
    served forward the forward alone; naca_tf's bandwidths stay at or
    above 0 after the step (keras' NonNeg projection)."""
    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.kernels import posatt_tf_fixed as kf
    from position_induced_transformer_torch.train import benchmarks, loop, runner

    cfg = configs.apply_overrides(configs.get(name), overrides)
    problem = benchmarks.setup(cfg, ntrain=cfg.batch_size, ntest=2, device=cuda)
    state = runner.init_state(problem, 0)
    data = {k: torch.from_numpy(np.ascontiguousarray(v)).to(cuda) for k, v in problem.train_data.items()}
    perm = torch.arange(cfg.batch_size, device=cuda).reshape(1, -1)
    counters = (kf.posatt_tf_fixed_cuda, kf.posatt_tf_fixed_bwd_dscale_cuda,
                kf.posatt_tf_fixed_bwd_dv_cuda, kp.posatt_fixed_cuda, kb.posatt_tf_cuda)
    before = [f.launches for f in counters]
    _, losses = loop.make_train_epoch(problem.task, lambda step: 1e-2)(state, problem.geom, data, perm)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [per_step] * 3 + [0, 0]
    assert torch.isfinite(losses).all()
    if name == "naca_tf":
        bw = [p for k, p in problem.model.named_parameters() if k.endswith("band_width")]
        assert min(float(p.detach().min()) for p in bw) >= 0.0
    before = [f.launches for f in counters]
    with torch.inference_mode():
        out = problem.task.forward(problem.geom, {"x": data["x"]})
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [per_step, 0, 0, 0, 0]
    assert torch.isfinite(out).all()


# ------------------------------------------------- #14: dot-product attention

# B, L, H, V, kind: "self", hybrid "local" / "global", or "empty" (local,
# every second row keeping nothing); L no tile multiple, V 16 to 256 (21: 4-byte copies).
# cdiv(L, 64) * H * B under the card's 132 SMs takes the split-4 path (the
# four warps of a block own the same 16 rows), at or above it split 1 (or 2:
# eight warps, two on each 16 rows, where the width leaves one block an SM).
DOTATT_SHAPES = [
    (2, 1, 1, 16, "self"),
    (3, 17, 3, 16, "local"),
    (2, 972, 8, 64, "self"),
    (1, 1849, 2, 64, "global"),
    (2, 300, 1, 256, "local"),
    (1, 1024, 2, 32, "local"),
    (2, 100, 3, 21, "self"),
    (2, 130, 2, 128, "empty"),
    # tile edges (16-row warps, 8-key tiles, 64-row blocks)
    (1, 15, 4, 32, "self"),
    (2, 63, 5, 16, "global"),
    (2, 65, 6, 32, "local"),
    (2, 130, 7, 256, "self"),
    (1, 17, 8, 256, "empty"),
    # few blocks: vorticity_tf lite's processor at batch 1, split 4
    (1, 256, 1, 256, "self"),
    # split 1 (2 where one block fills an SM) at every padded width
    (3, 1100, 3, 16, "self"),
    (2, 2100, 2, 32, "local"),
    (2, 1500, 3, 128, "global"),
    (4, 2100, 1, 256, "self"),
]


def _dotatt_case(dev, B, L, H, V, kind, seed=0):
    rng = np.random.default_rng(seed)
    to = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    q, k, v = (to(rng.standard_normal((B, L, H, V))) for _ in range(3))
    g = to(rng.standard_normal((B, L, H * V)))
    dist = thr = scale = None
    if kind != "self":
        dist, scale = to(rng.random((L, L))), to(rng.uniform(-0.8, 0.8, H))
    if kind in ("local", "empty"):
        thr = torch.quantile(dist * scale.reshape(-1, 1, 1), 0.1, dim=-1)
    if kind == "empty":
        thr[:, ::2] = -1e30
    return q, k, v, g, dist, thr, scale


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,V,kind", DOTATT_SHAPES)
def test_cuda_dotatt_kernels_match_plain(cuda, B, L, H, V, kind):
    """#14's forward (and row statistics), dq (and delta), dk, dv and the
    hybrid's dscale against their plain versions; every entry point twice
    gives the same bits."""
    from position_induced_transformer_torch.kernels import dotatt as kd

    q, k, v, g, dist, thr, scale = _dotatt_case(cuda, B, L, H, V, kind)
    out, stats = kd.dotatt_cuda(q, k, v, dist, thr, scale)
    dq, delta, ds = kd.dotatt_bwd_dq_cuda(q, k, v, out, g, stats, dist, thr, scale)
    dk, dv = kd.dotatt_bwd_dkdv_cuda(q, k, v, g, stats, delta, dist, thr, scale)
    again = (kd.dotatt_cuda(q, k, v, dist, thr, scale)[0],
             *kd.dotatt_bwd_dq_cuda(q, k, v, out, g, stats, dist, thr, scale)[::2],
             *kd.dotatt_bwd_dkdv_cuda(q, k, v, g, stats, delta, dist, thr, scale))
    torch.cuda.synchronize()
    for first, second in zip((out, dq, ds, dk, dv), again):
        assert (first is None and second is None) or torch.equal(first, second)
    args = (q, k, v, g, dist, thr, scale)
    want = kd.dotatt_reference(q, k, v, dist, thr, scale)
    assert ((out - want).abs() <= ATOL + RTOL * want.abs()).all()
    st = kd.dotatt_stats_reference(q, k, dist, thr, scale)
    assert ((stats - st).abs() <= ATOL + RTOL * st.abs()).all()
    assert ((delta - kd.dotatt_bwd_delta_reference(want, g, H)).abs()
            <= ATOL + RTOL * kd.dotatt_bwd_delta_reference(want.abs(), g.abs(), H)).all()
    # on the magnitude of the terms each sums
    sizes = kd.dotatt_bwd_term_sizes(*args)
    for got, ref, size in zip((dq, dk, dv), (kd.dotatt_bwd_dq_reference, kd.dotatt_bwd_dk_reference,
                                             kd.dotatt_bwd_dv_reference), sizes):
        assert ((got - ref(*args)).abs() <= ATOL + RTOL * size).all(), ref.__name__
    if dist is not None:
        want_ds = kd.dotatt_bwd_dscale_reference(*args)
        norm = want_ds.abs().max() + 1.0
        assert ((ds - want_ds).abs() / norm <= DS_ATOL + DS_RTOL * want_ds.abs() / norm).all()


@pytest.mark.cuda
def test_dotatt_without_a_library_raises(cuda, monkeypatch):
    """A CUDA tensor launches #14 or raises: with no library to load the
    public function raises, with and without a gradient, and no plain
    version runs in its place."""
    from position_induced_transformer_torch.kernels import dotatt as kd

    q, k, v, _, dist, thr, scale = _dotatt_case(cuda, 2, 40, 2, 16, "local")

    def no_library(name):
        raise RuntimeError(f"no library {name}")

    monkeypatch.setattr(kd._build, "load", no_library)
    monkeypatch.setattr(kd, "dotatt_reference", None)  # a fallback would call it
    with pytest.raises(RuntimeError, match="no library dotatt_fwd"):
        kd.dot_attention(q, k, v, dist, thr, scale)
    with pytest.raises(RuntimeError, match="no library dotatt_fwd"):
        kd.dot_attention(q.requires_grad_(True), k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,V,kind", [DOTATT_SHAPES[1], DOTATT_SHAPES[4], DOTATT_SHAPES[6]])
def test_dotatt_function_gradients_match_plain_autograd(cuda, B, L, H, V, kind):
    """One forward + backward through dot_attention launches #14's
    forward, dq and dk/dv once each; its gradients in q, k, v and the
    scales against torch.autograd of the plain version."""
    from position_induced_transformer_torch.kernels import dotatt as kd

    q, k, v, g, dist, thr, scale = _dotatt_case(cuda, B, L, H, V, kind)
    counters = (kd.dotatt_cuda, kd.dotatt_bwd_dq_cuda, kd.dotatt_bwd_dkdv_cuda)

    def grads(fn):
        leaves = [a.clone().requires_grad_(True) for a in (q, k, v)]
        s = None if scale is None else scale.clone().requires_grad_(True)
        out = fn(*leaves, dist, thr, s)
        (out * g).sum().backward()
        return [out.detach()] + [a.grad for a in leaves] + ([] if s is None else [s.grad])

    before = [f.launches for f in counters]
    got = grads(kd.dot_attention)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1]
    want = grads(kd.dotatt_reference)
    for i, (a, b) in enumerate(zip(got, want)):
        norm = b.abs().max() + 1.0
        assert ((a - b).abs() / norm <= DS_ATOL + DS_RTOL * b.abs() / norm).all(), i


@pytest.mark.cuda
@pytest.mark.parametrize("variant,overrides,per_step", [
    ("lite", ["grid=256", "latent_grid=128", "model.hid_dim=32"], (3, 4)),
    ("selfpit", ["grid=256", "latent_grid=256", "model.hid_dim=32"], (0, 7)),
])
def test_variant_training_step_launch_counts(cuda, variant, overrides, per_step):
    """A burgers_tf training step of the lite variant launches #13 at its
    three position ops and #14 at its four self ops, once per entry point
    each; selfpit #14 at all seven (hybrid) and keeps every band_width at
    or above 0 (keras' NonNeg projection); a served forward launches the
    forwards alone."""
    import dataclasses as dc

    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.kernels import dotatt as kd
    from position_induced_transformer_torch.kernels import posatt_tf_fixed as kf
    from position_induced_transformer_torch.train import benchmarks, loop, runner

    cfg = dc.replace(configs.apply_overrides(configs.BURGERS_TF, overrides), model_variant=variant)
    problem = benchmarks.setup(cfg, ntrain=cfg.batch_size, ntest=2, device=cuda)
    state = runner.init_state(problem, 0)
    data = {k: torch.from_numpy(np.ascontiguousarray(v)).to(cuda) for k, v in problem.train_data.items()}
    perm = torch.arange(cfg.batch_size, device=cuda).reshape(1, -1)
    counters = (kf.posatt_tf_fixed_cuda, kf.posatt_tf_fixed_bwd_dscale_cuda,
                kf.posatt_tf_fixed_bwd_dv_cuda, kd.dotatt_cuda, kd.dotatt_bwd_dq_cuda,
                kd.dotatt_bwd_dkdv_cuda)
    before = [f.launches for f in counters]
    _, losses = loop.make_train_epoch(problem.task, lambda step: 1e-2)(state, problem.geom, data, perm)
    torch.cuda.synchronize()
    n13, n14 = per_step
    assert [f.launches - b for f, b in zip(counters, before)] == [n13] * 3 + [n14] * 3
    assert torch.isfinite(losses).all()
    if variant == "selfpit":
        bw = [p for k, p in problem.model.named_parameters() if k.endswith("band_width")]
        assert len(bw) == 7 and min(float(p.detach().min()) for p in bw) >= 0.0
    before = [f.launches for f in counters]
    with torch.inference_mode():
        out = problem.task.forward(problem.geom, {"x": data["x"]})
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [n13, 0, 0, n14, 0, 0]
    assert torch.isfinite(out).all()


# the torch-semantics route over materialized distances (#9, #10 under
# autograd): B, L_out, L_in, H, D, locality, rows that keep nothing
DIST_ROUTE = [
    (2, 33, 47, 1, 5, 1.0, 0),
    (3, 97, 129, 3, 33, 0.05, 0),
    (2, 37, 1025, 4, 130, 0.3, 3),
    (2, 100, 70, 8, 7, 0.2, 5),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,L_out,L_in,H,D,loc,n_empty", DIST_ROUTE)
def test_dist_route_matches_plain(cuda, B, L_out, L_in, H, D, loc, n_empty):
    """``position_attention_dist`` on the card against
    ``ops.posatt.position_attention``: one launch of #9 without a
    gradient, one each of #9 and #10's entry points with one; the output
    (rows that keep nothing: the uniform mean of u) and du at rtol 2e-5 /
    atol 2e-6 (du on its terms' magnitude), dlmda at rtol 5e-4 of its
    largest element."""
    rng = np.random.default_rng(B * L_out + H)
    to = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda)
    dist = to(4 * rng.random((B, L_out, L_in)))
    lmda, u = to(rng.uniform(-1, 1, (H, 1, 1))), to(rng.standard_normal((B, L_in, D)))
    g = to(rng.standard_normal((B, L_out, H * D)))
    thr = None
    if n_empty:
        thr = locality.quantile_threshold(dist, loc)
        for k in range(n_empty):
            thr[k % B, (7 * k + 3) % L_out, 0] = -1.0
    counters = (kb.posatt_tf_cuda, kb.posatt_tf_bwd_dscale_cuda, kb.posatt_tf_bwd_dv_cuda)
    before = [f.launches for f in counters]
    with torch.no_grad():
        out = kb.position_attention_dist(dist, lmda, u, loc, thr)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 0, 0]
    want = posatt.position_attention(dist, lmda, u, loc, thr=thr)
    torch.testing.assert_close(out, want, rtol=RTOL, atol=ATOL)
    if n_empty:
        empty = (dist.amin(-1) > thr[..., 0])
        assert int(empty.sum()) == n_empty
        mean = u.mean(1, keepdim=True).repeat(1, 1, H).expand(B, L_out, H * D)
        torch.testing.assert_close(out[empty], mean[empty], rtol=RTOL, atol=ATOL)

    def grads(fn, w):
        lm, x = lmda.clone().requires_grad_(True), u.clone().requires_grad_(True)
        (fn(dist, lm, x, loc, thr) * w).sum().backward()
        return lm.grad, x.grad

    plain = lambda d, lm, x, loc, thr: posatt.position_attention(d, lm, x, loc, thr=thr)
    before = [f.launches for f in counters]
    got = grads(kb.position_attention_dist, g)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1]
    want = grads(plain, g)
    size_u = grads(plain, g.abs())[1]
    assert ((got[1] - want[1]).abs() <= ATOL + RTOL * size_u).all()
    assert ((got[0] - want[0]).abs() <= DS_RTOL * want[0].abs().max() + DS_ATOL).all()


@pytest.mark.cuda
def test_batched_nonlazy_pit_runs_the_dist_route(cuda):
    """A narrow PiT (hid 32, 2 heads, 2 blocks, no mesh concat) on batched
    non-lazy geometry of 4 random 300-point clouds: a forward launches #9
    at each of its 4 ops and matches the plain route at rtol 1e-4 / atol
    1e-5; a training step launches 4/4/3 of #9 and #10's dscale and dv."""
    from position_induced_transformer_torch.models import PiT, build_geometry, pit

    rng = np.random.default_rng(0)
    mesh = rng.random((4, 300, 2)).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((4, 300, 3)).astype(np.float32)).to(cuda)
    model = PiT(2, 3, 1, 32, 2, 2, 0.05, 0.05, concat_mesh=False,
                generator=torch.Generator().manual_seed(0)).to(cuda)
    geom = build_geometry(mesh, mesh, mesh, en_loc=0.05, de_loc=0.05, device=cuda)
    assert geom.dist_proc.shape == (4, 300, 300) and geom.thr_down.shape == (4, 300, 1)
    counters = (kb.posatt_tf_cuda, kb.posatt_tf_bwd_dscale_cuda, kb.posatt_tf_bwd_dv_cuda)
    before = [f.launches for f in counters]
    with torch.no_grad():
        out = model(geom, x)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [4, 0, 0]
    plain = lambda d, lm, u, loc, thr=None: posatt.position_attention(d, lm, u, loc, thr=thr)
    with torch.no_grad(), mock.patch.object(pit, "position_attention_dist", plain):
        want = model(geom, x)
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-5)
    before = [f.launches for f in counters]
    model(geom, x).square().sum().backward()
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [4, 4, 3]
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


@pytest.mark.cuda
def test_host_geometry_uploads_the_host_build(cuda):
    """``build_geometry_host(device="cuda")``: the host builder's arrays,
    uploaded once, equal to the bit to its CPU build (Darcy at 43^2)."""
    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.train import benchmarks

    gc = benchmarks.darcy_geometry(configs.DARCY, 43, device=cuda)
    gh = benchmarks.darcy_geometry(configs.DARCY, 43, device="cpu")
    for name in ("mesh_in", "dist_down", "dist_proc", "dist_up", "thr_down", "thr_up"):
        assert getattr(gc, name).device.type == "cuda"
        assert torch.equal(getattr(gc, name).cpu(), getattr(gh, name))


# ------------------------------------------- mixed precision (bf16)

# config, overrides, model variant: one per kernel family (#1/#3/#4,
# #7/#8, #11/#12, #13, #14; vorticity with instance norm and BPTT)
BF16_CASES = {
    "burgers": ("burgers", ["grid=256", "latent_grid=64", "model.hid_dim=32"], None),
    "elasticity": ("elasticity", ["model.hid_dim=32"], None),
    "elasticity_tf": ("elasticity_tf", ["model.hid_dim=32"], None),
    "burgers_tf": ("burgers_tf", ["grid=256", "latent_grid=128", "model.hid_dim=32"], None),
    "burgers_tf_transformer": ("burgers_tf", ["grid=256", "latent_grid=128", "model.hid_dim=32"],
                               "transformer"),
    "vorticity": ("vorticity", ["latent_grid=8,8", "model.hid_dim=32", "rollout_steps=2"], None),
}
# a bf16 forward against the same model on the plain attention: the kernels'
# float32 rounding moves a few bf16 roundings by an ulp (2^-8 relative)
BF16_REL = 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(BF16_CASES))
def test_bf16_step_launches_what_float32_does(cuda, case):
    """compute_dtype="bfloat16" at narrow widths: a training step launches
    every kernel as often as the float32 step does, each kernel wrapper
    takes float32 tensors only, the parameters stay float32, and a
    forward gives float32 within BF16_REL (relative L2) of the same bf16
    model on the plain attention, and not the float32 model's."""
    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.kernels import dotatt as kd
    from position_induced_transformer_torch.kernels import posatt_tf_fixed as kf
    from position_induced_transformer_torch.models import pit, pit_tf
    from position_induced_transformer_torch.train import benchmarks, loop, runner

    name, overrides, variant = BF16_CASES[case]
    cfg32 = dataclasses.replace(configs.apply_overrides(configs.get(name), overrides),
                                model_variant=variant or "pit")
    cfg16 = configs.apply_overrides(cfg32, ["model.compute_dtype=bfloat16"])
    counters = (kp.posatt_fixed_cuda, kp.posatt_bwd_dscale_cuda, kp.posatt_bwd_du_cuda,
                kb.posatt_batched_cuda, kb.posatt_batched_bwd_dscale_cuda,
                kb.posatt_batched_bwd_du_cuda, kb.posatt_tf_cuda, kb.posatt_tf_coord_cuda,
                kb.posatt_tf_coord_bwd_dscale_cuda, kb.posatt_tf_coord_bwd_dv_cuda,
                kf.posatt_tf_fixed_cuda, kf.posatt_tf_fixed_bwd_dscale_cuda,
                kf.posatt_tf_fixed_bwd_dv_cuda, kd.dotatt_cuda, kd.dotatt_bwd_dq_cuda,
                kd.dotatt_bwd_dkdv_cuda)
    wrappers = [(pit, "position_attention_fixed"), (pit, "position_attention_batched"),
                (pit, "position_attention_dist"), (pit_tf, "position_attention_batched_dist"),
                (pit_tf, "position_attention_batched_tf_coords"),
                (pit_tf, "position_attention_tf_fixed"), (pit_tf, "dot_attention")]
    dtypes = set()

    def spy(fn):
        def call(*args, **kw):
            dtypes.update(a.dtype for a in (*args, *kw.values())
                          if torch.is_tensor(a) and a.is_floating_point())
            return fn(*args, **kw)
        return call

    launched, outs = {}, {}
    for cfg in (cfg32, cfg16):
        problem = benchmarks.setup(cfg, ntrain=cfg.batch_size, ntest=2, device=cuda)
        state = runner.init_state(problem, 0)
        data = {k: torch.from_numpy(np.ascontiguousarray(v)).to(cuda)
                for k, v in problem.train_data.items()}
        batch = {k: v[:2] for k, v in data.items()}
        with torch.inference_mode():
            outs[cfg.model.compute_dtype] = problem.task.forward(problem.geom, batch)
            if cfg is cfg16:
                with mock.patch.object(pit, "position_attention_fixed",
                                       lambda d, lm, u, loc, thr=None: posatt.position_attention(
                                           d, lm, u, loc, thr=thr)), \
                        mock.patch.object(pit, "position_attention_batched",
                                          lambda mq, mk, lm, u, loc, thr=None, band=None:
                                          posatt.position_attention(
                                              distances.euclidean_sq(mq, mk), lm, u, loc,
                                              thr=thr)), \
                        mock.patch.object(pit_tf, "position_attention_batched_tf_coords",
                                          lambda mq, mk, s, v, thr=None, band=None:
                                          kb.posatt_tf_reference(pit_tf.pairwise_dist_half(mq, mk),
                                                                 thr, s, v)), \
                        mock.patch.object(pit_tf, "position_attention_tf_fixed",
                                          lambda d, thr, s, v, kind, loc: kf.posatt_tf_fixed_reference(
                                              d, None if loc > 100 else thr, s, v, kf.KINDS[kind])), \
                        mock.patch.object(pit_tf, "dot_attention",
                                          lambda q, k, v, d=None, t=None, s=None: kd.dotatt_reference(
                                              q.contiguous(), k.contiguous(), v.contiguous(), d, t, s)):
                    plain = problem.task.forward(problem.geom, batch)
        before = [f.launches for f in counters]
        with contextlib.ExitStack() as stack:
            for module, attr in wrappers:
                stack.enter_context(mock.patch.object(module, attr, spy(getattr(module, attr))))
            _, losses = loop.make_train_epoch(problem.task, lambda step: 1e-3)(
                state, problem.geom, data, torch.arange(cfg.batch_size, device=cuda)[None])
        torch.cuda.synchronize()
        launched[cfg.model.compute_dtype] = [f.launches - b for f, b in zip(counters, before)]
        assert torch.isfinite(losses).all()
    assert launched["bfloat16"] == launched["float32"] and sum(launched["float32"]) > 0
    assert dtypes == {torch.float32}
    assert all(p.dtype == torch.float32 for p in problem.model.parameters())
    got = outs["bfloat16"]
    assert got.dtype == torch.float32
    rel = lambda a, b: float(torch.linalg.vector_norm((a - b).double())
                             / torch.linalg.vector_norm(b.double()))
    assert rel(got, plain) <= BF16_REL and not torch.equal(got, outs["float32"])
