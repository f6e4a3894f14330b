"""The CUDA kernels against their plain versions, on the card: the
fixed-mesh kernels #1-#4 and the per-sample-mesh kernels #7 and #8.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports no JAX, so that it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance rtol 2e-5 / atol 2e-6: both sides float32, sums in another order.
The bandwidth gradient is a cancelling sum over L_out * B * D terms, so it
is held at rtol 5e-4 / atol 5e-6 (the bound tests/test_pallas.py holds the
JAX fused backward to) on terms normalised to unit scale.
"""

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
@pytest.mark.parametrize("L_out,L_in,B,H,D,loc", SHAPES)
def test_cuda_kernel_matches_plain(cuda, L_out, L_in, B, H, D, loc):
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
    want = kp.posatt_fixed_reference(dist, thr, scale, u)
    want = want.permute(1, 2, 0, 3).reshape(B, L_out, H * D)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


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
    M, L = kp.posatt_stats_cuda(dist, thr, scale)
    torch.cuda.synchronize()
    assert kp.posatt_stats_cuda.launches == before + 1
    M_want, L_want = kp.posatt_stats_reference(dist, thr, scale)
    torch.testing.assert_close(M, M_want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(L, L_want, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("L_out,L_in,B,H,D,loc", SHAPES)
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
@pytest.mark.parametrize("L_out,L_in,B,H,D,loc", SHAPES)
def test_cuda_bwd_dscale_matches_plain_and_is_deterministic(cuda, L_out, L_in, B, H, D, loc):
    dist, thr, scale, u, g = _stats_inputs(cuda, L_out, L_in, B, H, D, loc)
    M, L = kp.posatt_stats_reference(dist, thr, scale)
    before = kp.posatt_bwd_dscale_cuda.launches
    got = kp.posatt_bwd_dscale_cuda(dist, thr, scale, M, L, g, u)
    again = kp.posatt_bwd_dscale_cuda(dist, thr, scale, M, L, g, u)
    torch.cuda.synchronize()
    assert kp.posatt_bwd_dscale_cuda.launches == before + 2
    assert torch.equal(got, again)
    want = kp.posatt_bwd_dscale_reference(dist, thr, scale, M, L, g, u)
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
    # one forward + backward launches each kernel exactly once
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1, 1]
    want = _grads(posatt.position_attention, dist, lmda, u, loc, w)
    torch.testing.assert_close(got[0], want[0], rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(got[1], want[1], rtol=DS_RTOL, atol=DS_ATOL * want[1].abs().max().item())
    # dU: the tolerance of test_cuda_bwd_du_matches_plain, on the terms' magnitudes
    size = _grads(posatt.position_attention, dist, lmda, u, loc, w.abs())[2]
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


@pytest.mark.cuda
def test_cuda_kernels_refuse_other_head_counts(cuda):
    dist, _, u = _inputs(cuda, 16, 24, 2, 3, 3)
    lmda = torch.zeros(3, 1, 1, device=cuda)
    with torch.no_grad(), pytest.raises(ValueError, match="heads"):
        kp.position_attention_fixed(dist, lmda, u, 0.3)
    thr = torch.full((16, 1), float("inf"), device=cuda)
    scale = torch.ones(3, 1, device=cuda)
    with pytest.raises(ValueError, match="heads"):
        kp.posatt_stats_cuda(dist, thr, scale)
    M = torch.zeros(3, 16, 1, device=cuda)
    g = torch.zeros(2, 16, 9, device=cuda)
    with pytest.raises(ValueError, match="heads"):
        kp.posatt_bwd_du_cuda(dist, thr, scale, M, M, g)
    with pytest.raises(ValueError, match="heads"):
        kp.posatt_bwd_dscale_cuda(dist, thr, scale, M, M, g, u)


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
]


def _ring(rng, B, L):
    th = np.sort(rng.uniform(0, 2 * np.pi, (B, L)), axis=1)
    rad = 1.0 + 0.1 * rng.random((B, 1))
    return np.stack([rad * np.cos(th), rad * np.sin(th)], -1).astype(np.float32)


def _batched_case(dev, B, Lq, Lk, H, D, loc, kind, seed=0):
    """Launcher arguments (mq, mk_ext, scale, u_ext, thr, starts, keep_count,
    width), the wrapper's (mq, mk, lmda, u, loc, thr, band) and a cotangent."""
    rng = np.random.default_rng(seed)
    to = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    if kind == "ring":
        mq, mk = to(_ring(rng, B, Lq)), to(_ring(rng, B, Lk))
    else:
        mq, mk = to(rng.random((B, Lq, 2))), to(rng.random((B, Lk, 2)))
    lmda = to(rng.standard_normal((H, 1, 1)))
    u = to(rng.random((B, Lk, D)))
    g = to(rng.standard_normal((B, Lq, H * D)))
    thr = band = None
    if kind != "none":
        thr = locality.batched_topk_thresholds(mq, mk, loc)
    if kind == "ring":
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
    w = dict(width=kw["width"])
    before = (kb.posatt_batched_bwd_dscale_cuda.launches, kb.posatt_batched_bwd_du_cuda.launches)
    ds = kb.posatt_batched_bwd_dscale_cuda(mq, mk, scale, u, g, stats, starts, **w)
    ds2 = kb.posatt_batched_bwd_dscale_cuda(mq, mk, scale, u, g, stats, starts, **w)
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
def test_batched_kernels_refuse_other_head_counts(cuda):
    args, (mq, mk, _, u, loc, thr, band), g = _batched_case(cuda, 2, 16, 24, 3, 3, 0.2, "robust")
    lmda = torch.zeros(3, 1, 1, device=cuda)
    with torch.no_grad(), pytest.raises(ValueError, match="heads"):
        kb.position_attention_batched(mq, mk, lmda, u, loc, thr)
    kw, pos = _fwd(args)
    with pytest.raises(ValueError, match="heads"):
        kb.posatt_batched_cuda(*pos, **kw)
    stats = torch.zeros(2, 5, 16, device=cuda)
    with pytest.raises(ValueError, match="heads"):
        kb.posatt_batched_bwd_dscale_cuda(mq, mk, pos[2], u, g, stats)
    with pytest.raises(ValueError, match="heads"):
        kb.posatt_batched_bwd_du_cuda(mq, mk, pos[2], g, stats)


@pytest.mark.cuda
def test_cuda_tensors_never_reach_the_plain_versions(cuda):
    """Every plain version raises here: a forward and backward on CUDA
    tensors still runs, through the kernels alone."""
    _, (mq, mk, lmda, u, loc, thr, band), w = _batched_case(cuda, 2, 900, 700, 2, 6, 0.02, "ring")
    names = [n for n in dir(kb) if n.endswith("_reference")]
    assert len(names) == 5
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
