"""The CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports no JAX, so that it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance rtol 2e-5 / atol 2e-6: both sides float32, sums in another order.
The bandwidth gradient is a cancelling sum over L_out * B * D terms, so it
is held at rtol 5e-4 / atol 5e-6 (the bound tests/test_pallas.py holds the
JAX fused backward to) on terms normalised to unit scale.
"""

import numpy as np
import pytest
import torch

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
