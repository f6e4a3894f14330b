"""The CUDA kernel against its plain version, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports no JAX, so that it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance rtol 2e-5 / atol 2e-6: both sides float32, sums in another order.
"""

import numpy as np
import pytest
import torch

from position_induced_transformer_torch.kernels import posatt_pallas as kp
from position_induced_transformer_torch.ops import distances, locality, posatt

RTOL, ATOL = 2e-5, 2e-6

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


@pytest.mark.cuda
def test_cuda_wrapper_refuses_autograd_and_other_heads(cuda):
    dist, lmda, u = _inputs(cuda, 16, 24, 2, 2, 3)
    lmda.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="training slice"):
        kp.position_attention_fixed(dist, lmda, u, 0.3)
    with torch.no_grad():
        assert kp.position_attention_fixed(dist, lmda, u, 0.3).shape == (2, 16, 6)
        with pytest.raises(ValueError, match="heads"):
            kp.position_attention_fixed(dist, torch.zeros(3, 1, 1, device=cuda), u, 0.3)
