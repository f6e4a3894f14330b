"""The precision that kernel #14's tensor-core design relies on, on the CPU.

Kernel #14 (``kernels/csrc/dotatt_{fwd,bwd}.cu``) runs every product of the
attention (q.k and g.v over the head width; p v, ds k, p^T g and ds^T q over
the keys or queries) on the tensor cores as 3xTF32: each float32 operand x
is split into ``big = RNA_tf32(x)`` and ``small = RNA_tf32(x - big)`` (10
explicit mantissa bits, round to nearest, ties away from zero), and the
product is ``big_a big_b + big_a small_b + small_a big_b`` accumulated in
float32; ``small_a small_b`` (about 2**-22 of the product) is dropped. This
file emulates that rounding with float32 matmuls of the split parts and holds
it to:

- the float32 plain versions (``kernels/dotatt.py``) on standard-normal
  inputs at V 16 to 256, at the tolerances chip_smoke.py's phase 32 holds the
  kernels to: rtol 2e-5 / atol 2e-6 on the logits and the output, dq, dk
  and dv on the magnitude of the terms each sums
  (``dotatt_bwd_term_sizes``);
- a float64 run at logits of a few thousand (a random-weight vorticity_tf
  ``lite`` layer's size): the emulated output's rms distance from float64 at
  most twice the float32 plain version's (the factor of phase 35's rollout
  gate), with three terms and with four; and the fourth term (small x small)
  moving the output by less than float32's own rounding does, which is why
  the kernels take three.

It also checks, in exact rational arithmetic, the kernels' correctly
rounded division: RN(a / b) as q = RN(a * y), y = RN(1 / b), corrected once
by the exact residual, RN(q + RN(a - q b) y) (Markstein's theorem), for the
divisors sqrt(V) and the softmax's sums.

The emulation covers the operands' rounding only. The tensor cores also
truncate each mma's sum to float32; the kernels keep every chain of mma
within 16 terms (over the head width) or one key tile, and add the chains
in IEEE float32, which the card checks hold to the same tolerances
(tests/test_torch_cuda.py, chip_smoke.py phase 32).
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from position_induced_transformer_torch.kernels import dotatt as kd

OP_RTOL, OP_ATOL = 2e-5, 2e-6
GATE_FACTOR = 2.0
F32_MAX = torch.finfo(torch.float32).max


def _tf32(x):
    """float32 -> the nearest value with 10 explicit mantissa bits, ties
    away from zero (cvt.rna.tf32.f32), by the bit arithmetic the kernels
    use."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    big = _tf32(x)
    return big, _tf32(x - big)


def _mm3(a, b, terms=3):
    """a @ b^T (batched) as the tensor cores compute it in 3xTF32 (or with
    the fourth term), float32 sums."""
    ab, as_ = _split(a)
    bb, bs = _split(b)
    bt = lambda m: m.transpose(-1, -2)
    out = as_ @ bt(bb) + ab @ bt(bs)
    if terms == 4:
        out = out + as_ @ bt(bs)
    return out + ab @ bt(bb)


def _emulated(q, k, v, g, dist=None, thr=None, scale=None, terms=3):
    """The forward's logits (B, H, L, L) and output (B, L, H*V), and dq, dk,
    dv (B, L, H*V), with every product in emulated 3xTF32 and the rest as
    the kernels compute it."""
    B, L, H, V = q.shape
    sd = torch.tensor(kd.head_scale(V), dtype=q.dtype)
    qh, kh, vh = (x.permute(0, 2, 1, 3) for x in (q, k, v))
    gh = g.reshape(B, L, H, V).permute(0, 2, 1, 3)
    x = _mm3(qh, kh, terms) / sd
    if dist is not None:
        scaled = dist * scale.reshape(-1, 1, 1)
        if thr is not None:
            scaled = torch.where(scaled <= thr[:, :, None], scaled, F32_MAX)
        x = x - scaled[None]
    p = torch.exp(x - x.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    out = _mm3(p, vh.transpose(-1, -2), terms) / l
    w = p / l
    dp = _mm3(gh, vh, terms)
    delta = (gh * out).sum(-1, keepdim=True)
    ds = w * (dp - delta)
    dq = _mm3(ds, kh.transpose(-1, -2), terms) / sd
    dk = _mm3(ds.transpose(-1, -2), qh.transpose(-1, -2), terms) / sd
    dv = _mm3(w.transpose(-1, -2), gh.transpose(-1, -2), terms)
    flat = lambda y: y.permute(0, 2, 1, 3).reshape(B, L, H * V)
    return x, flat(out), flat(dq), flat(dk), flat(dv)


def _case(B, L, H, V, kind, seed, scale_qk=1.0):
    rng = np.random.default_rng(seed)
    to = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    q, k, v = (to(rng.standard_normal((B, L, H, V))) for _ in range(3))
    q, k = q * scale_qk, k * scale_qk
    g = to(rng.standard_normal((B, L, H * V)))
    dist = thr = scale = None
    if kind != "self":
        dist, scale = to(rng.random((L, L))), to(rng.uniform(-0.8, 0.8, H))
    if kind == "local":
        thr = torch.quantile(dist * scale.reshape(-1, 1, 1), 0.1, dim=-1)
    return q, k, v, g, dist, thr, scale


def _within(got, want, size=None):
    size = want.abs() if size is None else size
    bad = (got.double() - want.double()).abs() > OP_ATOL + OP_RTOL * size.double()
    return int(bad.sum())


@pytest.mark.parametrize("kind", ["self", "local", "global"])
@pytest.mark.parametrize("V", [16, 21, 32, 64, 128, 256])
def test_three_terms_meet_the_kernel_tolerances(V, kind):
    """Emulated 3xTF32 logits, output, dq, dk and dv against the float32
    plain versions on standard-normal inputs, at phase 32's tolerances."""
    case = _case(2, 48, 2, V, kind, seed=V)
    q, k, v, g, dist, thr, scale = case
    x, out, dq, dk, dv = _emulated(*case)
    want_x, _ = kd._logits(q, k, dist, thr, scale)
    assert _within(x, want_x) == 0
    assert _within(out, kd.dotatt_reference(q, k, v, dist, thr, scale)) == 0
    sizes = kd.dotatt_bwd_term_sizes(*case)
    for got, ref, size in zip((dq, dk, dv), (kd.dotatt_bwd_dq_reference,
                                             kd.dotatt_bwd_dk_reference,
                                             kd.dotatt_bwd_dv_reference), sizes):
        assert _within(got, ref(*case), size) == 0, ref.__name__


def _rms_from_float64(V, terms, seeds=(0, 1, 2)):
    """Outputs' rms distance from float64 at logits of a few thousand:
    (emulated, float32 plain, emulated minus the three-term emulation)."""
    d_emu, d_f32, d_terms = [], [], []
    for seed in seeds:
        q, k, v, g, *_ = _case(1, 256, 1, V, "self", seed, scale_qk=25.0)
        exact = kd.dotatt_reference(q.double(), k.double(), v.double())
        d_f32.append((kd.dotatt_reference(q, k, v).double() - exact).flatten())
        emu = _emulated(q, k, v, g, terms=terms)[1]
        d_emu.append((emu.double() - exact).flatten())
        d_terms.append((emu - _emulated(q, k, v, g, terms=3)[1]).double().flatten())
    rms = lambda d: torch.cat(d).pow(2).mean().sqrt().item()
    return rms(d_emu), rms(d_f32), rms(d_terms)


def test_the_logits_reach_a_few_thousand():
    q, k, *_ = _case(1, 256, 1, 256, "self", 0, scale_qk=25.0)
    x, _ = kd._logits(q, k, None, None, None)
    assert 2000.0 < x.abs().max().item() < 10000.0


@pytest.mark.parametrize("terms", [3, 4])
@pytest.mark.parametrize("V", [64, 128, 256])
def test_large_logits_against_float64(V, terms):
    """At logits of a few thousand the emulated output stays within twice
    the float32 plain version's rms distance from float64; the fourth term
    moves it by less than float32's own rounding does, so three suffice."""
    emu, f32, by_terms = _rms_from_float64(V, terms)
    assert f32 > 0.0
    assert emu <= GATE_FACTOR * f32, (emu, f32)
    assert by_terms <= f32, (by_terms, f32)


def _rn32(x: Fraction) -> np.float32:
    """The float32 nearest to an exact rational, ties to even."""
    c = np.float32(float(x))
    best = None
    for cand in (np.nextafter(c, np.float32(-np.inf)), c, np.nextafter(c, np.float32(np.inf))):
        d = abs(Fraction(float(cand)) - x)
        even = (int(np.array(cand, np.float32).view(np.int32)) & 1) == 0
        if best is None or d < best[0] or (d == best[0] and even):
            best = (d, cand)
    return np.float32(best[1])


@pytest.mark.parametrize("b", [np.sqrt(np.float32(v)) for v in (21, 32, 128)] + [np.float32(37.25),
                                                                                  np.float32(1e3 / 7)])
def test_division_by_reciprocal_is_correctly_rounded(b):
    """The kernels' div_rn: one FMA correction of RN(a * RN(1 / b)) gives
    RN(a / b) for logits and weights of every scale (2,000 draws)."""
    b = np.float32(b)
    F = lambda x: Fraction(float(x))
    y = _rn32(1 / F(b))
    rng = np.random.default_rng(int(b * 1000))
    a = (rng.standard_normal(2000) * rng.choice([1e-3, 1.0, 30.0, 3e3], 2000)).astype(np.float32)
    for x in a:
        q = _rn32(F(x) * F(y))
        r = _rn32(F(x) - F(q) * F(b))  # the FMA's exact residual, rounded once
        assert _rn32(F(q) + F(r) * F(y)) == _rn32(F(x) / F(b)), x
