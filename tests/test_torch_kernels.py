"""The fixed-mesh attention kernels' wrappers, on the CPU.

On the CPU each wrapper runs its kernel's plain version (one for the three
forward schedules of ``version``); each is held against the JAX package's
Pallas kernel of the same version run in interpret mode, at rtol 2e-5
/ atol 2e-6 (the bound of tests/test_pallas.py: both float32, sums in
another order). The bandwidth gradient is a cancelling sum and is held at
that file's rtol 5e-4 / atol 5e-6. The CUDA kernels themselves are tested
on the card by test_torch_cuda.py.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from position_induced_transformer_torch.kernels import _build
from position_induced_transformer_torch.kernels import posatt_pallas as t_k
from position_induced_transformer_torch.ops import locality as t_loc
from position_induced_transformer_torch.ops import posatt as t_posatt
from position_induced_transformer_tpu.kernels import posatt_pallas as j_k
from position_induced_transformer_tpu.ops import distances as j_dist
from position_induced_transformer_tpu.ops import locality as j_loc

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 2e-5, 2e-6

SHAPES = [
    (64, 64, 2, 2, 8, 0.3),  # self attention, masked
    (64, 64, 2, 1, 8, 1.0),  # global (processor blocks)
    (16, 200, 3, 2, 4, 0.1),  # cross, L_in not tile-aligned
    (100, 48, 2, 2, 16, 0.5),  # L_out not tile-aligned
    (40, 72, 2, 8, 4, 0.2),  # eight heads
]


def _inputs(L_out, L_in, B, H, D, seed=0):
    rng = np.random.default_rng(seed)
    mo = jnp.asarray(rng.random((L_out, 2)), jnp.float32)
    mi = jnp.asarray(rng.random((L_in, 2)), jnp.float32)
    dist = np.array(j_dist.euclidean_sq(mo, mi))
    lmda = rng.standard_normal((H, 1, 1)).astype(np.float32)
    u = rng.random((B, L_in, D)).astype(np.float32)
    return dist, lmda, u


@pytest.mark.parametrize("L_out,L_in,B,H,D,loc", SHAPES)
def test_wrapper_cpu_matches_interpret_v3(L_out, L_in, B, H, D, loc):
    dist, lmda, u = _inputs(L_out, L_in, B, H, D)
    before = t_k.posatt_fixed_cuda.launches
    got = t_k.position_attention_fixed(
        torch.from_numpy(dist), torch.from_numpy(lmda), torch.from_numpy(u), loc
    ).numpy()
    want = np.asarray(j_k.position_attention_fixed(
        jnp.asarray(dist), jnp.asarray(lmda), jnp.asarray(u), loc,
        interpret=True, version=3,
    ))
    assert got.shape == (B, L_out, H * D)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert t_k.posatt_fixed_cuda.launches == before  # the CPU path launches nothing


FORWARD_LAUNCHERS = ("posatt_fixed_cuda", "posatt_fixed_v1_cuda", "posatt_fixed_v2_cuda")
ALL_LAUNCHERS = FORWARD_LAUNCHERS + (
    "posatt_stats_cuda", "posatt_bwd_dscale_cuda", "posatt_bwd_du_cuda")


def _launches():
    return [getattr(t_k, n).launches for n in ALL_LAUNCHERS]


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("L_out,L_in,B,H,D,loc", SHAPES)
def test_wrapper_cpu_matches_interpret_other_versions(L_out, L_in, B, H, D, loc, version):
    """The v1 and v2 schedules: the same plain version on the CPU, against
    the JAX kernel of that version in interpret mode."""
    dist, lmda, u = _inputs(L_out, L_in, B, H, D)
    before = _launches()
    got = t_k.position_attention_fixed(
        torch.from_numpy(dist), torch.from_numpy(lmda), torch.from_numpy(u), loc,
        version=version,
    ).numpy()
    want = np.asarray(j_k.position_attention_fixed(
        jnp.asarray(dist), jnp.asarray(lmda), jnp.asarray(u), loc,
        interpret=True, version=version,
    ))
    assert got.shape == (B, L_out, H * D)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert _launches() == before  # the CPU path launches nothing


@pytest.mark.parametrize("version", [0, 4])
def test_unknown_version_raises_in_both_packages(version):
    dist, lmda, u = _inputs(16, 24, 2, 2, 3)
    before = _launches()
    with pytest.raises(ValueError, match="version"):
        t_k.position_attention_fixed(
            torch.from_numpy(dist), torch.from_numpy(lmda), torch.from_numpy(u), 0.3,
            version=version,
        )
    d, lm, x = map(torch.from_numpy, (dist, lmda, u))
    thr, scale = torch.full((16, 1), float("inf")), torch.ones(2, 1)
    with pytest.raises(ValueError, match="version"):
        t_k.PosAttFixed.apply(d, thr, scale, x.requires_grad_(True), version)
    with pytest.raises(ValueError, match="version"):
        j_k.position_attention_fixed(
            jnp.asarray(dist), jnp.asarray(lmda), jnp.asarray(u), 0.3,
            interpret=True, version=version,
        )
    assert _launches() == before


def test_reference_matches_model_oracle_with_global_rows():
    """The kernel's plain version equals the model-level oracle, including
    an all-masked-but-one row and +inf distances (the ``d < inf`` term)."""
    dist, lmda, u = _inputs(24, 40, 2, 2, 3, seed=5)
    dist[3, :] = np.inf
    dist[3, 7] = 0.5
    d, lm, x = map(torch.from_numpy, (dist, lmda, u))
    thr = t_loc.quantile_threshold(d, 0.2)
    scale = t_posatt.bandwidth_scale(lm).reshape(2, 1)
    got = t_k.posatt_fixed_reference(d, thr, scale, x)
    got = got.permute(1, 2, 0, 3).reshape(2, 24, 6)
    want = t_posatt.position_attention(d, lm, x, 0.2, thr=thr)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "mutate,err",
    [
        (lambda d, l, u: (d.double(), l, u), TypeError),
        (lambda d, l, u: (d, l, u.double()), TypeError),
        (lambda d, l, u: (d.t(), l, u), ValueError),  # wrong shape and layout
        (lambda d, l, u: (d, l, u[:, :-1]), ValueError),
        (lambda d, l, u: (d[None], l, u), ValueError),
        (lambda d, l, u: (d, l, u.transpose(0, 1).contiguous().transpose(0, 1)), ValueError),
        (lambda d, l, u: (d.to("meta"), l.to("meta"), u.to("meta")), ValueError),
    ],
)
def test_wrapper_rejects_bad_inputs(mutate, err):
    dist, lmda, u = map(torch.from_numpy, _inputs(16, 24, 2, 2, 3))
    dist, lmda, u = mutate(dist, lmda, u)
    with pytest.raises(err):
        t_k.position_attention_fixed(dist, lmda, u, 0.3)


def test_kernel_launcher_refuses_cpu_tensors():
    dist, lmda, u = map(torch.from_numpy, _inputs(16, 24, 2, 2, 3))
    thr = torch.full((16, 1), float("inf"))
    scale = torch.ones(2, 1)
    for name in FORWARD_LAUNCHERS:
        with pytest.raises(ValueError, match="CUDA"):
            getattr(t_k, name)(dist, thr, scale, u)
    with pytest.raises(ValueError, match="CUDA"):
        t_k.posatt_stats_cuda(dist, thr, scale, 2, 3)
    M = torch.zeros(2, 16, 1)
    g = torch.zeros(2, 16, 6)
    with pytest.raises(ValueError, match="CUDA"):
        t_k.posatt_bwd_du_cuda(dist, thr, scale, M, M, g)
    with pytest.raises(ValueError, match="CUDA"):
        t_k.posatt_bwd_dscale_cuda(dist, thr, scale, M, M, g, u, g)


# the shapes of tests/test_pallas.py's fused-backward test
BWD_SHAPES = [
    (48, 48, 2, 2, 8, 0.4),  # self, masked
    (16, 200, 3, 2, 4, 0.1),  # cross, unaligned L_in
    (100, 48, 2, 1, 16, 1.0),  # global, unaligned L_out
]


def _bwd_inputs(L_out, L_in, B, H, D, loc, seed=1):
    """numpy (dist, thr, scale, u, g, lmda); g is an output cotangent in the
    port's (B, L_out, H*D) layout."""
    dist, lmda, u = _inputs(L_out, L_in, B, H, D, seed)
    if loc >= 1:
        thr = np.full((L_out, 1), np.inf, np.float32)
    else:
        thr = np.asarray(j_loc.quantile_threshold(jnp.asarray(dist), loc))
    scale = np.asarray(t_posatt.bandwidth_scale(torch.from_numpy(lmda))).reshape(H, 1)
    g = np.random.default_rng(seed + 1).standard_normal((B, L_out, H * D)).astype(np.float32)
    return dist, thr, scale, u, g, lmda


def _folded(g, u, H):
    """The JAX kernels' folded layouts: gf (H, L_out, B*D), uf (L_in, B*D)."""
    B, L_out, HD = g.shape
    D = HD // H
    gf = g.reshape(B, L_out, H, D).transpose(2, 1, 0, 3).reshape(H, L_out, B * D)
    uf = u.transpose(1, 0, 2).reshape(u.shape[1], -1)
    return jnp.asarray(gf), jnp.asarray(uf)


@pytest.mark.parametrize("L_out,L_in,B,H,D,loc", BWD_SHAPES)
def test_backward_plain_versions_match_interpret_kernels(L_out, L_in, B, H, D, loc):
    dist, thr, scale, u, g, _ = _bwd_inputs(L_out, L_in, B, H, D, loc)
    t = lambda a: torch.from_numpy(np.array(a))
    M, L = t_k.posatt_stats_reference(t(dist), t(thr), t(scale))
    jM, jL = j_k._posatt_stats(
        jnp.asarray(dist), jnp.asarray(thr), jnp.asarray(scale), interpret=True
    )
    np.testing.assert_allclose(M.numpy(), np.asarray(jM), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(L.numpy(), np.asarray(jL), rtol=RTOL, atol=ATOL)

    gf, uf = _folded(g, u, H)
    jargs = (jnp.asarray(dist), jnp.asarray(thr), jnp.asarray(scale), jM, jL, gf)
    du = t_k.posatt_bwd_du_reference(t(dist), t(thr), t(scale), M, L, t(g))
    jdu = np.asarray(j_k._posatt_bwd_du(*jargs, interpret=True))
    jdu = jdu.reshape(L_in, B, D).transpose(1, 0, 2)
    assert du.shape == (B, L_in, D)
    np.testing.assert_allclose(du.numpy(), jdu, rtol=RTOL, atol=ATOL)

    out = t_k._forward(t(dist), t(thr), t(scale), t(u))  # the forward's output
    ds = t_k.posatt_bwd_dscale_reference(t(dist), t(thr), t(scale), M, L, t(g), t(u), out)
    jds = np.asarray(j_k._posatt_bwd_dscale(*jargs, uf, interpret=True))
    assert ds.shape == (H, 1)
    np.testing.assert_allclose(ds.numpy(), jds, rtol=5e-4, atol=5e-6)


def test_backward_plain_versions_keep_global_and_padded_rows_finite():
    """A row of +inf distances but one, global attention (thr = +inf) and a
    zero bandwidth scale: masked entries are exactly 0, with no inf * 0."""
    dist, _, u, = map(torch.from_numpy, _inputs(12, 20, 2, 2, 3, seed=3))
    dist[4, :] = float("inf")
    dist[4, 5] = 0.25
    thr = torch.full((12, 1), float("inf"))
    scale = torch.tensor([[0.0], [2.0]])
    g = torch.ones(2, 12, 6)
    M, L = t_k.posatt_stats_reference(dist, thr, scale)
    du = t_k.posatt_bwd_du_reference(dist, thr, scale, M, L, g)
    out = t_k._forward(dist, thr, scale, u)
    ds = t_k.posatt_bwd_dscale_reference(dist, thr, scale, M, L, g, u, out)
    assert torch.isfinite(M).all() and torch.isfinite(L).all()
    assert torch.isfinite(du).all() and torch.isfinite(ds).all()
    # row 4 keeps one entry with weight 1 in both heads
    assert float(L[0, 4, 0]) == 1.0 and float(L[1, 4, 0]) == 1.0


def _torch_grads(fn, dist, lmda, u, loc, w):
    lm = torch.from_numpy(lmda).requires_grad_(True)
    x = torch.from_numpy(u).requires_grad_(True)
    out = fn(torch.from_numpy(dist), lm, x, loc)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), lm.grad.numpy(), x.grad.numpy()


@pytest.mark.parametrize("L_out,L_in,B,H,D,loc", BWD_SHAPES)
def test_function_gradients_match_jax_fused_backward(L_out, L_in, B, H, D, loc):
    """The autograd Function (its CPU path: the plain versions of all four
    kernels) against jax.grad of the JAX custom VJP with the fused backward
    in interpret mode, and against torch.autograd of the plain oracle."""
    dist, _, u, w, lmda = (_bwd_inputs(L_out, L_in, B, H, D, loc)[i] for i in (0, 1, 3, 4, 5))
    before = [f.launches for f in (t_k.posatt_fixed_cuda, t_k.posatt_stats_cuda)]
    got = _torch_grads(t_k.position_attention_fixed, dist, lmda, u, loc, w)
    assert [f.launches for f in (t_k.posatt_fixed_cuda, t_k.posatt_stats_cuda)] == before
    oracle = _torch_grads(t_posatt.position_attention, dist, lmda, u, loc, w)

    def loss(lm, x):
        out = j_k.position_attention_fixed(
            jnp.asarray(dist), lm, x, loc, interpret=True, fused_bwd=True
        )
        return jnp.sum(out * jnp.asarray(w))

    jg = jax.grad(loss, argnums=(0, 1))(jnp.asarray(lmda), jnp.asarray(u))
    for want in ((None, *map(np.asarray, jg)), oracle):
        np.testing.assert_allclose(got[1], want[1], rtol=5e-4, atol=5e-6)
        np.testing.assert_allclose(got[2], want[2], rtol=5e-4, atol=5e-6)
    np.testing.assert_allclose(got[0], oracle[0], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("version", [1, 2, 3])
@pytest.mark.parametrize("L_out,L_in,B,H,D,loc", BWD_SHAPES)
def test_function_v3_saves_the_plain_forward_stats(L_out, L_in, B, H, D, loc, version):
    """On the CPU, PosAttFixed at every version saves the M and L that the
    plain forward gives beside its output (as the card's forward of each
    version writes them, with no stats launch), and its gradients still
    match jax.grad of the JAX custom VJP of that version with the fused
    backward in interpret mode."""
    dist, thr, scale, u, w, _ = _bwd_inputs(L_out, L_in, B, H, D, loc)
    t = lambda a: torch.from_numpy(np.array(a))
    before = _launches()
    s = t(scale).requires_grad_(True)
    x = t(u).requires_grad_(True)
    out = t_k.PosAttFixed.apply(t(dist), t(thr), s, x, version)
    saved = out.grad_fn.saved_tensors
    (out * t(w)).sum().backward()
    assert _launches() == before
    ref, M, L = t_k.posatt_fixed_reference(t(dist), t(thr), t(scale), t(u), stats=True)
    assert torch.equal(saved[4], M) and torch.equal(saved[5], L)
    assert torch.equal(out.detach(), ref.permute(1, 2, 0, 3).reshape(B, L_out, H * D))

    def loss(sc, xx):
        o = j_k._posatt_fixed(jnp.asarray(dist), jnp.asarray(thr), sc, xx, True, version, True)
        return jnp.sum(o * jnp.asarray(w.reshape(B, L_out, H, D).transpose(2, 0, 1, 3)))

    jds, jdu = jax.grad(loss, argnums=(0, 1))(jnp.asarray(scale), jnp.asarray(u))
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(jds), rtol=5e-4, atol=5e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jdu), rtol=RTOL, atol=ATOL)


def test_plain_forward_row_with_no_kept_entry_matches_jax_reference():
    """Rows that keep no entry (a threshold below the row's least distance;
    a row of +inf distances under a finite threshold) through the port's
    plain path: softmax over -1e38 everywhere, the mean of u over all
    L_in, as JAX's ``_reference_forward``; M = -1e38 and L = L_in."""
    dist, lmda, u = _inputs(20, 33, 2, 2, 3, seed=7)
    dist[4, :] = np.inf
    thr = np.array(j_loc.quantile_threshold(jnp.asarray(dist), 0.2))
    thr[4] = 1.0
    thr[9] = -1.0
    scale = np.asarray(t_posatt.bandwidth_scale(torch.from_numpy(lmda))).reshape(2, 1)
    t = lambda a: torch.from_numpy(np.array(a))
    got = t_k._forward(t(dist), t(thr), t(scale), t(u))
    want = np.asarray(j_k._reference_forward(
        jnp.asarray(dist), jnp.asarray(thr), jnp.asarray(scale), jnp.asarray(u)))
    want = want.transpose(1, 2, 0, 3).reshape(2, 20, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    mean = np.tile(u.mean(1), (1, 2))
    for row in (4, 9):
        np.testing.assert_allclose(got[:, row].numpy(), mean, rtol=RTOL, atol=ATOL)
    _, M, L = t_k.posatt_fixed_reference(t(dist), t(thr), t(scale), t(u), stats=True)
    assert (M[:, [4, 9]] == -1e38).all() and (L[:, [4, 9]] == 33).all()


# the closed form of dscale through the forward's output, at a global, a
# masked and a ragged shape (neither length a multiple of 32)
DSCALE_SHAPES = [
    (64, 64, 2, 8, 1.0),  # global
    (48, 96, 3, 4, 0.1),  # masked
    (37, 83, 2, 5, 0.3),  # ragged
]


@pytest.mark.parametrize("H", [1, 2, 8])
@pytest.mark.parametrize("L_out,L_in,B,D,loc", DSCALE_SHAPES)
def test_dscale_closed_form_matches_jax_fused_backward(L_out, L_in, B, D, loc, H):
    """The CPU path's dscale (Y - v O through the forward's output, the
    kernel's closed form) against the scale cotangent of the JAX custom VJP
    ``_posatt_fixed`` with its fused backward under ``jax.vjp`` (interpret
    mode), at tests/test_pallas.py's bound."""
    dist, thr, scale, u, g, _ = _bwd_inputs(L_out, L_in, B, H, D, loc, seed=H)
    t = lambda a: torch.from_numpy(np.array(a))
    M, L = t_k.posatt_stats_reference(t(dist), t(thr), t(scale))
    out = t_k._forward(t(dist), t(thr), t(scale), t(u))
    ds = t_k.posatt_bwd_dscale_reference(t(dist), t(thr), t(scale), M, L, t(g), t(u), out)

    def f(s):
        return j_k._posatt_fixed(jnp.asarray(dist), jnp.asarray(thr), s, jnp.asarray(u),
                                 True, 3, True)

    jout, vjp = jax.vjp(f, jnp.asarray(scale))
    # the JAX output and its cotangent are (H, B, L_out, D)
    gj = g.reshape(B, L_out, H, D).transpose(2, 0, 1, 3)
    (jds,) = vjp(jnp.asarray(gj))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout).transpose(1, 2, 0, 3).reshape(
        B, L_out, H * D), rtol=RTOL, atol=ATOL)
    assert ds.shape == (H, 1)
    np.testing.assert_allclose(ds.numpy(), np.asarray(jds), rtol=5e-4, atol=5e-6)


def test_function_saves_the_forward_output_on_cpu():
    """PosAttFixed saves (dist, thr, scale, u, M, L, out) on the CPU too,
    so that the CPU backward runs the kernel's closed form."""
    dist, thr, scale, u, _, _ = map(torch.from_numpy, _bwd_inputs(24, 40, 2, 2, 3, 0.3))
    x = u.clone().requires_grad_(True)
    s = scale.clone().requires_grad_(True)
    out = t_k.PosAttFixed.apply(dist, thr, s, x, 3)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 7
    for got, want in zip(saved[:4], (dist, thr, s, x)):
        assert torch.equal(got, want)
    M, L = t_k.posatt_stats_reference(dist, thr, scale)
    assert torch.equal(saved[4], M) and torch.equal(saved[5], L)
    assert torch.equal(saved[6], out.detach())


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("L_out,L_in,B,H,D,loc", BWD_SHAPES)
def test_function_gradients_match_jax_other_versions(L_out, L_in, B, H, D, loc, version):
    """The autograd Function under the v1 and v2 schedules (on the CPU: the
    same plain versions) against jax.grad of the JAX custom VJP of that
    version in interpret mode; dU at the forward's bound, d lmda (a
    cancelling sum) at tests/test_pallas.py's."""
    dist, _, u, w, lmda = (_bwd_inputs(L_out, L_in, B, H, D, loc)[i] for i in (0, 1, 3, 4, 5))
    before = _launches()
    fn = lambda *a: t_k.position_attention_fixed(*a, version=version)
    got = _torch_grads(fn, dist, lmda, u, loc, w)
    assert _launches() == before

    def loss(lm, x):
        out = j_k.position_attention_fixed(
            jnp.asarray(dist), lm, x, loc, interpret=True, version=version
        )
        return jnp.sum(out * jnp.asarray(w))

    jg = jax.grad(loss, argnums=(0, 1))(jnp.asarray(lmda), jnp.asarray(u))
    np.testing.assert_allclose(got[1], np.asarray(jg[0]), rtol=5e-4, atol=5e-6)
    np.testing.assert_allclose(got[2], np.asarray(jg[1]), rtol=RTOL, atol=ATOL)
    # on the CPU every version's forward is the one plain version, so the
    # backward (whose dscale reads the forward's output) gives v3's bits
    v3 = _torch_grads(t_k.position_attention_fixed, dist, lmda, u, loc, w)
    assert np.array_equal(got[1], v3[1]) and np.array_equal(got[2], v3[2])


def test_no_grad_forward_skips_the_function():
    dist, lmda, u = map(torch.from_numpy, _inputs(16, 24, 2, 2, 3))
    lmda.requires_grad_(True)
    with torch.inference_mode():
        out = t_k.position_attention_fixed(dist, lmda, u, 0.3)
    assert out.grad_fn is None
    out = t_k.position_attention_fixed(dist, lmda, u, 0.3)
    assert type(out.grad_fn).__name__ == "PosAttFixedBackward"


def test_module_imports_without_nvcc_or_gpu():
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               CUDA_HOME="/nonexistent", CUDA_VISIBLE_DEVICES="")
    code = (
        "import sys, position_induced_transformer_torch.kernels as k;"
        "assert 'triton' not in sys.modules;"
        "assert k.posatt_fixed_cuda.launches == 0;"
        "assert k.posatt_fixed_v1_cuda.launches == k.posatt_fixed_v2_cuda.launches == 0;"
        "print('ok')"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_build_command_targets_sm90a():
    src = _build.CSRC / "posatt_fixed_fwd.cu"
    assert src.exists()
    cmd = _build.nvcc_command(src, Path("/tmp/x.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "--use_fast_math" not in cmd
    assert {"-shared", "-O3", "-std=c++17"} <= set(cmd)
    # the library name follows the source's content
    assert _build.library_path("posatt_fixed_fwd").name.startswith("libposatt_fixed_fwd-")
    assert set(_build.KERNELS) == {
        "posatt_fixed_fwd", "posatt_fixed_bwd", "posatt_batched_fwd", "posatt_batched_bwd",
        "posatt_tf_fwd", "posatt_tf_bwd", "posatt_tf_fixed_fwd", "posatt_tf_fixed_bwd",
        "dotatt_fwd", "dotatt_bwd",
    }
    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").exists()


def test_build_dir_is_gitignored():
    rel = _build.BUILD_DIR.relative_to(REPO)
    patterns = {
        line.strip().strip("/")
        for line in (REPO / ".gitignore").read_text().splitlines()
    }
    assert any(str(p) in patterns for p in [rel, *rel.parents] if str(p) != ".")
