"""Per-sample-mesh attention (kernels #7 and #8) and its locality helpers,
on the CPU, against the JAX package.

On the CPU the wrappers run the kernels' plain versions; each is held
against the JAX Pallas kernel in interpret mode at rtol 2e-5 / atol 2e-6
(tests/test_pallas.py's bound: both float32, sums in another order). The
per-sample bandwidth gradient is a cancelling sum, held at rtol 5e-4 /
atol 5e-6 as there. Thresholds from the same distances are held bit for
bit; from each side's own distances (XLA on the CPU contracts the
coordinate sum into an FMA, so a distance may differ by one ulp) at rtol
1e-6, with equal kept sets and equal band starts. The CUDA kernels
themselves are tested on the card by test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from position_induced_transformer_torch.kernels import posatt_batched as t_b
from position_induced_transformer_torch.ops import distances as t_dist
from position_induced_transformer_torch.ops import locality as t_loc
from position_induced_transformer_torch.ops import posatt as t_posatt
from position_induced_transformer_tpu.kernels import posatt_batched as j_b
from position_induced_transformer_tpu.ops import locality as j_loc

torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-6
DS_RTOL, DS_ATOL = 5e-4, 5e-6
t = lambda a: torch.from_numpy(np.array(a))


def _tied_dist(seed=0):
    """(3, 6, 40) distance rows: random, a regular grid's (every value
    twice: left and right neighbours), and long runs of exact ties."""
    rng = np.random.default_rng(seed)
    rand = rng.random((6, 40))
    grid = np.tile(np.repeat((np.arange(20) * 0.05) ** 2, 2), (6, 1))
    runs = np.tile(np.repeat(np.arange(5) * 0.1, 8), (6, 1))
    for a in (grid, runs):
        for r in range(6):
            rng.shuffle(a[r])
    return np.stack([rand, grid, runs]).astype(np.float32)


@pytest.mark.parametrize("loc", [0.02, 0.1, 0.3, 0.5, 0.9, 1.0])
def test_thresholds_match_jax_on_tie_heavy_rows(loc):
    d = _tied_dist()
    for t_fn, j_fn in ((t_loc.robust_topk_threshold, j_loc.robust_topk_threshold),
                       (t_loc.topk_threshold, j_loc.topk_threshold)):
        got = t_fn(t(d), loc).numpy()
        want = np.asarray(j_fn(jnp.asarray(d), loc))
        np.testing.assert_array_equal(got, want)
    assert t_loc.topk_keep_count(40, loc) == j_loc.topk_keep_count(40, loc)


def _ring(rng, B, L):
    th = np.sort(rng.uniform(0, 2 * np.pi, (B, L)), axis=1)
    rad = 1.0 + 0.1 * rng.random((B, 1))
    return np.stack([rad * np.cos(th), rad * np.sin(th)], -1).astype(np.float32)


def _ordered(rng, B, L):
    """Keys sorted along x with a little y jitter: index order is spatial."""
    x = np.sort(rng.random((B, L)), axis=-1)
    return np.stack([x, 0.05 * rng.random((B, L))], -1).astype(np.float32)


@pytest.mark.parametrize("kind,Lq,Lk,floor", [("ordered", 1200, 520, 384), ("ring", 600, 500, 256)])
def test_batched_thresholds_and_bands_match_jax(kind, Lq, Lk, floor):
    rng = np.random.default_rng(11)
    B, loc = 3, 0.02
    make = _ring if kind == "ring" else _ordered
    mq, mk = make(rng, B, Lq), make(rng, B, Lk)
    circular = kind == "ring"
    thr = t_loc.batched_topk_thresholds(t(mq), t(mk), loc, chunk=2)
    jthr = j_loc.batched_topk_thresholds(jnp.asarray(mq), jnp.asarray(mk), loc)
    np.testing.assert_allclose(thr.numpy(), np.asarray(jthr), rtol=1e-6, atol=0)
    dist = t_dist.euclidean_sq(t(mq), t(mk))
    assert torch.equal(dist <= thr, dist <= t(jthr))
    tlo = t_b.band_tile_rows(Lq)
    assert tlo == j_b.band_tile_rows(Lq) == 256
    for width in (None, floor):
        got = t_loc.batched_band_starts(t(mq), t(mk), thr, tlo, chunk=2, width=width,
                                        circular=circular)
        want = j_loc.batched_band_starts(jnp.asarray(mq), jnp.asarray(mk), jthr, tlo,
                                         width=width, circular=circular)
        assert got is not None and want is not None
        assert got[1:] == tuple(want[1:])
        assert got[0].dtype == torch.int32
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    if circular:  # a seam-crossing tile exists
        assert (got[0].numpy() + got[1] > Lk).any()
    assert t_loc.batched_topk_thresholds(t(mq), t(mk), 1.0) is None
    # incoherent orderings get no band
    mq, mk = rng.random((2, 600, 2)).astype(np.float32), rng.random((2, 520, 2)).astype(np.float32)
    thr = t_loc.batched_topk_thresholds(t(mq), t(mk), loc)
    assert t_loc.batched_band_starts(t(mq), t(mk), thr, tlo) is None


# the shapes of tests/test_pallas.py's batched tests
FWD_SHAPES = [
    (2, 64, 64, 2, 8, 0.1),  # self, masked
    (2, 64, 64, 1, 8, 1.0),  # global (processor)
    (3, 37, 53, 2, 19, 0.1),  # cross, nothing tile-aligned
    (2, 300, 120, 1, 4, 0.02),  # tiny keep count (c = 3)
]


def _case(B, Lq, Lk, H, D, seed=2):
    rng = np.random.default_rng(seed)
    mq = rng.random((B, Lq, 2)).astype(np.float32)
    mk = rng.random((B, Lk, 2)).astype(np.float32)
    lmda = rng.standard_normal((H, 1, 1)).astype(np.float32)
    u = rng.random((B, Lk, D)).astype(np.float32)
    g = rng.standard_normal((B, Lq, H * D)).astype(np.float32)
    return mq, mk, lmda, u, g


def _ring_case(H=2, D=8, seed=31):
    """Angle-sorted rings, 600 queries and 500 keys at locality 0.02: a
    circular band of 256 columns whose seam tile wraps."""
    rng = np.random.default_rng(seed)
    mq, mk = _ring(rng, 2, 600), _ring(rng, 2, 500)
    thr = t_loc.batched_topk_thresholds(t(mq), t(mk), 0.02)
    starts, width, wrap = t_loc.batched_band_starts(
        t(mq), t(mk), thr, t_b.band_tile_rows(600), circular=True)
    assert (starts.numpy() + width > 500).any()
    lmda = rng.standard_normal((H, 1, 1)).astype(np.float32)
    u = rng.random((2, 500, D)).astype(np.float32)
    g = rng.standard_normal((2, 600, H * D)).astype(np.float32)
    return mq, mk, lmda, u, g, thr.numpy(), t_b.BandSpec(starts, width, wrap)


def _raw_args(mq, mk, lmda, u, loc, thr=None, band=None):
    """The raw kernels' arguments on both sides: (scale, mk, u) on the
    extended key axis, keep count, starts and width."""
    H = lmda.shape[0]
    scale = t_posatt.bandwidth_scale(t(lmda)).reshape(H, 1).numpy()
    kc = t_loc.topk_keep_count(mk.shape[1], loc)
    if band is not None:
        mk = np.concatenate([mk, mk[:, : band.wrap]], 1)
        u = np.concatenate([u, u[:, : band.wrap]], 1)
    starts = None if band is None else band.starts.numpy()
    return scale, mk, u, kc, starts, 0 if band is None else band.width


def _all_cases():
    for shape in FWD_SHAPES:
        B, Lq, Lk, H, D, loc = shape
        mq, mk, lmda, u, g = _case(B, Lq, Lk, H, D)
        yield f"{shape}", (mq, mk, lmda, u, g, loc, None, None)
        if loc < 1:  # with setup-time thresholds
            thr = t_loc.batched_topk_thresholds(t(mq), t(mk), loc).numpy()
            yield f"{shape}-thr", (mq, mk, lmda, u, g, loc, thr, None)
    mq, mk, lmda, u, g, thr, band = _ring_case()
    yield "ring-band", (mq, mk, lmda, u, g, 0.02, thr, band)
    # a global window past the CUDA kernel's 1024-column list of kept columns
    mq, mk, lmda, u, g = _case(1, 12, 1100, 2, 8, seed=17)
    yield "global-L1100", (mq, mk, lmda, u, g, 1.0, None, None)


CASES = dict(_all_cases())


@pytest.mark.parametrize("name", list(CASES))
def test_plain_versions_match_interpret_kernels(name):
    mq, mk, lmda, u, g, loc, thr, band = CASES[name]
    scale, mk_e, u_e, kc, starts, width = _raw_args(mq, mk, lmda, u, loc, thr, band)
    kw = dict(keep_count=kc, width=width)
    got = t_b.posatt_batched_reference(t(mq), t(mk_e), t(scale), t(u_e),
                                       None if thr is None else t(thr),
                                       None if starts is None else t(starts), **kw)
    jargs = [jnp.asarray(a) for a in (mq, mk_e, scale, u_e)]
    jkw = dict(keep_count=kc, band_width=width, interpret=True)
    jthr = None if thr is None else jnp.asarray(thr)
    jst = None if starts is None else jnp.asarray(starts)
    want = np.asarray(j_b._posatt_batched_raw(*jargs, jthr, jst, **jkw))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)

    du, ds = t_b.posatt_batched_bwd_reference(
        t(mq), t(mk_e), t(scale), t(u_e), t(g), None if thr is None else t(thr),
        None if starts is None else t(starts), **kw)
    jdu, jds = j_b._posatt_batched_bwd_raw(*jargs, jnp.asarray(g), jthr, jst, **jkw)
    assert du.shape == u_e.shape and ds.shape == (mq.shape[0], lmda.shape[0])
    np.testing.assert_allclose(du.numpy(), np.asarray(jdu), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ds.numpy(), np.asarray(jds), rtol=DS_RTOL, atol=DS_ATOL)


@pytest.mark.parametrize("name", ["(2, 64, 64, 2, 8, 0.1)", "(3, 37, 53, 2, 19, 0.1)-thr",
                                  "(2, 64, 64, 1, 8, 1.0)", "ring-band"])
def test_function_gradients_match_jax_grad(name):
    """The autograd Function (its CPU path: the plain versions) against
    jax.grad of the JAX custom VJP in interpret mode; the wrap margin's
    duplicated value gradients come back through the concat."""
    mq, mk, lmda, u, w, loc, thr, band = CASES[name]
    lm = t(lmda).requires_grad_(True)
    x = t(u).requires_grad_(True)
    out = t_b.position_attention_batched(
        t(mq), t(mk), lm, x, loc, None if thr is None else t(thr), band)
    assert type(out.grad_fn).__name__ == "PosAttBatchedBackward"
    (out * t(w)).sum().backward()
    jband = None
    if band is not None:
        jband = j_b.BandSpec(jnp.asarray(band.starts.numpy()), band.width, band.wrap)
    jthr = None if thr is None else jnp.asarray(thr)

    def loss(lm, uu):
        o = j_b.position_attention_batched(
            jnp.asarray(mq), jnp.asarray(mk), lm, uu, loc, jthr, jband, interpret=True)
        return jnp.sum(o * jnp.asarray(w)), o

    (_, jout), jg = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(lmda), jnp.asarray(u))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lm.grad.numpy(), np.asarray(jg[0]), rtol=DS_RTOL, atol=DS_ATOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg[1]), rtol=DS_RTOL, atol=DS_ATOL)


def _dscale_through_output(mq, mk, scale, u, out, g, stats, starts, width):
    """dscale as the CUDA kernel of #8 computes it, in float32: ``sum_{i,k}
    G_h (Y_h - v_h O_h)`` with ``W_h = P_h (-x)``, ``x = d - dmin``, ``Y_h =
    W_h U``, ``v_h = sum_j W_h`` and the forward's output O."""
    att, keep, dist = t_b._weights_from_stats(mq, mk, scale, stats, starts, width)
    B, H, Lo, _ = att.shape
    w = att * torch.where(keep, -(dist - stats[:, 0, :, None]), 0.0)[:, None]
    y = torch.einsum("bhij,bjd->bihd", w, u)
    v = w.sum(-1).transpose(1, 2)[..., None]  # (B, Lo, H, 1)
    gh, oh = g.reshape(B, Lo, H, -1), out.reshape(B, Lo, H, -1)
    return (gh * (y - v * oh)).sum(dim=(1, 3))


@pytest.mark.parametrize("name", ["(2, 64, 64, 2, 8, 0.1)-thr", "(3, 37, 53, 2, 19, 0.1)-thr",
                                  "(2, 64, 64, 1, 8, 1.0)", "ring-band"])
def test_dscale_through_the_forward_output_matches_interpret_kernel(name):
    """The CUDA dscale kernel of #8 reads the forward's output O instead of
    a separate pass for v, over x = d - dmin: its formula, computed here in
    float32 on the plain versions' weights, against _posatt_batched_bwd_raw
    in interpret mode at the dscale bound on unit-size terms; with
    thresholds, globally and with a circular band whose seam tile wraps."""
    mq, mk, lmda, u, g, loc, thr, band = CASES[name]
    scale, mk_e, u_e, kc, starts, width = _raw_args(mq, mk, lmda, u, loc, thr, band)
    opt = lambda a: None if a is None else t(a)
    kw = dict(keep_count=kc, width=width)
    out = t_b.posatt_batched_reference(t(mq), t(mk_e), t(scale), t(u_e), opt(thr), opt(starts), **kw)
    stats = t_b.posatt_batched_stats_reference(t(mq), t(mk_e), t(scale), opt(thr), opt(starts), **kw)
    ds = _dscale_through_output(t(mq), t(mk_e), t(scale), t(u_e), out, t(g), stats, opt(starts),
                                width)
    jopt = lambda a: None if a is None else jnp.asarray(a)
    _, jds = j_b._posatt_batched_bwd_raw(*[jnp.asarray(a) for a in (mq, mk_e, scale, u_e, g)],
                                         jopt(thr), jopt(starts), keep_count=kc, band_width=width,
                                         interpret=True)
    size = np.abs(np.asarray(jds)).max() + 1.0
    np.testing.assert_allclose(ds.numpy() / size, np.asarray(jds) / size, rtol=DS_RTOL, atol=DS_ATOL)


@pytest.mark.parametrize("H", [1, 3, 9])
def test_function_saves_the_output_and_matches_jax_vjp_at_any_head_count(H):
    """PosAttBatched (its CPU path) saves the forward's output beside its
    residuals, the dscale kernel's input, and its gradients match the JAX
    _posatt_batched custom VJP in interpret mode; 9 heads make a short
    second group of the card's kernels."""
    mq, mk, lmda, u, w = _case(2, 48, 56, H, 6, seed=13)
    thr = t_loc.batched_topk_thresholds(t(mq), t(mk), 0.1)
    lm = t(lmda).requires_grad_(True)
    x = t(u).requires_grad_(True)
    out = t_b.position_attention_batched(t(mq), t(mk), lm, x, 0.1, thr)
    assert type(out.grad_fn).__name__ == "PosAttBatchedBackward"
    saved = [s for s in out.grad_fn.saved_tensors if s is not None]
    assert any(s.shape == out.shape and torch.equal(s, out) for s in saved)
    (out * t(w)).sum().backward()

    def loss(lm, uu):
        o = j_b.position_attention_batched(jnp.asarray(mq), jnp.asarray(mk), lm, uu, 0.1,
                                           jnp.asarray(thr.numpy()), interpret=True)
        return jnp.sum(o * jnp.asarray(w)), o

    (_, jout), jg = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(lmda), jnp.asarray(u))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lm.grad.numpy(), np.asarray(jg[0]), rtol=DS_RTOL, atol=DS_ATOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg[1]), rtol=DS_RTOL, atol=DS_ATOL)


def test_function_saves_the_output_and_stats_with_the_bare_row_minimum():
    """PosAttBatched (its CPU path) saves the forward's output and the row
    statistics (B, H + 2, L_out) that the card's backward kernels read: the
    bare minimum over all columns, also in rows whose threshold keeps none
    of them (where a minimum over the kept columns would be +inf), the
    threshold, and the reciprocal denominators; the output and gradients
    match the JAX custom VJP in interpret mode."""
    mq, mk, lmda, u, w = _case(2, 30, 44, 2, 5, seed=19)
    dist = t_dist.euclidean_sq(t(mq), t(mk)).numpy()
    thr = t_loc.batched_topk_thresholds(t(mq), t(mk), 0.2).numpy()
    thr[:, ::4] = 0.5 * dist[:, ::4].min(-1, keepdims=True)  # rows that keep nothing
    lm = t(lmda).requires_grad_(True)
    x = t(u).requires_grad_(True)
    out = t_b.position_attention_batched(t(mq), t(mk), lm, x, 0.2, t(thr))
    assert type(out.grad_fn).__name__ == "PosAttBatchedBackward"
    saved = [s for s in out.grad_fn.saved_tensors if s is not None]
    assert any(s.shape == out.shape and torch.equal(s, out) for s in saved)
    stats = [s for s in saved if tuple(s.shape) == (2, 2 + 2, 30)]
    assert len(stats) == 1
    st = stats[0].numpy()
    keep = dist <= thr
    assert not keep[:, ::4].any() and keep[:, 1::4].any()
    np.testing.assert_array_equal(st[:, 0], dist.min(-1))
    np.testing.assert_array_equal(st[:, 1], thr[..., 0])
    scale = t_posatt.bandwidth_scale(t(lmda)).reshape(2, 1).numpy()
    xd = (dist - dist.min(-1, keepdims=True)).astype(np.float64)
    den = np.where(keep[:, None], np.exp(-xd[:, None] * scale[None, :, :, None]), 0.0).sum(-1)
    np.testing.assert_allclose(st[:, 2:], 1.0 / np.maximum(den, 1e-30), rtol=RTOL)
    assert not out.detach()[:, ::4].any()
    (out * t(w)).sum().backward()

    def loss(lm, uu):
        o = j_b.position_attention_batched(jnp.asarray(mq), jnp.asarray(mk), lm, uu, 0.2,
                                           jnp.asarray(thr), interpret=True)
        return jnp.sum(o * jnp.asarray(w)), o

    (_, jout), jg = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(lmda), jnp.asarray(u))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lm.grad.numpy(), np.asarray(jg[0]), rtol=DS_RTOL, atol=DS_ATOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg[1]), rtol=DS_RTOL, atol=DS_ATOL)


def test_wrapper_matches_oracle_and_computes_large_keep_counts_outside():
    """keep count 50 > 32: the wrapper computes robust thresholds itself;
    the output is ops.posatt.position_attention's on the distances."""
    mq, mk, lmda, u, _ = _case(2, 64, 100, 2, 8, seed=5)
    got = t_b.position_attention_batched(t(mq), t(mk), t(lmda), t(u), 0.5)
    dist = t_dist.euclidean_sq(t(mq), t(mk))
    want = t_posatt.position_attention(dist, t(lmda), t(u), 0.5,
                                       thr=t_loc.topk_threshold(dist, 0.5))
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_stats_and_padded_rows():
    """The forward's row statistics, and a band window past the key axis:
    rows that keep nothing give 0, not NaN."""
    mq, mk, lmda, u, g = _case(1, 20, 30, 2, 3, seed=7)
    scale = t_posatt.bandwidth_scale(t(lmda)).reshape(2, 1)
    thr = t_loc.batched_topk_thresholds(t(mq), t(mk), 0.2)
    starts = torch.tensor([[40]], dtype=torch.int32)  # the whole window is past L_in
    kw = dict(keep_count=7, width=16)
    out = t_b.posatt_batched_reference(t(mq), t(mk), scale, t(u), thr, starts, **kw)
    assert torch.equal(out, torch.zeros_like(out))
    du, ds = t_b.posatt_batched_bwd_reference(t(mq), t(mk), scale, t(u), t(g), thr, starts, **kw)
    assert torch.equal(du, torch.zeros_like(du)) and torch.equal(ds, torch.zeros_like(ds))
    st = t_b.posatt_batched_stats_reference(t(mq), t(mk), scale, keep_count=30)
    assert st.shape == (1, 4, 20)
    assert torch.isinf(st[:, 1]).all()  # a global row keeps every column
    dist = t_dist.euclidean_sq(t(mq), t(mk))
    torch.testing.assert_close(st[:, 0], dist.amin(-1))


@pytest.mark.parametrize(
    "mutate,err",
    [
        (lambda a: {**a, "mesh_q": a["mesh_q"].double()}, TypeError),
        (lambda a: {**a, "inputs": a["inputs"][:, :-1]}, ValueError),
        (lambda a: {**a, "thr": a["thr"][:, :-1]}, ValueError),
        (lambda a: {**a, "starts": a["starts"].long()}, ValueError),
        (lambda a: {**a, "starts": a["starts"][:, :1]}, ValueError),
        (lambda a: {**a, "thr": None}, ValueError),  # a band needs thresholds
    ],
)
def test_wrapper_rejects_bad_inputs(mutate, err):
    mq, mk, lmda, u, _, thr, band = _ring_case()
    a = mutate(dict(mesh_q=t(mq), mesh_k=t(mk), inputs=t(u), thr=t(thr), starts=band.starts))
    spec = t_b.BandSpec(a["starts"], band.width, band.wrap)
    with pytest.raises(err):
        t_b.position_attention_batched(a["mesh_q"], a["mesh_k"], t(lmda), a["inputs"], 0.02,
                                       a["thr"], spec)


def test_launchers_refuse_cpu_tensors():
    mq, mk, lmda, u, g = (t(a) for a in _case(2, 16, 24, 2, 3))
    scale = torch.ones(2, 1)
    stats = torch.zeros(2, 4, 16)
    with pytest.raises(ValueError, match="CUDA"):
        t_b.posatt_batched_cuda(mq, mk, scale, u, keep_count=24)
    with pytest.raises(ValueError, match="CUDA"):
        t_b.posatt_batched_bwd_dscale_cuda(mq, mk, scale, u, g, g, stats)
    with pytest.raises(ValueError, match="CUDA"):
        t_b.posatt_batched_bwd_du_cuda(mq, mk, scale, g, stats)


def test_no_grad_forward_skips_the_function_and_launches_nothing():
    mq, mk, lmda, u, _ = (t(a) for a in _case(2, 16, 24, 2, 3))
    lmda.requires_grad_(True)
    counters = (t_b.posatt_batched_cuda, t_b.posatt_batched_bwd_dscale_cuda,
                t_b.posatt_batched_bwd_du_cuda)
    before = [f.launches for f in counters]
    with torch.inference_mode():
        assert t_b.position_attention_batched(mq, mk, lmda, u, 0.2).grad_fn is None
    out = t_b.position_attention_batched(mq, mk, lmda, u, 0.2)
    assert type(out.grad_fn).__name__ == "PosAttBatchedBackward"
    out.sum().backward()
    assert [f.launches for f in counters] == before
