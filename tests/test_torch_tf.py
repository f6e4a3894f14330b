"""The TF-semantics point-cloud part of the port (elasticity_tf, kernels
#9-#12) against the JAX package, on the CPU.

On the CPU the wrappers run the kernels' plain versions; each is held
against the JAX Pallas kernel in interpret mode at rtol 1e-5 / atol 1e-6
(both float32, sums in another order). The per-sample bandwidth gradient
is a cancelling sum, held at rtol 5e-4 / atol 5e-6 on terms normalised to
unit size (tests/test_pallas.py's bound). Thresholds from each side's own
distances (XLA on the CPU may contract the coordinate sum into an FMA, so a
distance can differ by one ulp) are held at rtol 1e-6 with equal kept sets
and equal band starts. The whole model with carried weights is held
against the JAX model at rtol 1e-4 / atol 1e-5 and against the float64
numpy oracle at test_tf_oracle_parity.py's rtol 2e-4 / atol 2e-5; training
at losses rtol 2e-4 and weights rtol 5e-3 / atol 2e-5 (test_torch_train.py's
bounds: Adam divides each gradient by its running magnitude). The CUDA
kernels themselves are tested on the card by test_torch_cuda.py.
"""

import dataclasses
import io
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from position_induced_transformer_torch import configs as t_configs
from position_induced_transformer_torch.data import synthetic as t_syn
from position_induced_transformer_torch.kernels import posatt_batched as t_b
from position_induced_transformer_torch.models import pit_tf as t_tf
from position_induced_transformer_torch.ops import initializers as t_init
from position_induced_transformer_torch.ops import locality as t_loc
from position_induced_transformer_torch.train import benchmarks as t_bench
from position_induced_transformer_torch.train import checkpoint as t_ckpt
from position_induced_transformer_torch.train import evaluate as t_eval
from position_induced_transformer_torch.train import loop as t_loop
from position_induced_transformer_torch.train import runner as t_runner
from position_induced_transformer_torch.train.serve import PredictServer
from position_induced_transformer_torch.utils.torch_compat import flax_tf_params_to_state_dict
from position_induced_transformer_tpu import configs as j_configs
from position_induced_transformer_tpu.kernels import posatt_batched as j_b
from position_induced_transformer_tpu.models import PiTTFPointCloud as JPiTTFPointCloud
from position_induced_transformer_tpu.ops import locality as j_loc
from position_induced_transformer_tpu.train import benchmarks as j_bench
from position_induced_transformer_tpu.train import loop as j_loop
from tests import tf_numpy_oracle as oracle

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
DS_RTOL, DS_ATOL = 5e-4, 5e-6
MODEL_RTOL, MODEL_ATOL = 1e-4, 1e-5
LOSS_RTOL = 2e-4
PARAM_RTOL, PARAM_ATOL = 5e-3, 2e-5
t = lambda a: torch.from_numpy(np.array(a))


# ------------------------------------------------------------- kernels


def _ring(rng, B, L):
    th = np.sort(rng.uniform(0, 2 * np.pi, (B, L)), axis=1)
    rad = 1.0 + 0.1 * rng.random((B, 1))
    return np.stack([rad * np.cos(th), rad * np.sin(th)], -1).astype(np.float32)


def _dist_case(B, Lo, Li, H, V, kind, seed=0):
    """Pre-built halved distances, thresholds (a percentile per row, or
    None), (H, 1) scales, values and a cotangent."""
    rng = np.random.default_rng(seed)
    mq = rng.random((B, Lo, 2)).astype(np.float32)
    mk = rng.random((B, Li, 2)).astype(np.float32)
    dist = np.asarray(t_tf.pairwise_dist_half(t(mq), t(mk)))
    scale = (rng.standard_normal((H, 1)) ** 2).astype(np.float32)
    if kind == "large_s":  # s * dmin far above 88: the shift keeps rows alive
        scale = np.full((H, 1), 4e3, np.float32)
        dist = dist + 1.0
    elif kind == "s0":
        scale = np.zeros((H, 1), np.float32)
    thr = None
    if kind != "global":
        thr = np.quantile(dist, 0.3, axis=-1, keepdims=True).astype(np.float32)
    values = rng.standard_normal((B, Li, H * V)).astype(np.float32)
    g = rng.standard_normal((B, Lo, H * V)).astype(np.float32)
    return dist, thr, scale, values, g


DIST_CASES = {
    "global": (2, 36, 44, 2, 3, "global"),
    "thr": (2, 40, 40, 4, 5, "thr"),
    "h8_ragged": (2, 37, 53, 8, 3, "thr"),
    "large_s": (1, 36, 36, 2, 4, "large_s"),
    "s0": (1, 36, 36, 1, 8, "s0"),
    # past the CUDA kernel's 1024-column list of kept columns
    "global_L1100": (1, 8, 1100, 2, 3, "global"),
}


@pytest.mark.parametrize("name", list(DIST_CASES))
def test_dist_plain_versions_match_interpret_kernels(name):
    """Kernels #9 and #10's plain versions against _posatt_tf_raw and
    _posatt_tf_bwd_raw in interpret mode."""
    dist, thr, scale, values, g = _dist_case(*DIST_CASES[name])
    jthr = None if thr is None else jnp.asarray(thr)
    tthr = None if thr is None else t(thr)
    got = t_b.posatt_tf_reference(t(dist), tthr, t(scale), t(values))
    want = np.asarray(j_b._posatt_tf_raw(jnp.asarray(dist), jthr, jnp.asarray(scale),
                                         jnp.asarray(values), interpret=True))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    dv, ds = t_b.posatt_tf_bwd_reference(t(dist), tthr, t(scale), t(values), t(g))
    jdv, jds = j_b._posatt_tf_bwd_raw(jnp.asarray(dist), jthr, jnp.asarray(scale),
                                      jnp.asarray(values), jnp.asarray(g), interpret=True)
    np.testing.assert_allclose(dv.numpy(), np.asarray(jdv), rtol=RTOL, atol=ATOL)
    size = np.abs(np.asarray(jds)).max() + 1.0
    np.testing.assert_allclose(ds.numpy() / size, np.asarray(jds) / size, rtol=DS_RTOL, atol=DS_ATOL)


def _coord_case(kind, H=2, V=3, seed=4):
    """Raw kernel arguments of #11/#12 (scale and thr already folded, keys
    and values on the extended axis, starts, width) and the wrapper's
    (coords, scales, values, thr, band)."""
    rng = np.random.default_rng(seed)
    if kind == "ring":
        c = _ring(rng, 2, 600)
    else:
        c = rng.random((2, 48, 2)).astype(np.float32)
    L = c.shape[1]
    scales = (rng.standard_normal((H, 1)) ** 2).astype(np.float32)
    values = rng.standard_normal((2, L, H * V)).astype(np.float32)
    g = rng.standard_normal((2, L, H * V)).astype(np.float32)
    thr = band = None
    if kind != "global":
        thr = t_loc.batched_halfdist_percentile_thresholds(t(c), 2.0 if kind == "ring" else 30.0)
    if kind == "ring":
        starts, width, wrap = t_loc.batched_band_starts(
            t(c), t(c), 2.0 * thr, t_b.band_tile_rows(L), circular=True)
        assert (starts.numpy() + width > L).any(), "no band crosses the seam"
        band = t_b.BandSpec(starts, width, wrap)
    mk, v = c, values
    if band is not None:
        mk = np.concatenate([c, c[:, : band.wrap]], 1)
        v = np.concatenate([values, values[:, : band.wrap]], 1)
    raw = (c, mk, 0.5 * scales, v, None if thr is None else 2.0 * thr.numpy(),
           None if band is None else band.starts.numpy(), 0 if band is None else band.width)
    return raw, (c, scales, values, None if thr is None else thr.numpy(), band), g


@pytest.mark.parametrize("kind", ["global", "thr", "ring"])
def test_coord_plain_versions_match_interpret_kernels(kind):
    """Kernels #11 and #12's plain versions against _posatt_tf_coord_raw and
    _posatt_tf_coord_bwd_raw in interpret mode; "ring" has a circular band
    whose seam tile wraps."""
    (mq, mk, scale, v, thr, starts, width), _, g = _coord_case(kind)
    opt = lambda a: None if a is None else t(a)
    got = t_b.posatt_tf_coord_reference(t(mq), t(mk), t(scale), t(v), opt(thr), opt(starts),
                                        width=width)
    jopt = lambda a: None if a is None else jnp.asarray(a)
    jargs = [jnp.asarray(a) for a in (mq, mk, scale, v)]
    want = np.asarray(j_b._posatt_tf_coord_raw(*jargs, jopt(thr), jopt(starts), band_width=width,
                                               interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    dv, ds = t_b.posatt_tf_coord_bwd_reference(t(mq), t(mk), t(scale), t(v), t(g), opt(thr),
                                               opt(starts), width=width)
    jdv, jds = j_b._posatt_tf_coord_bwd_raw(*jargs, jnp.asarray(g), jopt(thr), jopt(starts),
                                            band_width=width, interpret=True)
    assert dv.shape == v.shape and ds.shape == (2, scale.shape[0])
    np.testing.assert_allclose(dv.numpy(), np.asarray(jdv), rtol=RTOL, atol=ATOL)
    size = np.abs(np.asarray(jds)).max() + 1.0
    np.testing.assert_allclose(ds.numpy() / size, np.asarray(jds) / size, rtol=DS_RTOL, atol=DS_ATOL)


@pytest.mark.parametrize("H,V,seed", [(2, 3, 4), (8, 4, 9)])
def test_coord_plain_version_matches_jax_wrapper_across_the_wrap_margin(H, V, seed):
    """Kernel #11's plain version, on the extended key axis, against the JAX
    position_attention_batched_tf_coords (which appends the wrap margin and
    folds the halving itself) in interpret mode, on angle-sorted rings whose
    seam tile's band window runs into the wrap margin."""
    (mq, mk, scale, v, thr, starts, width), (c, scales, values, hthr, band), _ = _coord_case(
        "ring", H=H, V=V, seed=seed)
    assert mk.shape[1] > c.shape[1] and (starts + width > c.shape[1]).any()
    got = t_b.posatt_tf_coord_reference(t(mq), t(mk), t(scale), t(v), t(thr), t(starts),
                                        width=width)
    jband = j_b.BandSpec(jnp.asarray(starts), width, band.wrap)
    want = np.asarray(j_b.position_attention_batched_tf_coords(
        jnp.asarray(c), jnp.asarray(c), jnp.asarray(scales), jnp.asarray(values),
        jnp.asarray(hthr), jband, interpret=True))
    assert got.shape == want.shape == (2, c.shape[1], H * V)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def _dscale_through_output(att, keep, dist, dmin, values, out, g):
    """dscale as the CUDA kernels of #10 and #12 compute it, in float32:
    ``sum_{i,k} G (Y - v O)`` with ``W = P (-x)``, ``x = d - dmin``,
    ``Y = W V``, ``v = sum_j W`` and the forward's output O."""
    B, H, Lo, Li = att.shape
    w = att * torch.where(keep, -(dist - dmin), 0.0)[:, None]
    vh, gh = values.reshape(B, Li, H, -1), g.reshape(B, Lo, H, -1)
    y = torch.einsum("bhij,bjhv->bihv", w, vh)
    v = w.sum(-1).transpose(1, 2)[..., None]  # (B, Lo, H, 1)
    return (gh * (y - v * out.reshape(B, Lo, H, -1))).sum(dim=(1, 3))


@pytest.mark.parametrize("case", [f"dist-{n}" for n in DIST_CASES] + ["coord-thr", "coord-ring"])
def test_dscale_through_the_forward_output_matches_interpret_kernels(case):
    """The CUDA dscale kernels read the forward's output O instead of a
    separate pass for v: their formula, computed here in float32 on the
    plain versions' weights, against _posatt_tf_bwd_raw and
    _posatt_tf_coord_bwd_raw in interpret mode, at the dscale bound."""
    kind, name = case.split("-", 1)
    if kind == "dist":
        dist, thr, scale, values, g = _dist_case(*DIST_CASES[name])
        tthr = None if thr is None else t(thr)
        keep, dmin, _ = t_b._tf_keep(t(dist), tthr)
        d = t(dist)
        out = t_b.posatt_tf_reference(d, tthr, t(scale), t(values))
        _, jds = j_b._posatt_tf_bwd_raw(jnp.asarray(dist), None if thr is None else jnp.asarray(thr),
                                        jnp.asarray(scale), jnp.asarray(values), jnp.asarray(g),
                                        interpret=True)
    else:
        (mq, mk, scale, values, thr, starts, width), _, g = _coord_case(name)
        opt = lambda a: None if a is None else t(a)
        d, keep, dmin = t_b._tf_coord_rows(t(mq), t(mk), opt(thr), opt(starts), width)
        out = t_b.posatt_tf_coord_reference(t(mq), t(mk), t(scale), t(values), opt(thr),
                                            opt(starts), width=width)
        jopt = lambda a: None if a is None else jnp.asarray(a)
        _, jds = j_b._posatt_tf_coord_bwd_raw(*[jnp.asarray(a) for a in (mq, mk, scale, values, g)],
                                              jopt(thr), jopt(starts), band_width=width,
                                              interpret=True)
    att = t_b._tf_attention(d, keep, dmin, t(scale))
    ds = _dscale_through_output(att, keep, d, dmin, t(values), out, t(g))
    size = np.abs(np.asarray(jds)).max() + 1.0
    np.testing.assert_allclose(ds.numpy() / size, np.asarray(jds) / size, rtol=DS_RTOL, atol=DS_ATOL)


def _plain_oracle(coords, scales, values, thr):
    """Autograd-differentiable TF attention over materialized halved
    distances (a band holds every kept column, so the oracle needs none)."""
    return t_b.posatt_tf_reference(t_tf.pairwise_dist_half(coords, coords), thr, scales, values)


@pytest.mark.parametrize("kind", ["global", "thr", "ring"])
def test_coord_function_gradients_match_autograd(kind):
    """PosAttTFCoord (its CPU path) against torch.autograd of the plain
    oracle; the wrap margin's value gradients return through the concat."""
    _, (c, scales, values, thr, band), w = _coord_case(kind)
    thr = None if thr is None else t(thr)

    def grads(fn):
        s = t(scales).requires_grad_(True)
        v = t(values).requires_grad_(True)
        out = fn(s, v)
        (out * t(w)).sum().backward()
        return out.detach(), s.grad, v.grad

    got = grads(lambda s, v: t_b.position_attention_batched_tf_coords(t(c), t(c), s, v, thr, band))
    want = grads(lambda s, v: _plain_oracle(t(c), s, v, thr))
    torch.testing.assert_close(got[0], want[0], rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(got[1], want[1], rtol=DS_RTOL, atol=DS_ATOL * want[1].abs().max().item())
    torch.testing.assert_close(got[2], want[2], rtol=RTOL, atol=10 * ATOL)


@pytest.mark.parametrize("name", ["global", "thr", "large_s"])
def test_dist_function_gradients_match_autograd(name):
    dist, thr, scale, values, w = _dist_case(*DIST_CASES[name])
    thr = None if thr is None else t(thr)

    def grads(fn):
        s = t(scale).requires_grad_(True)
        v = t(values).requires_grad_(True)
        out = fn(t(dist), s, v)
        (out * t(w)).sum().backward()
        return out.detach(), s.grad, v.grad

    got = grads(lambda d, s, v: t_b.position_attention_batched_dist(d, s, v, thr))
    assert torch.isfinite(got[1]).all() and torch.isfinite(got[2]).all()
    want = grads(lambda d, s, v: t_b.posatt_tf_reference(d, thr, s, v))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=DS_RTOL, atol=DS_ATOL * (1 + b.abs().max().item()))


def test_stats_and_rows_that_keep_nothing():
    """The row statistics; a band window past the key axis gives 0, not
    NaN; inputs the kernels refuse raise."""
    dist, thr, scale, values, g = _dist_case(1, 20, 30, 2, 3, "thr", seed=7)
    st = t_b.posatt_tf_stats_reference(t(dist), t(thr), t(scale))
    assert st.shape == (1, 4, 20)
    torch.testing.assert_close(st[:, 0], t(dist).amin(-1))
    assert torch.equal(st[:, 1:2].transpose(1, 2), t(thr))
    c = np.random.default_rng(1).random((1, 20, 2)).astype(np.float32)
    starts = torch.tensor([[40]], dtype=torch.int32)
    out = t_b.posatt_tf_coord_reference(t(c), t(c), t(scale), t(values[:, :20]), t(thr), starts,
                                        width=16)
    assert torch.equal(out, torch.zeros_like(out))
    with pytest.raises(ValueError):  # H*V not divisible by H
        t_b.position_attention_batched_dist(t(dist), torch.ones(4, 1), t(values)[..., :5])
    with pytest.raises(ValueError, match="band"):
        t_b.position_attention_batched_tf_coords(t(c), t(c), t(scale), t(values[:, :20]), None,
                                                 t_b.BandSpec(starts, 16, 0))
    for fn, args in ((t_b.posatt_tf_cuda, (t(dist), None, t(scale), t(values))),
                     (t_b.posatt_tf_coord_cuda, (t(c), t(c), t(scale), t(values[:, :20])))):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)


def test_dist_function_saves_the_output_and_stats_with_the_bare_row_minimum():
    """PosAttTF (its CPU path) saves the forward's output and the row
    statistics (B, H + 2, L_out) that the card's backward kernels read: the
    bare minimum over all columns, also in rows whose threshold keeps none
    of them (where a minimum over the kept columns would be +inf), the
    threshold, and the reciprocal denominators; the output and gradients
    match the JAX kernels in interpret mode."""
    dist, thr, scale, values, g = _dist_case(2, 24, 40, 3, 4, "thr", seed=8)
    thr[:, ::5] = 0.5 * dist[:, ::5].min(-1, keepdims=True)  # rows that keep nothing
    s = t(scale).requires_grad_(True)
    v = t(values).requires_grad_(True)
    out = t_b.position_attention_batched_dist(t(dist), s, v, t(thr))
    assert type(out.grad_fn).__name__ == "PosAttTFBackward"
    saved = [x for x in out.grad_fn.saved_tensors if x is not None]
    assert any(x.shape == out.shape and torch.equal(x, out) for x in saved)
    stats = [x for x in saved if tuple(x.shape) == (2, 3 + 2, 24)]
    assert len(stats) == 1
    st = stats[0].numpy()
    keep = dist <= thr
    assert not keep[:, ::5].any() and keep[:, 1::5].any()
    np.testing.assert_array_equal(st[:, 0], dist.min(-1))
    np.testing.assert_array_equal(st[:, 1], thr[..., 0])
    x = (dist - dist.min(-1, keepdims=True)).astype(np.float64)
    den = np.where(keep[:, None], np.exp(-x[:, None] * scale[None, :, :, None]), 0.0).sum(-1)
    np.testing.assert_allclose(st[:, 2:], 1.0 / np.maximum(den, 1e-30), rtol=RTOL)
    jargs = [jnp.asarray(a) for a in (dist, thr, scale, values)]
    want = np.asarray(j_b._posatt_tf_raw(*jargs, interpret=True))
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    assert not out.detach()[:, ::5].any()
    (out * t(g)).sum().backward()
    jdv, jds = j_b._posatt_tf_bwd_raw(*jargs, jnp.asarray(g), interpret=True)
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(jdv), rtol=RTOL, atol=ATOL)
    jds = np.asarray(jds).sum(0).reshape(scale.shape)
    size = np.abs(jds).max() + 1.0
    np.testing.assert_allclose(s.grad.numpy() / size, jds / size, rtol=DS_RTOL, atol=DS_ATOL)


def test_no_grad_forward_skips_the_functions_and_launches_nothing():
    dist, thr, scale, values, _ = _dist_case(1, 20, 30, 2, 3, "thr", seed=7)
    s = t(scale).requires_grad_(True)
    counters = [getattr(t_b, n) for n in dir(t_b) if n.startswith("posatt_tf") and n.endswith("_cuda")]
    assert len(counters) == 6
    before = [f.launches for f in counters]
    with torch.inference_mode():
        assert t_b.position_attention_batched_dist(t(dist), s, t(values), t(thr)).grad_fn is None
    out = t_b.position_attention_batched_dist(t(dist), s, t(values), t(thr))
    assert type(out.grad_fn).__name__ == "PosAttTFBackward"
    out.sum().backward()
    assert [f.launches for f in counters] == before


# ------------------------------------------------- initializers, thresholds


def test_initializers_use_jax_fans_and_bounds():
    """he_normal_tf and glorot_uniform: JAX's fans, truncation and limits;
    the samples' spread matches JAX's from another stream."""
    gen = torch.Generator().manual_seed(0)
    assert t_init.jax_fans((1, 8, 1, 1)) == (8, 8) and t_init.jax_fans((8, 44, 64)) == (352, 512)
    for shape in ((44, 512), (8, 512, 64)):
        got = t_init.he_normal_tf(shape, gen).numpy()
        want = np.asarray(jax.nn.initializers.he_normal()(jax.random.PRNGKey(0), shape))
        bound = 2 * np.sqrt(2.0 / t_init.jax_fans(shape)[0]) / 0.87962566103423978
        assert got.dtype == np.float32 and np.abs(got).max() <= bound * (1 + 1e-6)
        np.testing.assert_allclose(got.std(), want.std(), rtol=0.03)
    got = t_init.glorot_uniform((1, 8, 1, 1), gen).numpy()
    assert np.abs(got).max() <= np.sqrt(6.0 / 16)
    wide = t_init.glorot_uniform((64, 64, 8), gen).numpy()
    want = np.asarray(jax.nn.initializers.glorot_uniform()(jax.random.PRNGKey(1), (64, 64, 8)))
    np.testing.assert_allclose(wide.std(), want.std(), rtol=0.03)


@pytest.mark.parametrize("pct", [2.0, 35.0, 200.0])
def test_halfdist_percentile_thresholds_match_jax(pct):
    rng = np.random.default_rng(3)
    c = np.concatenate([_ring(rng, 3, 100), rng.random((2, 100, 2)).astype(np.float32)])
    got = t_loc.batched_halfdist_percentile_thresholds(t(c), pct, chunk=2)
    want = j_loc.batched_halfdist_percentile_thresholds(jnp.asarray(c), pct)
    if pct > 100:
        assert got is None and want is None
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    d = t_tf.pairwise_dist_half(t(c), t(c))
    assert torch.equal(d <= got, d <= t(want))


# ------------------------------------------------------- the benchmark

NARROW = ["model.hid_dim=16", "model.n_blocks=1", "batch_size=4"]


@pytest.fixture(scope="module")
def problems():
    """The JAX and port elasticity_tf problems at hid 16 (8 heads of 2),
    one processor block, 600-point clouds, 8 training and 4 test samples."""
    j_cfg = j_configs.apply_overrides(j_configs.ELASTICITY_TF, NARROW)
    t_cfg = t_configs.apply_overrides(t_configs.ELASTICITY_TF, NARROW)
    jp = j_bench.setup_elasticity_tf(j_cfg, ntrain=8, ntest=4, n_points=600)
    tp = t_bench.setup(t_cfg, ntrain=8, ntest=4, n_points=600, device="cpu")
    params = jp.model.init(jax.random.PRNGKey(0), jnp.asarray(jp.train_data["x"][:1]))["params"]
    return jp, tp, params


def test_setup_matches_jax(problems):
    """The same angular sort, thresholds (equal kept sets), band starts,
    width and wrap; the geometry the Task hands the model."""
    jp, tp, _ = problems
    keys = {"x", "mesh", "y", "thr_en", "thr_de", "band_en", "band_de"}
    for split in ("train_data", "test_data"):
        jd, td = getattr(jp, split), getattr(tp, split)
        assert set(jd) == set(td) == keys
        for k in ("x", "mesh", "y", "band_en", "band_de"):
            np.testing.assert_array_equal(td[k], np.asarray(jd[k]), err_msg=k)
        np.testing.assert_allclose(td["thr_en"], np.asarray(jd["thr_en"]), rtol=1e-6, atol=0)
        d = t_tf.pairwise_dist_half(t(td["x"][..., :2]), t(td["x"][..., :2]))
        assert torch.equal(d <= t(td["thr_en"]), d <= t(np.asarray(jd["thr_en"])))
    tg = tp.task.geom_fn({k: t(v[:4]) for k, v in tp.train_data.items()})
    jg = jp.task.geom_fn({k: v[:4] for k, v in jp.train_data.items()})
    assert (tg["band_en"].width, tg["band_en"].wrap) == (jg["band_en"].width, jg["band_en"].wrap) == (384, 384)
    assert tp.task.geometry_required_keys == () and tp.task.keras_adam
    assert type(tp.model).__name__ == "PiTTFPointCloud"


def test_state_dict_carries_the_full_width_tree():
    """flax_tf_params_to_state_dict on the full-width elasticity_tf params."""
    jm = JPiTTFPointCloud(out_dim=1, hid_dim=512, n_head=8, locality_encoder=2.0,
                          locality_decoder=2.0, n_blocks=4)
    shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x),
                            jax.ShapeDtypeStruct((1, 12, 44), jnp.float32))["params"]
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = flax_tf_params_to_state_dict(params)
    model = t_bench._make_model(t_configs.ELASTICITY_TF)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert sd["PA_3.weight"].shape == (8, 512, 64) and sd["en_layer.weight"].shape == (512, 44)
    model.load_state_dict(sd)


def test_forward_matches_jax_with_and_without_thresholds(problems):
    """With the setup's thresholds and bands the port runs kernel #11's
    plain version, without them #9's over its own distances; the JAX model
    its CPU path on the same batch."""
    jp, tp, params = problems
    tp.model.load_state_dict(flax_tf_params_to_state_dict(params))
    jb = {k: v[:4] for k, v in jp.train_data.items()}
    tb = {k: t(v[:4]) for k, v in tp.train_data.items()}
    with torch.inference_mode():
        for keys in (list(tb), ["x"]):
            want = np.asarray(jp.task.forward(params, None, {k: jb[k] for k in keys}))
            got = tp.task.forward(None, {k: tb[k] for k in keys})
            assert got.shape == want.shape == (4, 600, 1)
            np.testing.assert_allclose(got.numpy(), want, rtol=MODEL_RTOL, atol=MODEL_ATOL)


def test_model_matches_numpy_oracle():
    """PiTTFPointCloud against tests/tf_numpy_oracle.py (float64, the
    reference's per-head percentile over the scaled distances)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 18, 5)).astype(np.float32)
    model = t_tf.PiTTFPointCloud(5, 1, 16, 4, 35.0, 35.0, n_blocks=2,
                                 generator=torch.Generator().manual_seed(2))
    params = {}
    for k, v in model.state_dict().items():  # the flax tree of the same weights
        *path, leaf = k.split(".")
        node = params
        for p in path:
            node = node.setdefault(p, {})
        a = v.numpy().astype(np.float64)
        if leaf == "weight" and a.ndim == 2:
            node["kernel"] = a.T
        else:
            node[leaf] = a
    with torch.inference_mode():
        got = model(t(x)).numpy()
    want = oracle.pit_tf_point_cloud_forward(params, x, 35.0, 35.0, n_blocks=2)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_keras_adam_matches_jax_and_oracle():
    """Four KerasAdam steps against the JAX _keras_adam and the float64
    tf_numpy_oracle.adam_keras_step, on a decaying learning rate."""
    rng = np.random.default_rng(5)
    shapes = {"a": (3, 4), "b": (5,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) * 10 ** -i for k, s in shapes.items()}
             for i in range(4)]
    schedule = t_loop.make_lr_schedule(1e-2, 10)
    params = {k: torch.nn.Parameter(t(v)) for k, v in p0.items()}
    opt = t_loop.make_optimizer(list(params.values()), 1e-2, "keras")
    assert isinstance(opt, t_loop.KerasAdam)
    jopt = j_loop.make_optimizer(1e-2, 10, flavor="keras")
    jp, jstate = {k: jnp.asarray(v) for k, v in p0.items()}, None
    jstate = jopt.init(jp)
    op, ostate = {k: v.astype(np.float64) for k, v in p0.items()}, oracle.adam_keras_init(p0)
    for step, g in enumerate(grads):
        for group in opt.param_groups:
            group["lr"] = schedule(step)
        for k, p in params.items():
            p.grad = t(g[k])
        opt.step()
        upd, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = jax.tree_util.tree_map(lambda a, u: a + u, jp, upd)
        op, ostate = oracle.adam_keras_step(op, g, ostate, schedule(step))
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(p.detach().numpy(), op[k], rtol=1e-6, atol=1e-7)
    sd = opt.state_dict()  # resumable, as torch's optimizers are
    again = t_loop.make_optimizer(list(params.values()), 1e-2, "keras")
    again.load_state_dict(sd)
    assert again.state[params["a"]]["step"] == 4


def test_three_training_steps_match_jax(problems):
    """Three keras-Adam steps at batch 4 on a cosine schedule over 10: JAX
    value_and_grad + _keras_adam against the port's train epoch (its
    autograd Functions run the plain versions of kernels #11 and #12)."""
    import optax

    jp, tp, params = problems
    tp.model.load_state_dict(flax_tf_params_to_state_dict(params))
    lr, total = 1e-3, 10
    perm = np.array([[0, 1, 2, 3], [4, 5, 6, 7], [2, 5, 0, 7]])
    optimizer = j_loop.make_optimizer(lr, total, flavor="keras")
    opt_state = optimizer.init(params)

    @jax.jit
    def step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(jp.task.loss_fn)(params, None, batch)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    jlosses = []
    for idx in perm:
        params, opt_state, loss = step(params, opt_state, {k: v[idx] for k, v in jp.train_data.items()})
        jlosses.append(float(loss))
    state = t_loop.TrainState(tp.model, t_loop.make_optimizer(tp.model.parameters(), lr, "keras"))
    train_epoch = t_loop.make_train_epoch(tp.task, t_loop.make_lr_schedule(lr, total))
    data = {k: t(v) for k, v in tp.train_data.items()}
    state, losses = train_epoch(state, None, data, t(perm))
    np.testing.assert_allclose(losses.numpy(), jlosses, rtol=LOSS_RTOL)
    want = flax_tf_params_to_state_dict(params)
    for k, v in tp.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=k)


def test_runner_trains_and_serves_bare_npy(problems, tmp_path):
    """runner.train on the CPU; a Predictor and the HTTP server answer a
    bare .npy (no thresholds: the model computes them per call) as the
    JAX forward does on the same weights."""
    jp, _, params = problems
    cfg = t_configs.apply_overrides(t_configs.ELASTICITY_TF, NARROW)
    problem, state, history = t_runner.train(cfg, epochs=1, ntrain=4, ntest=2, verbose=False,
                                             device="cpu", checkpoint_path=str(tmp_path / "r.pt"))
    assert state.step == 1 and isinstance(state.optimizer, t_loop.KerasAdam)
    assert all(np.isfinite(v) for v in history[0].values())
    path = str(tmp_path / "etf.pt")
    t_ckpt.save(path, flax_tf_params_to_state_dict(params), "elasticity_tf")
    x, _, _ = t_syn.elasticity(n=3, L=972, seed=3)  # the served clouds, unsorted
    want = np.asarray(jp.task.forward(params, None, {"x": jnp.asarray(x)}))
    np.save(tmp_path / "x.npy", x)
    pred = t_eval.Predictor(cfg, path, device="cpu")
    assert pred.required_keys == frozenset()
    np.testing.assert_allclose(pred.predict_file(str(tmp_path / "x.npy")), want,
                               rtol=MODEL_RTOL, atol=MODEL_ATOL)
    srv = PredictServer(("127.0.0.1", 0), pred, verbose=False)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        buf = io.BytesIO()
        np.save(buf, x[:2])
        req = urllib.request.Request(f"http://127.0.0.1:{srv.server_address[1]}/predict",
                                     data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200
            got = np.load(io.BytesIO(r.read()))
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    np.testing.assert_allclose(got, want[:2], rtol=MODEL_RTOL, atol=MODEL_ATOL)


def test_unported_variants_and_dtypes_raise():
    """Only float32 is ported. The point-cloud model takes position and
    self attention (the lite and transformer variants) and refuses another
    kind; selfpit on the point cloud raises with the JAX package's words."""
    assert type(t_tf.PiTTFPointCloud(4, 1, 8, 2, 2.0, 2.0, processor_attention="self").PA_0
                ).__name__ == "MultiHeadSelfAtt"
    with pytest.raises(ValueError, match="unknown point-cloud attention kind 'hybrid'"):
        t_tf.PiTTFPointCloud(4, 1, 8, 2, 2.0, 2.0, coder_attention="hybrid")
    with pytest.raises(NotImplementedError, match="float32"):
        t_tf.PiTTFPointCloud(4, 1, 8, 2, 2.0, 2.0, compute_dtype="bfloat16")
    lite = t_bench._make_model(dataclasses.replace(t_configs.ELASTICITY_TF, model_variant="lite"))
    assert type(lite.down).__name__ == "MultiHeadPosAttBatched"
    with pytest.raises(ValueError, match="point-cloud"):
        t_bench._make_model(dataclasses.replace(t_configs.ELASTICITY_TF, model_variant="selfpit"))
    model = t_bench._make_model(dataclasses.replace(t_configs.BURGERS_TF, model_variant="transformer"))
    assert type(model.up2).__name__ == "MultiHeadSelfAtt"
