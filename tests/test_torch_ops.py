"""The port's plain operators against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and fed to both sides. Distances
and kept masks must agree bit for bit: the periodic kept sets hinge on
exact ties. Attention outputs hold at rtol 2e-5 / atol 2e-6, the bound
the JAX package's own kernel-vs-oracle tests use (tests/test_pallas.py):
both sides are float32, and only the order of the softmax and contraction
sums differs.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from position_induced_transformer_torch.ops import distances as t_dist
from position_induced_transformer_torch.ops import initializers as t_init
from position_induced_transformer_torch.ops import locality as t_loc
from position_induced_transformer_torch.ops import normalization as t_norm
from position_induced_transformer_torch.ops import posatt as t_posatt
from position_induced_transformer_tpu.ops import distances as j_dist
from position_induced_transformer_tpu.ops import locality as j_loc
from position_induced_transformer_tpu.ops import normalization as j_norm
from position_induced_transformer_tpu.ops import posatt as j_posatt

torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-6


def _grid_1d(n):
    return np.linspace(0, 1, n + 1)[:-1].reshape(-1, 1).astype(np.float32)


def _grid_2d_flat(s):
    xs = np.linspace(0, 1, s + 1)[:-1]
    xx, yy = np.meshgrid(xs, xs)
    return np.stack([xx.ravel(), yy.ravel()], -1).astype(np.float32)


def _both(fn_t, fn_j, *arrays):
    got = fn_t(*(torch.from_numpy(a) for a in arrays)).numpy()
    want = np.asarray(fn_j(*(jnp.asarray(a) for a in arrays)))
    return got, want


@pytest.mark.parametrize(
    "metric,mesh_out,mesh_in",
    [
        ("euclidean", (40, 2), (70, 2)),
        ("euclidean", (3, 40, 2), (3, 70, 2)),  # batched meshes
        ("periodic1d", "grid1d:96", "grid1d:24"),
        ("periodic2d", "grid2d:8", "grid2d:4"),
    ],
)
def test_distances_bit_equal(metric, mesh_out, mesh_in):
    rng = np.random.default_rng(0)

    def make(spec):
        if isinstance(spec, tuple):
            return rng.random(spec).astype(np.float32)
        kind, n = spec.split(":")
        return _grid_1d(int(n)) if kind == "grid1d" else _grid_2d_flat(int(n))

    mo, mi = make(mesh_out), make(mesh_in)
    got, want = _both(
        lambda a, b: t_dist.pairwise_sq_dist(a, b, metric),
        lambda a, b: j_dist.pairwise_sq_dist(a, b, metric),
        mo, mi,
    )
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_unknown_metric_raises():
    with pytest.raises(ValueError, match="unknown metric"):
        t_dist.pairwise_sq_dist(torch.zeros(2, 1), torch.zeros(2, 1), "cosine")


@pytest.mark.parametrize(
    "rows,cols,loc", [(64, 256, 0.02), (32, 48, 0.3), (5, 1000, 0.5)]
)
def test_quantile_threshold_and_keep_mask(rows, cols, loc):
    """On random rows the two libraries' linear interpolations round in
    different orders and may differ in the last bit (one f32 ulp); the
    kept sets still agree. The regular Burgers grids agree bit for bit
    (test_torch_model.py)."""
    rng = np.random.default_rng(1)
    d = rng.random((rows, cols)).astype(np.float32)
    got, want = _both(
        lambda a: t_loc.quantile_threshold(a, loc),
        lambda a: j_loc.quantile_threshold(a, loc),
        d,
    )
    np.testing.assert_allclose(got, want, rtol=float(np.finfo(np.float32).eps), atol=0)
    got, want = _both(
        lambda a: t_loc.keep_mask(a, loc), lambda a: j_loc.keep_mask(a, loc), d
    )
    np.testing.assert_array_equal(got, want)


def test_quantile_threshold_limit_is_on_the_row_length():
    """``torch.quantile`` refuses a reduced row of more than 2**24 entries,
    not a tensor of more than 2**24 elements: the 421^2 ZSSR decoder's
    (177241, 256) distances pass (here 65537 rows of 256)."""
    d = torch.from_numpy(np.random.default_rng(2).random((2**24 // 256 + 1, 256), np.float32))
    assert d.numel() > 2**24
    thr = t_loc.quantile_threshold(d, 0.02)
    assert thr.shape == (d.shape[0], 1)
    torch.testing.assert_close(thr[:3], torch.quantile(d[:3].double(), 0.02, dim=-1, keepdim=True).float())
    with pytest.raises(RuntimeError, match="too large"):
        t_loc.quantile_threshold(torch.zeros(1, 2**24 + 1), 0.02)


def test_bandwidth_scale():
    """Across its whole range, including the pole at sin(lmda) = 1 where
    it reaches ~1.3e7 and the softmax becomes one-hot."""
    rng = np.random.default_rng(2)
    lmda = np.concatenate([
        rng.standard_normal(64),
        rng.random(64),
        [math.pi / 2, math.pi / 2 + 1e-4, -math.pi / 2, 0.0],
    ]).astype(np.float32).reshape(-1, 1, 1)
    got, want = _both(t_posatt.bandwidth_scale, j_posatt.bandwidth_scale, lmda)
    assert got.max() > 1e6
    # atol: near sin(lmda) = -1 the scale is tan of a small 1 + sin(lmda),
    # where one ulp of sin (6e-8) shows up as an absolute error
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("loc", [0.1, 1.0])
@pytest.mark.parametrize("thr_source", ["none", "thr"])
def test_position_attention(batched, loc, thr_source):
    rng = np.random.default_rng(3)
    B, L_out, L_in, H, D = 2, 33, 57, 2, 5
    lead = (B,) if batched else ()
    mo = rng.random(lead + (L_out, 2)).astype(np.float32)
    mi = rng.random(lead + (L_in, 2)).astype(np.float32)
    dist = np.array(j_dist.euclidean_sq(jnp.asarray(mo), jnp.asarray(mi)))
    lmda = rng.standard_normal((H, 1, 1)).astype(np.float32)
    u = rng.random((B, L_in, D)).astype(np.float32)
    thr = None
    if thr_source == "thr" and loc < 1.0:
        thr = np.array(j_loc.quantile_threshold(jnp.asarray(dist), loc))
    got = t_posatt.position_attention(
        torch.from_numpy(dist), torch.from_numpy(lmda), torch.from_numpy(u),
        loc, thr=None if thr is None else torch.from_numpy(thr),
    ).numpy()
    want = np.asarray(j_posatt.position_attention(
        jnp.asarray(dist), jnp.asarray(lmda), jnp.asarray(u), loc,
        thr=None if thr is None else jnp.asarray(thr),
    ))
    assert got.shape == (B, L_out, H * D)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_instance_norm():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 50, 6)).astype(np.float32) * 3 + 1
    got, want = _both(t_norm.instance_norm, j_norm.instance_norm, x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_initializers_shapes_and_bounds():
    g = torch.Generator().manual_seed(0)
    w = t_init.kaiming_normal((64, 512), g)
    assert w.shape == (64, 512) and w.dtype == torch.float32
    # std sqrt(2 / fan_in) with fan_in the torch weight's second axis
    assert abs(w.std().item() - math.sqrt(2 / 512)) < 0.05 * math.sqrt(2 / 512)
    b = t_init.torch_linear_bias(16, (4096,), g)
    assert b.shape == (4096,)
    assert b.abs().max().item() <= 0.25 and b.min().item() < -0.2 < 0.2 < b.max().item()
    lm = t_init.uniform01((2, 1, 1), g)
    assert lm.shape == (2, 1, 1) and 0 <= lm.min().item() and lm.max().item() < 1
    # the generator alone decides the draw
    again = t_init.kaiming_normal((64, 512), torch.Generator().manual_seed(0))
    assert torch.equal(w, again)
