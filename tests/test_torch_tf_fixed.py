"""The fixed-mesh TF-semantics part of the port (burgers_tf, sod_tf,
darcy_tf, vorticity_tf, naca_tf: ``PiTTF`` and kernel #13) against the JAX
package, on the CPU.

On the CPU kernel #13's wrapper and autograd Function run its plain
versions. The attention op (``MultiHeadPosAtt``, its value projection,
the attention and the GELU) with the same weights and thresholds is held
against the JAX module, forward and ``jax.grad``, at rtol 1e-5 / atol 1e-6
(both float32, sums in another order); the bandwidth gradient, a
cancelling sum, at rtol 5e-4 / atol 5e-6 on terms normalised to unit size
(tests/test_pallas.py's bound). Against the float64 numpy oracle
(tests/tf_numpy_oracle.py ``pos_att``, which takes the reference's per-head
percentile of the scaled distances in the call) at the same op bounds, on
random distances without ties. Whole models with carried weights at rtol
1e-4 / atol 1e-5 against JAX, and at test_tf_oracle_parity.py's rtol 2e-4
/ atol 2e-5 against the oracle; training at losses rtol 2e-4 and weights
rtol 5e-3 / atol 2e-5 (test_torch_train.py's bounds).

Thresholds: the port's and JAX's quantiles are held at rtol 1e-6. On
regular grids the rows are full of exact ties, and where an interpolated
quantile lands within an ulp of a tied distance the two sides' rounding
can differ; the model tests therefore carry JAX's geometry over, and the
setup tests state the kept sets they compare. The CUDA kernels themselves
are tested on the card by test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import savemat

from position_induced_transformer_torch import configs as t_configs
from position_induced_transformer_torch.data import meshes as t_meshes
from position_induced_transformer_torch.data import synthetic as t_syn
from position_induced_transformer_torch.kernels import posatt_tf_fixed as kf
from position_induced_transformer_torch.models import pit_tf as t_tf
from position_induced_transformer_torch.train import benchmarks as t_bench
from position_induced_transformer_torch.train import loop as t_loop
from position_induced_transformer_torch.utils.torch_compat import flax_tf_params_to_state_dict
from position_induced_transformer_tpu import configs as j_configs
from position_induced_transformer_tpu.data import meshes as j_meshes
from position_induced_transformer_tpu.models import pit_tf as j_tf
from position_induced_transformer_tpu.train import benchmarks as j_bench
from position_induced_transformer_tpu.train import loop as j_loop
from tests import tf_numpy_oracle as oracle

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
DS_RTOL, DS_ATOL = 5e-4, 5e-6
MODEL_RTOL, MODEL_ATOL = 1e-4, 1e-5
ORACLE_RTOL, ORACLE_ATOL = 2e-4, 2e-5
LOSS_RTOL = 2e-4
PARAM_RTOL, PARAM_ATOL = 5e-3, 2e-5
t = lambda a: torch.from_numpy(np.array(a))


# ------------------------------------------------------------- the op

# bandwidth, locality, r of each head (None: the glorot draw)
OP_CASES = {
    "tan_sin_local": ("tan_sin", 10.0, None),
    "tan_sin_global": ("tan_sin", 200.0, None),
    "square_local": ("square", 25.0, None),
    "square_global": ("square", 200.0, None),
    # negative, zero and positive heads: the sign-aware keep rule
    "tan_local": ("tan", 10.0, (-0.5, 0.0, 0.4)),
    "tan_global": ("tan", 200.0, (-0.5, 0.0, 0.4)),
}


def _op_case(kind, loc, r, Lo=30, Li=41, B=3, H=3, V=4, cin=5, seed=0):
    """Random distances, thresholds at p and 1 - p (None when global),
    inputs, a cotangent, and the JAX module with its params."""
    rng = np.random.default_rng(seed)
    dist = rng.random((Lo, Li)).astype(np.float32)
    x = rng.standard_normal((B, Li, cin)).astype(np.float32)
    g = rng.standard_normal((B, Lo, H * V)).astype(np.float32)
    thr = None
    if loc <= 100:
        p = loc / 100
        thr = np.concatenate([np.quantile(dist, p, axis=-1, keepdims=True),
                              np.quantile(dist, 1 - p, axis=-1, keepdims=True)], -1).astype(np.float32)
    jm = j_tf.MultiHeadPosAtt(H, H * V, loc, kind)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(dist), jnp.asarray(x))["params"]
    if r is not None:
        params = {**params, "band_width": jnp.asarray(np.reshape(r, (H, 1, 1)), jnp.float32)}
    return dist, thr, x, g, jm, params


def _port_module(params, cin, H, V, loc, kind):
    m = t_tf.MultiHeadPosAtt(cin, H, H * V, loc, kind)
    m.band_width.data = t(params["band_width"])
    m.weight.data = t(params["weight"])
    return m


def _normalised(got, want):
    size = np.abs(want).max() + 1.0
    np.testing.assert_allclose(got / size, want / size, rtol=DS_RTOL, atol=DS_ATOL)


@pytest.mark.parametrize("name", list(OP_CASES))
def test_attention_matches_jax_forward_and_grad(name):
    """The port's MultiHeadPosAtt (kernel #13's plain forward and backward
    through PosAttTFFixed) against JAX's MultiHeadPosAtt and jax.grad of it
    in the bandwidth parameter, the value weights and the inputs."""
    kind, loc, r = OP_CASES[name]
    dist, thr, x, g, jm, params = _op_case(kind, loc, r)
    jthr = None if thr is None else jnp.asarray(thr)
    f = lambda p, xx: jm.apply({"params": p}, jnp.asarray(dist), xx, jthr)
    want = np.asarray(f(params, jnp.asarray(x)))
    jgp, jgx = jax.grad(lambda p, xx: jnp.sum(f(p, xx) * g), argnums=(0, 1))(params, jnp.asarray(x))
    m = _port_module(params, 5, 3, 4, loc, kind)
    xt = t(x).requires_grad_(True)
    got = m(t(dist), xt, None if thr is None else t(thr))
    (got * t(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(m.weight.grad.numpy(), np.asarray(jgp["weight"]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=RTOL, atol=ATOL)
    _normalised(m.band_width.grad.numpy(), np.asarray(jgp["band_width"]))


@pytest.mark.parametrize("name", list(OP_CASES))
def test_plain_backward_entry_points_match_autograd(name):
    """The plain dscale and dv entry points (the kernels' backward
    contract, dscale reading the forward's output) against torch.autograd
    of the plain forward, in the scales and the values."""
    kind, loc, r = OP_CASES[name]
    dist, thr, _, g, _, params = _op_case(kind, loc, r)
    rng = np.random.default_rng(1)
    values = t(rng.standard_normal((3, 41, 12)).astype(np.float32)).requires_grad_(True)
    scale = t_tf._bandwidth(t(params["band_width"]), kind).reshape(3, 1).detach().requires_grad_(True)
    mode = kf.KINDS[kind]
    tthr = None if thr is None else t(thr)
    out = kf.posatt_tf_fixed_reference(t(dist), tthr, scale, values, mode)
    (out * t(g)).sum().backward()
    with torch.no_grad():
        ds = kf.posatt_tf_fixed_bwd_dscale_reference(t(dist), tthr, scale, values, out, t(g), mode)
        dv = kf.posatt_tf_fixed_bwd_dv_reference(t(dist), tthr, scale, t(g), mode)
    np.testing.assert_allclose(dv.numpy(), values.grad.numpy(), rtol=RTOL, atol=ATOL)
    _normalised(ds.numpy(), scale.grad.reshape(-1).numpy())


@pytest.mark.parametrize("name", list(OP_CASES))
def test_attention_matches_numpy_oracle(name):
    """The port's MultiHeadPosAtt, thresholds computed from the distances
    in the call, against the float64 oracle's pos_att (the reference's
    percentile of each head's scaled distances)."""
    kind, loc, r = OP_CASES[name]
    dist, _, x, _, _, params = _op_case(kind, loc, r, seed=3)
    m = _port_module(params, 5, 3, 4, loc, kind)
    with torch.no_grad():
        got = m(t(dist), t(x)).numpy()
    np_params = {k: np.asarray(v, np.float64) for k, v in params.items()}
    want = oracle.pos_att(np_params, dist, loc, x, bandwidth=kind)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_rows_that_keep_nothing_are_uniform_as_in_jax():
    """Thresholds below a row's smallest distance: JAX's float-max sentinel
    masks every entry and the softmax gives the row uniform weights; the
    plain version and its statistics (m = +inf, l = L_in) agree."""
    dist, thr, x, g, jm, params = _op_case("square", 20.0, None)
    thr[::2] = dist[::2].min(-1, keepdims=True) * 0.5
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(dist), jnp.asarray(x), jnp.asarray(thr)))
    m = _port_module(params, 5, 3, 4, 20.0, "square")
    with torch.no_grad():
        got = m(t(dist), t(x), t(thr)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    stats = kf.posatt_tf_fixed_stats_reference(t(dist), t(thr), m.band_width.detach().reshape(3, 1) ** 2, 0)
    assert torch.isinf(stats[:, 0, ::2]).all() and (stats[:, 1, ::2] == 41).all()
    assert torch.isfinite(stats[:, :, 1::2]).all()


def test_public_function_dispatch_and_refusals():
    """Without a gradient the plain forward runs alone; an unknown
    bandwidth and a CPU call of a CUDA launcher raise."""
    dist, thr, x, _, _, params = _op_case("tan", 10.0, (-0.5, 0.0, 0.4))
    s = t_tf._bandwidth(t(params["band_width"]), "tan").reshape(3, 1)
    values = t(np.random.default_rng(0).standard_normal((3, 41, 12)).astype(np.float32))
    out = kf.position_attention_tf_fixed(t(dist), t(thr), s, values, "tan", 10.0)
    np.testing.assert_array_equal(out.numpy(), kf.posatt_tf_fixed_reference(
        t(dist), t(thr), s, values, 1).numpy())
    with pytest.raises(ValueError, match="bandwidth kind"):
        kf.position_attention_tf_fixed(t(dist), t(thr), s, values, "cosine", 10.0)
    with pytest.raises(ValueError, match="CUDA"):
        kf.posatt_tf_fixed_cuda(t(dist), t(thr), s, values, 1)
    with pytest.raises(ValueError, match="thr must be"):
        kf.position_attention_tf_fixed(t(dist), t(thr[:, :1]), s, values, "tan", 10.0)


# ------------------------------------------------- the kernels' kept-step lists

# the geometry of three configurations at CPU sizes (several 128-row and
# 128-column tiles each): overrides, setup kwargs
LIST_GEOMETRIES = {
    "naca_tf": (["grid=89,21", "latent_grid=45,11"], {}),  # C-grid order, 0.5 % and 2 %
    "darcy_tf": (["latent_grid=16,16"], {"downsampling": 20}),
    "vorticity_tf": (["latent_grid=16,16", "rollout_steps=2"], {}),
}
# r of each head: negative, zero and positive scales under ``tan``
LIST_HEADS = (-0.3, 0.0, 0.4)


@pytest.fixture(scope="module")
def list_geometries(tmp_path_factory):
    """name -> the port's TFGeometry at the sizes of LIST_GEOMETRIES
    (vorticity_tf on a 32^2 file: its loader takes the grid from the data)."""
    ns32 = tmp_path_factory.mktemp("ns") / "ns_32.mat"
    savemat(ns32, {"u": t_syn.vorticity(n=4, s=32, frames=12, seed=2)})
    out = {}
    for name, (overrides, kw) in LIST_GEOMETRIES.items():
        cfg = t_configs.apply_overrides(t_configs.get(name), overrides)
        path = str(ns32) if name == "vorticity_tf" else None
        out[name] = t_bench.setup(cfg, path, ntrain=2, ntest=2, device="cpu", **kw).geom
    return out


def _brute_lists(keep, ft, dt):
    """By brute force over a keep mask (H, L_out, L_in): for each head the
    (ft-row tile, 16-column step) pairs, (dt-column tile, 16-row step)
    pairs and 128 x 128 tiles that hold a kept entry, and the rows that
    keep nothing."""
    fwd, dv, tiles = set(), set(), set()
    for h, i, j in zip(*np.nonzero(keep)):
        fwd.add((h, i // ft, j // 16))
        dv.add((h, j // dt, i // 16))
        tiles.add((h, i // 128, j // 128))
    return fwd, dv, tiles, ~keep.any(-1)


@pytest.mark.parametrize("empty_row", [False, True], ids=["", "empty_row"])
@pytest.mark.parametrize("mode", [0, 1], ids=["tan_sin", "tan"])
@pytest.mark.parametrize("tile", [(128, 128), (32, 64)], ids=["tiles128", "tiles32_64"])
@pytest.mark.parametrize("op", ["down", "up"])
@pytest.mark.parametrize("name", list(LIST_GEOMETRIES))
def test_kept_step_lists_match_a_brute_force_count(list_geometries, name, op, tile, mode,
                                                   empty_row):
    """The plain version of the forward pre-pass's kept-step lists on a
    configuration's encoder (down) or decoder (up) geometry, cut to the
    forward's and dv's tiles (128 rows and columns, or 32 and 64), heads of
    scale < 0, = 0 and > 0, either keep rule, with or without a row that
    keeps nothing: every kept entry lies in a listed step, every listed
    step holds a kept entry or a row that keeps nothing (whose row tile
    then lists every step, and whose 16-row step every dv list), and a
    128 x 128 tile is flagged exactly where it keeps an entry; lists
    ascending, -1 after their counts."""
    geom = list_geometries[name]
    dist, thr = (geom.m_cross_t, geom.thr_down) if op == "down" else (geom.m_cross, geom.thr_up)
    thr = thr.clone()
    if empty_row:  # row 130 keeps nothing for every head of nonzero scale
        thr[130] = torch.stack([torch.tensor(-1.0), dist[130].max() * 2.0 + 1.0])
    scale = t_tf._bandwidth(torch.tensor(LIST_HEADS).reshape(3, 1), "tan")
    ft, dt = tile
    steps = kf.posatt_tf_fixed_lists_reference(dist, thr, scale, mode, ft, dt)
    assert (steps.fwd_tile, steps.dv_tile) == tile
    _, keep = kf._scaled_keep(dist, thr, scale, mode)
    keep = keep.numpy()
    fwd, dv, tiles, empty = _brute_lists(keep, ft, dt)
    assert empty[:, 130].any() == empty_row
    H, Lo, Li = keep.shape
    nT, nU = -(-Li // 16), -(-Lo // 16)
    for idx, cnt, n in ((steps.fwd_idx, steps.fwd_cnt, nT), (steps.dv_idx, steps.dv_cnt, nU)):
        assert idx.shape[-1] == n and idx.dtype == cnt.dtype == torch.int32
        for lst, c in zip(idx.reshape(-1, n).tolist(), cnt.reshape(-1).tolist()):
            assert lst[:c] == sorted(set(lst[:c])) and all(v >= 0 for v in lst[:c])
            assert lst[c:] == [-1] * (n - c)
    listed_fwd = {(h, I, v) for h in range(H) for I in range(steps.fwd_idx.shape[1])
                  for v in steps.fwd_idx[h, I, :steps.fwd_cnt[h, I]].tolist()}
    listed_dv = {(h, J, v) for h in range(H) for J in range(steps.dv_idx.shape[1])
                 for v in steps.dv_idx[h, J, :steps.dv_cnt[h, J]].tolist()}
    # every kept entry lies in a listed step
    assert fwd <= listed_fwd and dv <= listed_dv
    # every listed step holds a kept entry or a row that keeps nothing
    for h, I, v in listed_fwd - fwd:
        assert empty[h, ft * I:ft * I + ft].any()
    for h, J, u in listed_dv - dv:
        assert empty[h, 16 * u:16 * u + 16].any()
    # such a row's tile lists every step, its step is in every dv list
    for h, i in zip(*np.nonzero(empty)):
        assert steps.fwd_cnt[h, i // ft] == nT
        assert all((h, J, i // 16) in listed_dv for J in range(steps.dv_idx.shape[1]))
    assert {tuple(v) for v in np.argwhere(steps.tiles.numpy())} == tiles
    # under tan a head of scale 0 keeps every entry, and a positive head
    # lists a small share of a local op's steps
    if mode == 1:
        assert steps.fwd_cnt[1].sum() == steps.fwd_idx[1].numel()
        assert empty_row or steps.fwd_cnt[2].sum() < 0.6 * steps.fwd_idx[2].numel()


# ------------------------------------------------------------- geometry


def test_periodic_distances_and_grids_match_jax():
    """The periodic 1-D and 2-D distance builders (the 2-D one the minimum
    of five images' norms, squared) and grid_2d_rect against JAX's."""
    np.testing.assert_array_equal(t_tf.pairwise_dist_periodic_1d(64, 16).numpy(),
                                  np.asarray(j_tf.pairwise_dist_periodic_1d(64, 16)))
    np.testing.assert_array_equal(t_tf.pairwise_dist_periodic_1d(1024, 1024).numpy(),
                                  np.asarray(j_tf.pairwise_dist_periodic_1d(1024, 1024)))
    g1 = t_meshes.grid_2d(16, endpoint=False).reshape(-1, 2)
    g2 = t_meshes.grid_2d(4, endpoint=False).reshape(-1, 2)
    np.testing.assert_allclose(t_tf.pairwise_dist_periodic_2d(t(g1), t(g2)).numpy(),
                               np.asarray(j_tf.pairwise_dist_periodic_2d(jnp.asarray(g1), jnp.asarray(g2))),
                               rtol=1e-6, atol=0)
    for s0, s1 in ((221, 51), (111, 26), (5, 3)):
        np.testing.assert_array_equal(t_meshes.grid_2d_rect(s0, s1), j_meshes.grid_2d_rect(s0, s1))


def _torus_grids(s1, s2):
    return (t_meshes.grid_2d(s1, endpoint=False).reshape(-1, 2),
            t_meshes.grid_2d(s2, endpoint=False).reshape(-1, 2))


@pytest.mark.parametrize("s1,s2", [(16, 4), (64, 4), (64, 16), (32, 32)])
def test_periodic_2d_distances_equal_jax_to_the_bit(s1, s2):
    """The torus distances equal JAX's bit for bit (its root is correctly
    rounded), vorticity_tf's 64^2 x 4^2 command-line geometry among them,
    where torch's CPU sqrt alone is off by an ulp at 26 entries."""
    g1, g2 = _torus_grids(s1, s2)
    np.testing.assert_array_equal(
        t_tf.pairwise_dist_periodic_2d(t(g1), t(g2)).numpy(),
        np.asarray(j_tf.pairwise_dist_periodic_2d(jnp.asarray(g1), jnp.asarray(g2))))


@pytest.mark.parametrize("rel", [2.0 ** -12, -(2.0 ** -11), 2.0 ** -30])
def test_periodic_2d_distances_and_kept_sets_hold_under_an_inexact_library_sqrt(
        monkeypatch, rel):
    """A process whose library sqrt keeps only about half the bits (MKL's
    vector math does so in some processes) still builds the
    exact torus distances, so vorticity_tf's kept sets are JAX's: a served
    reply once differed from ``infer``'s by 0.02 through such distances."""
    g1, g2 = _torus_grids(64, 4)
    want = np.asarray(j_tf.pairwise_dist_periodic_2d(jnp.asarray(g1), jnp.asarray(g2)))
    exact_sqrt = torch.sqrt
    monkeypatch.setattr(torch, "sqrt", lambda y: exact_sqrt(y) * (1.0 + rel))
    m = t_tf.pairwise_dist_periodic_2d(t(g1), t(g2))
    np.testing.assert_array_equal(m.numpy(), want)
    for loc in (1.0, 8.0):  # vorticity_tf's encoder and decoder localities
        rows = (m.T.contiguous(), want.T) if loc == 1.0 else (m, want)
        thr = t_tf.percentile_thresholds(rows[0], loc)
        j_thr = np.quantile(rows[1], [loc / 100.0, 1 - loc / 100.0], axis=-1).T
        keep = (rows[0] <= thr[:, :1]).numpy()
        np.testing.assert_array_equal(keep, rows[1] <= j_thr[:, :1].astype(np.float32))


@pytest.mark.parametrize("en_loc,de_loc", [(1.0, 8.0), (0.5, 2.0), (200.0, 5.0)])
def test_precomputed_thresholds_match_jax(en_loc, de_loc):
    """Both quantiles of each row of m_cross.T, m_cross and m_qry, on
    random distances; None for a global locality."""
    rng = np.random.default_rng(2)
    mq, mc, ml = (rng.random(s).astype(np.float32) for s in ((40, 40), (40, 12), (12, 12)))
    jg = j_tf.tf_precompute_thresholds(j_tf.TFGeometry(jnp.asarray(mq), jnp.asarray(mc), jnp.asarray(ml)),
                                       en_loc, de_loc)
    tg = t_tf.tf_precompute_thresholds(t_tf.TFGeometry(t(mq), t(mc), t(ml)), en_loc, de_loc)
    for k in ("thr_down", "thr_up", "thr_qry"):
        jv, tv = getattr(jg, k), getattr(tg, k)
        assert (jv is None) == (tv is None), k
        if jv is not None:
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=0, err_msg=k)
    np.testing.assert_array_equal(tg.m_cross_t.numpy(), mc.T)
    moved = tg.to("cpu")
    assert isinstance(moved, t_tf.TFGeometry) and torch.equal(moved.thr_up, tg.thr_up)


# ------------------------------------------------------------- the setups


@pytest.fixture(scope="module")
def ns_file(tmp_path_factory):
    """A 16^2 vorticity file: the loaders take the grid from the data."""
    path = tmp_path_factory.mktemp("ns") / "ns_16.mat"
    savemat(path, {"u": t_syn.vorticity(n=14, s=16, frames=14, seed=2)})
    return str(path)


# name -> (overrides, ntrain, ntest, setup kwargs)
SMALL = {
    "burgers_tf": (["grid=64", "latent_grid=32"], 10, 5, {}),
    "sod_tf": (["grid=64", "latent_grid=32"], 8, 4, {}),
    "darcy_tf": (["latent_grid=4,4"], 8, 4, {"downsampling": 40}),
    "vorticity_tf": (["latent_grid=4,4", "rollout_steps=3"], 8, 4, {}),
    "naca_tf": (["grid=23,11", "latent_grid=12,6"], 8, 4, {}),
}
NARROW = ["model.hid_dim=16", "model.n_blocks=1"]


@pytest.fixture(scope="module")
def problems(ns_file):
    """name -> (JAX problem, port problem, JAX params) at the small sizes."""
    out = {}
    for name, (overrides, ntrain, ntest, kw) in SMALL.items():
        j_cfg = j_configs.apply_overrides(j_configs.get(name), NARROW + overrides)
        t_cfg = t_configs.apply_overrides(t_configs.get(name), NARROW + overrides)
        path = ns_file if name == "vorticity_tf" else None
        jp = j_bench.setup(j_cfg, path, ntrain=ntrain, ntest=ntest, **kw)
        tp = t_bench.setup(t_cfg, path, ntrain=ntrain, ntest=ntest, device="cpu", **kw)
        params = jp.init_fn(jax.random.PRNGKey(0), jp.train_data)["params"]
        out[name] = (jp, tp, params)
    return out


def _carried(jg) -> t_tf.TFGeometry:
    """JAX's geometry as the port's (m_cross_t built from it)."""
    g = t_tf.TFGeometry(*(None if a is None else t(a) for a in jg))
    return g._replace(m_cross_t=g.m_cross.T.contiguous())


def _kept_differences(tg, jg):
    """The entries kept under one side's thresholds and not the other's,
    and whether each lies within two ulps of JAX's threshold (a tie the
    two quantiles round apart)."""
    n, near = 0, True
    for m, k in ((tg.m_cross_t, "thr_down"), (tg.m_cross, "thr_up"), (tg.m_qry, "thr_qry")):
        tv, jv = getattr(tg, k), getattr(jg, k)
        if tv is None:
            continue
        for c in (0, 1):
            jt = t(jv)[:, c:c + 1].expand_as(m)
            diff = (m <= tv[:, c:c + 1]) != (m <= jt)
            n += int(diff.sum())
            near &= bool(((m - jt).abs() <= 2.4e-7 * jt.abs())[diff].all())
    return n, near


@pytest.mark.parametrize("name", list(SMALL))
def test_setup_matches_jax(problems, name):
    """The same data (darcy_tf's normalized inputs within rounding, as
    test_torch_darcy.py holds them), distance matrices and thresholds (rtol
    1e-6; the kept sets they give are equal but at darcy_tf's two ties),
    the TF Task conventions, and naca_tf's NonNeg constraint."""
    jp, tp, _ = problems[name]
    for split in ("train_data", "test_data"):
        jd, td = getattr(jp, split), getattr(tp, split)
        assert set(jd) == set(td) == {"x", "y"}
        np.testing.assert_array_equal(td["y"], np.asarray(jd["y"]))
        if name == "darcy_tf":
            np.testing.assert_allclose(td["x"], np.asarray(jd["x"]), rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(td["x"], np.asarray(jd["x"]))
    assert tp.extras == jp.extras
    jg, tg = jp.geom, tp.geom
    for k in ("m_qry", "m_cross", "m_ltt", "thr_down", "thr_up", "thr_qry"):
        jv, tv = getattr(jg, k), getattr(tg, k)
        assert (jv is None) == (tv is None), k
        if jv is not None:
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=0, err_msg=k)
    # darcy_tf's 11^2 grid flips 2 tied entries (as setup_darcy's geometry
    # does, test_torch_darcy.py): the model tests carry JAX's over
    n, near = _kept_differences(tg, jg)
    assert near and n <= (2 if name == "darcy_tf" else 0), n
    task = tp.task
    assert task.batch_mean_loss and task.keras_adam and task.apply_fn is not None
    assert (task.param_constraint is t_bench.nonneg_bandwidths) == (name == "naca_tf")
    assert type(tp.model).__name__ == "PiTTF"


@pytest.mark.parametrize("name", list(SMALL))
def test_forward_matches_jax(problems, name):
    """The port's PiTTF with carried weights on JAX's geometry against the
    JAX model through each Task's forward (darcy_tf denormalizes)."""
    jp, tp, params = problems[name]
    tp.model.load_state_dict(flax_tf_params_to_state_dict(params))
    geom = _carried(jp.geom)
    jb = {"x": jp.train_data["x"][:4]}
    with torch.inference_mode():
        got = tp.task.forward(geom, {"x": t(jb["x"])}).numpy()
    want = np.asarray(jp.task.forward(params, jp.geom, jb))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=MODEL_RTOL, atol=MODEL_ATOL)


def _query_mesh(tp):
    """The query mesh the setup concatenates to the inputs."""
    name, L = tp.config.name, np.shape(tp.train_data["x"])[1]
    if name in ("burgers_tf", "sod_tf"):
        return t_meshes.grid_1d(L)
    if name == "naca_tf":
        return t_meshes.grid_2d_rect(*tp.config.grid)
    return t_meshes.grid_2d(tp.extras["s"], endpoint=False).reshape(-1, 2)


@pytest.mark.parametrize("name", list(SMALL))
def test_forward_matches_numpy_oracle(problems, name):
    """PiTTF with JAX's weights and its thresholds computed in the call
    against the float64 oracle's pit_tf_forward (per-head percentiles of
    the scaled distances), on random distances (no ties)."""
    jp, tp, params = problems[name]
    tp.model.load_state_dict(flax_tf_params_to_state_dict(params))
    rng = np.random.default_rng(7)
    jg = jp.geom
    shape = lambda m: None if m is None else np.asarray(m).shape
    mq, mc, ml = (None if s is None else rng.random(s).astype(np.float32)
                  for s in (shape(jg.m_qry), shape(jg.m_cross), shape(jg.m_ltt)))
    x = np.asarray(jp.train_data["x"][:2])
    bandwidth, selfatt = t_bench.TF_FIXED[name]
    mesh = _query_mesh(tp)
    geom = t_tf.TFGeometry(None if mq is None else t(mq), t(mc), t(ml))
    with torch.inference_mode():
        got = tp.model(geom, t(mesh), t(x)).numpy()
    np_params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params)
    m = tp.config.model
    want = oracle.pit_tf_forward(np_params, mq, mc, ml, mesh, x, m.en_loc, m.de_loc,
                                 n_blocks=m.n_blocks, bandwidth=bandwidth,
                                 use_decoder_selfatt=selfatt)
    np.testing.assert_allclose(got, want, rtol=ORACLE_RTOL, atol=ORACLE_ATOL)


def test_vorticity_tf_rollout_matches_jax(problems):
    """vorticity_tf's 3-step rollout predictions and its trajectory loss."""
    jp, tp, params = problems["vorticity_tf"]
    tp.model.load_state_dict(flax_tf_params_to_state_dict(params))
    geom = _carried(jp.geom)
    jb = {k: v[:4] for k, v in jp.train_data.items()}
    with torch.inference_mode():
        got = tp.task.rollout_preds(geom, {k: t(v) for k, v in jb.items()}).numpy()
        loss = float(tp.task.loss_fn(geom, {k: t(v) for k, v in jb.items()}))
    want = np.asarray(jp.task.rollout_preds(params, jp.geom, jb))
    np.testing.assert_allclose(got, want, rtol=MODEL_RTOL, atol=MODEL_ATOL * np.abs(want).max())
    np.testing.assert_allclose(loss, float(jp.task.loss_fn(params, jp.geom, jb)), rtol=LOSS_RTOL)


def test_naca_tf_keras_adam_steps_with_nonneg_match_jax(problems):
    """Two keras-Adam steps of naca_tf with the NonNeg projection after
    each update: JAX value_and_grad + _keras_adam + the constraint against
    the port's train epoch; some band_width starts negative and ends at 0
    on both sides."""
    import optax

    jp, tp, params = problems["naca_tf"]
    tp.model.load_state_dict(flax_tf_params_to_state_dict(params))
    bw0 = {k: np.asarray(v["band_width"]) for k, v in params.items() if "band_width" in v}
    assert min(v.min() for v in bw0.values()) < 0
    lr, total = 1e-2, 10
    perm = np.array([[0, 1, 2, 3, 4, 5, 6, 7], [7, 6, 5, 4, 3, 2, 1, 0]])
    optimizer = j_loop.make_optimizer(lr, total, flavor="keras")
    opt_state = optimizer.init(params)
    jlosses = []
    for idx in perm:
        batch = {k: v[idx] for k, v in jp.train_data.items()}
        loss, grads = jax.value_and_grad(jp.task.loss_fn)(params, jp.geom, batch)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = jp.task.param_constraint(optax.apply_updates(params, updates))
        jlosses.append(float(loss))
    state = t_loop.TrainState(tp.model, t_loop.make_optimizer(tp.model.parameters(), lr, "keras"))
    train_epoch = t_loop.make_train_epoch(tp.task, t_loop.make_lr_schedule(lr, total))
    data = {k: t(v) for k, v in tp.train_data.items()}
    state, losses = train_epoch(state, _carried(jp.geom), data, t(perm))
    np.testing.assert_allclose(losses.numpy(), jlosses, rtol=LOSS_RTOL)
    want = flax_tf_params_to_state_dict(params)
    for k, v in tp.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=k)
        if k.endswith("band_width"):
            assert (v >= 0).all() and (want[k] >= 0).all()
    assert any((want[k] == 0).any() for k in want if k.endswith("band_width"))


@pytest.mark.parametrize("name", ["burgers_tf", "naca_tf"])
def test_state_dict_carries_the_full_width_tree(name):
    """flax_tf_params_to_state_dict on full-width PiTTF params: band_width
    (H, 1, 1), the Dense kernels transposed, the TFMlp pairs, and
    burgers_tf's up2, mlp and w."""
    j_cfg, t_cfg = j_configs.get(name), t_configs.get(name)
    m = j_cfg.model
    bandwidth, selfatt = t_bench.TF_FIXED[name]
    jm = j_tf.PiTTF(out_dim=m.out_dim, hid_dim=m.hid_dim, n_head=m.n_head,
                    locality_encoder=m.en_loc, locality_decoder=m.de_loc, n_blocks=m.n_blocks,
                    bandwidth=bandwidth, use_decoder_selfatt=selfatt)
    Lq, Ll = 12, 5
    geom = j_tf.TFGeometry(jnp.zeros((Lq, Lq)), jnp.zeros((Lq, Ll)), jnp.zeros((Ll, Ll)))
    shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), geom, jnp.zeros((Lq, m.space_dim)), x),
                            jax.ShapeDtypeStruct((1, Lq, m.in_dim), jnp.float32))["params"]
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = flax_tf_params_to_state_dict(params)
    model = t_bench._make_model(t_cfg)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    H, V = m.n_head, m.hid_dim // m.n_head
    assert sd["down.band_width"].shape == (H, 1, 1) and sd["MHPA_3.weight"].shape == (H, m.hid_dim, V)
    assert sd["en_layer.weight"].shape == (m.hid_dim, m.space_dim + m.in_dim)
    assert ("up2.band_width" in sd) == selfatt
    model.load_state_dict(sd)


def test_unported_variants_and_dtypes_raise():
    """Every model variant is ported: naca_tf builds its lite and
    transformer models and refuses selfpit with the JAX package's words
    (its latent grid is not its query grid); an unknown attention kind or
    variant raises. bf16 builds and runs (output float32); a name that is
    not a floating-point dtype raises."""
    assert type(t_tf.PiTTF(3, 1, 8, 2, 1.0, 8.0, coder_attention="hybrid").down).__name__ == (
        "SelfMultiHeadPosAtt")
    with pytest.raises(ValueError, match="unknown attention kind"):
        t_tf.PiTTF(3, 1, 8, 2, 1.0, 8.0, coder_attention="cosine")
    bf16 = t_tf.PiTTF(3, 1, 8, 2, 200.0, 200.0, compute_dtype="bfloat16",
                      generator=torch.Generator().manual_seed(0))
    d = t_tf.pairwise_dist_periodic_1d(16, 16)
    geom = t_tf.TFGeometry(m_qry=d, m_cross=d, m_ltt=d)
    out = bf16(geom, torch.linspace(0, 1, 17)[:-1, None], torch.rand(2, 16, 2))
    assert out.dtype == torch.float32 and out.shape == (2, 16, 1) and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="not a floating-point dtype"):
        t_tf.PiTTF(3, 1, 8, 2, 1.0, 8.0, compute_dtype="complex")
    for variant, processor in (("lite", "MultiHeadSelfAtt"), ("transformer", "MultiHeadSelfAtt")):
        cfg = dataclasses.replace(t_configs.NACA_TF, model_variant=variant)
        assert type(t_bench._make_model(cfg).MHPA_0).__name__ == processor
    with pytest.raises(ValueError, match="latent == query"):
        t_bench._make_model(dataclasses.replace(t_configs.NACA_TF, model_variant="selfpit"))
    with pytest.raises(ValueError, match="unknown model variant"):
        t_bench._make_model(dataclasses.replace(t_configs.SOD_TF, model_variant="nope"))
