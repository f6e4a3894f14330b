"""The rest of the ops core against the JAX package, on the CPU: the TF-side
loss ``rel_norm_mean``, ``midpoint_to_next``, the ``exact_torch_quantile``
option of position attention, ``build_geometry``'s ``precompute_masks``,
``threshold_impl`` and batched non-lazy (B, L, d) meshes, the 3-D ``dist``
route (``kernels.position_attention_dist``, whose plain path stands in for
kernels #9/#10 here) and a narrow PiT on batched non-lazy geometry.

Tolerances: a metric rtol 1e-6 (one reduction in another order);
distances, ``midpoint_to_next`` and the top-k thresholds equal to the bit
(the same operations on both sides), quantile thresholds within rtol 1e-6
(another interpolation order) with equal kept sets; one attention op rtol 2e-5 / atol
2e-6 and its gradients on their terms' magnitude (the single-op bound of
tests/test_torch_model.py); the model's forward rtol 1e-4 / atol 1e-5 and
three Adam steps at losses rtol 2e-4, weights rtol 5e-3 / atol 2e-5
(tests/test_torch_model.py's and tests/test_torch_train.py's bounds).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from position_induced_transformer_torch import configs as t_configs
from position_induced_transformer_torch import models as t_models
from position_induced_transformer_torch import ops as t_ops
from position_induced_transformer_torch.kernels import position_attention_dist
from position_induced_transformer_torch.models import PiT as TPiT
from position_induced_transformer_torch.models import build_geometry as t_build
from position_induced_transformer_torch.ops import locality as t_loc
from position_induced_transformer_torch.ops import metrics as t_metrics
from position_induced_transformer_torch.ops import posatt as t_posatt
from position_induced_transformer_torch.train import loop as t_loop
from position_induced_transformer_torch.utils.torch_compat import flax_params_to_state_dict
from position_induced_transformer_tpu import models as j_models
from position_induced_transformer_tpu import ops as j_ops
from position_induced_transformer_tpu.data import meshes as j_meshes
from position_induced_transformer_tpu.models import PiT as JPiT
from position_induced_transformer_tpu.models import build_geometry as j_build
from position_induced_transformer_tpu.ops import locality as j_loc
from position_induced_transformer_tpu.ops import metrics as j_metrics
from position_induced_transformer_tpu.ops import posatt as j_posatt
from position_induced_transformer_tpu.train import loop as j_loop

torch.set_num_threads(1)

OP_RTOL, OP_ATOL = 2e-5, 2e-6
MODEL_RTOL, MODEL_ATOL = 1e-4, 1e-5
LOSS_RTOL = 2e-4
PARAM_RTOL, PARAM_ATOL = 5e-3, 2e-5

t = torch.from_numpy


def test_exports_match_jax():
    """``ops`` and ``models`` export the names the JAX package exports."""
    assert t_ops.__all__ == j_ops.__all__
    assert t_models.__all__ == j_models.__all__
    for mod in (t_ops, t_models):
        for name in mod.__all__:
            assert getattr(mod, name) is not None


@pytest.mark.parametrize("p", [1, 2, 3])
def test_rel_norm_mean_matches_jax(p):
    rng = np.random.default_rng(p)
    true = rng.standard_normal((5, 17, 3)).astype(np.float32)
    pred = true + 0.1 * rng.standard_normal((5, 17, 3)).astype(np.float32)
    got = t_metrics.rel_norm_mean(t(true), t(pred), p=p)
    want = j_metrics.rel_norm_mean(jnp.asarray(true), jnp.asarray(pred), p=p)
    assert got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_midpoint_to_next_matches_jax():
    """Random rows, rows with ties at the threshold, and a row whose
    entries all tie (nothing greater: the threshold stays)."""
    rng = np.random.default_rng(0)
    dist = rng.random((6, 40)).astype(np.float32)
    dist[1, :5] = dist[1, 5]  # a tie group at the cut
    dist[2] = 0.25  # nothing strictly greater
    thr = np.sort(dist, axis=-1)[:, 7:8].copy()
    got = t_loc.midpoint_to_next(t(dist), t(thr)).numpy()
    want = np.asarray(j_loc.midpoint_to_next(jnp.asarray(dist), jnp.asarray(thr)))
    np.testing.assert_array_equal(got, want)
    assert got[2, 0] == thr[2, 0]
    np.testing.assert_array_equal(dist <= got, dist <= thr)  # the kept sets stay


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("locality", [0.1, 1.0])
def test_exact_torch_quantile_matches_jax(batched, locality):
    """The reference's mask, a per-head quantile over the scaled
    distances, on a fixed (L_out, L_in) and a batched (B, L_out, L_in)
    ``dist``: the weights and the full op."""
    rng = np.random.default_rng(1)
    shape = (3, 20, 30) if batched else (20, 30)
    dist = rng.random(shape).astype(np.float32)
    lmda = rng.random((2, 1, 1)).astype(np.float32)
    u = rng.standard_normal((3, 30, 4)).astype(np.float32)
    kw = dict(exact_torch_quantile=True)
    w = t_posatt.attention_weights(t(dist), t(lmda), locality, **kw).numpy()
    want = np.asarray(j_posatt.attention_weights(jnp.asarray(dist), jnp.asarray(lmda), locality, **kw))
    np.testing.assert_allclose(w, want, rtol=OP_RTOL, atol=OP_ATOL)
    got = t_posatt.position_attention(t(dist), t(lmda), t(u), locality, **kw).numpy()
    want = np.asarray(j_posatt.position_attention(
        jnp.asarray(dist), jnp.asarray(lmda), jnp.asarray(u), locality, **kw))
    np.testing.assert_allclose(got, want, rtol=OP_RTOL, atol=OP_ATOL)
    if locality < 1.0:  # the quantile commutes with the scale: the default mask keeps the same
        plain = t_posatt.attention_weights(t(dist), t(lmda), locality).numpy()
        np.testing.assert_array_equal(plain > 0, w > 0)
        assert 0 < (w > 0).mean() < 1


def _meshes(batched, rng):
    if batched:
        m = rng.random((3, 40, 2)).astype(np.float32)
        return m, m, m, "euclidean"
    mesh, ltt = j_meshes.grid_1d(64), j_meshes.grid_1d(16)
    return mesh, ltt, mesh, "periodic1d"


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("option", ["quantile", "topk", "no_masks"])
def test_build_geometry_options_match_jax(batched, option):
    """``threshold_impl="quantile"|"topk"`` and ``precompute_masks=False``
    on a fixed periodic 1-D mesh and on batched (B, L, d) clouds: the same
    shapes and distances, the same thresholds within rounding (top-k's to
    the bit), the same kept sets."""
    rng = np.random.default_rng(2)
    mi, ml, mo, metric = _meshes(batched, rng)
    kw = dict(metric=metric, en_loc=0.1, de_loc=0.2)
    kw.update({"no_masks": dict(precompute_masks=False)}.get(option, dict(threshold_impl=option)))
    tg = t_build(mi, ml, mo, device="cpu", **kw)
    jg = j_build(jnp.asarray(mi), jnp.asarray(ml), jnp.asarray(mo), **kw)
    lead = (3,) if batched else ()
    for name, shape in (("dist_down", (16, 64)), ("dist_proc", (16, 16)), ("dist_up", (64, 16))):
        if batched:
            shape = (40, 40)
        got, want = getattr(tg, name).numpy(), np.asarray(getattr(jg, name))
        assert got.shape == want.shape == lead + shape
        np.testing.assert_array_equal(got, want)
    for side in ("down", "up"):
        got, want = getattr(tg, f"thr_{side}"), getattr(jg, f"thr_{side}")
        if option == "no_masks":
            assert got is None and want is None
            continue
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape == getattr(tg, f"dist_{side}").shape[:-1] + (1,)
        if option == "topk":  # the same minima of the same distances
            np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        d_t, d_j = getattr(tg, f"dist_{side}").numpy(), np.asarray(getattr(jg, f"dist_{side}"))
        np.testing.assert_array_equal(d_t <= got, d_j <= want)
    assert tg.mesh_ltt is None and tg.mesh_out is None


def test_geometry_option_refusals():
    m = np.zeros((2, 8, 2), np.float32)
    with pytest.raises(ValueError, match="threshold_impl"):
        t_build(m, m, m, threshold_impl="sort", device="cpu")
    with pytest.raises(ValueError, match="euclidean"):
        t_build(m, m, m, metric="periodic1d", device="cpu")
    with pytest.raises(ValueError, match="one batch size"):
        t_build(m, m[:1], m, device="cpu")


def _dist_case(rng, B, Lo, Li, H, D):
    dist = (4 * rng.random((B, Lo, Li))).astype(np.float32)
    lmda = rng.uniform(-1, 1, (H, 1, 1)).astype(np.float32)
    u = rng.standard_normal((B, Li, D)).astype(np.float32)
    return dist, lmda, u


@pytest.mark.parametrize("locality,with_thr", [(1.0, False), (0.1, False), (0.2, True)])
def test_position_attention_dist_plain_matches_jax(locality, with_thr):
    """The 3-D ``dist`` wrapper on CPU tensors (the plain versions of #9 and
    #10) against ``ops/posatt.position_attention``: the output and the
    gradients of ``lmda`` and ``u``. With ``thr`` given, two rows keep
    nothing (``thr`` below the row's least distance): the uniform mean of
    ``u``, as the reference's softmax of all ``-F32_MAX`` logits gives."""
    rng = np.random.default_rng(3)
    B, Lo, Li, H, D = 2, 9, 23, 3, 5
    dist, lmda, u = _dist_case(rng, B, Lo, Li, H, D)
    g = rng.standard_normal((B, Lo, H * D)).astype(np.float32)
    thr = None
    if with_thr:
        thr = np.quantile(dist, locality, axis=-1, keepdims=True).astype(np.float32)
        thr[0, 2, 0] = dist[0, 2].min() * 0.5
        thr[1, 7, 0] = -1.0

    tl, tu = t(lmda).requires_grad_(), t(u).requires_grad_()
    out = position_attention_dist(t(dist), tl, tu, locality, None if thr is None else t(thr))
    (out * t(g)).sum().backward()

    def f(lm, uu):
        o = j_posatt.position_attention(jnp.asarray(dist), lm, uu, locality,
                                        thr=None if thr is None else jnp.asarray(thr))
        return jnp.sum(o * jnp.asarray(g)), o

    (_, want), (jgl, jgu) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(lmda), jnp.asarray(u))
    assert out.shape == (B, Lo, H * D)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=OP_RTOL, atol=OP_ATOL)
    if with_thr:
        mean = np.tile(u.mean(axis=1), (1, H))
        np.testing.assert_allclose(out[0, 2].detach().numpy(), mean[0], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(out[1, 7].detach().numpy(), mean[1], rtol=1e-6, atol=1e-7)
    # du sums |g| over kept rows; the bandwidth's gradient is a cancelling
    # sum, held on the magnitude of its terms
    size_u = np.abs(g).reshape(B, Lo, H, D).sum(axis=(1, 2))[:, None, :]
    np.testing.assert_allclose(tu.grad.numpy(), np.asarray(jgu), rtol=0,
                               atol=OP_ATOL + OP_RTOL * size_u.max())
    size_l = float(np.abs(g).sum() * dist.max() * np.abs(u).max())
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jgl), rtol=0, atol=OP_RTOL * size_l)


def test_position_attention_dist_without_grad_and_refusals():
    rng = np.random.default_rng(4)
    dist, lmda, u = _dist_case(rng, 2, 5, 7, 2, 3)
    with torch.no_grad():
        got = position_attention_dist(t(dist), t(lmda), t(u), 0.3)
    want = t_posatt.position_attention(t(dist), t(lmda), t(u), 0.3)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=OP_RTOL, atol=OP_ATOL)
    with pytest.raises(ValueError, match="B, L_out, L_in"):
        position_attention_dist(t(dist[0]), t(lmda), t(u), 0.3)
    with pytest.raises(ValueError, match="unsupported device"):
        position_attention_dist(t(dist).to("meta"), t(lmda), t(u), 0.3)


def _batched_models(B_init, L, in_dim, seed=0):
    m = dataclasses.replace(t_configs.ELASTICITY.model, in_dim=in_dim, hid_dim=16, n_blocks=2,
                            en_loc=0.1, de_loc=0.1)
    fields = dict(space_dim=m.space_dim, in_dim=m.in_dim, out_dim=m.out_dim, hid_dim=m.hid_dim,
                  n_head=m.n_head, n_blocks=m.n_blocks, en_loc=m.en_loc, de_loc=m.de_loc,
                  concat_mesh=m.concat_mesh)
    mesh = np.random.default_rng(seed + 1).random((B_init, L, 2)).astype(np.float32)
    jm = jnp.asarray(mesh)
    jg = j_build(jm, jm, jm, en_loc=m.en_loc, de_loc=m.de_loc)
    jmodel = JPiT(**fields)
    params = jmodel.init(jax.random.PRNGKey(seed), jg, jnp.ones((B_init, L, in_dim)))["params"]
    tmodel = TPiT(**fields)
    tmodel.load_state_dict(flax_params_to_state_dict(params))
    return m, jmodel, params, tmodel


def test_batched_pit_forward_matches_jax():
    """A narrow elasticity-style PiT (hid 16, 2 heads, 2 blocks, no mesh
    concat, locality 0.1) on batched non-lazy geometry of 3 random
    40-point clouds: every attention op takes the 3-D ``dist`` route."""
    B, L, in_dim = 3, 40, 6
    m, jmodel, params, tmodel = _batched_models(B, L, in_dim)
    rng = np.random.default_rng(5)
    mesh = rng.random((B, L, 2)).astype(np.float32)
    x = rng.standard_normal((B, L, in_dim)).astype(np.float32)
    jm = jnp.asarray(mesh)
    jg = j_build(jm, jm, jm, en_loc=m.en_loc, de_loc=m.de_loc)
    want = np.asarray(jmodel.apply({"params": params}, jg, jnp.asarray(x)))
    tg = t_build(mesh, mesh, mesh, en_loc=m.en_loc, de_loc=m.de_loc, device="cpu")
    assert tg.dist_proc.shape == (B, L, L) and tg.thr_down.shape == (B, L, 1)
    with torch.no_grad():
        got = tmodel(tg, t(x)).numpy()
    assert got.shape == want.shape == (B, L, 1)
    np.testing.assert_allclose(got, want, rtol=MODEL_RTOL, atol=MODEL_ATOL)


def test_batched_pit_three_training_steps_match_jax():
    """Three Adam steps at batch 2 on a cosine schedule over 10, each batch
    on its own clouds' non-lazy geometry (a ``geom_fn`` on both sides)."""
    n, L, in_dim, B = 6, 32, 4, 2
    m, jmodel, params, tmodel = _batched_models(B, L, in_dim, seed=1)
    rng = np.random.default_rng(6)
    data = {"x": rng.standard_normal((n, L, in_dim)).astype(np.float32),
            "mesh": rng.random((n, L, 2)).astype(np.float32),
            "y": rng.standard_normal((n, L, 1)).astype(np.float32)}
    perm = np.array([[0, 1], [2, 3], [4, 1]])
    lr, total = 1e-3, 10

    j_task = j_loop.Task(model=jmodel, loss_p=2, out_dim=1, geom_fn=lambda b: j_build(
        b["mesh"], b["mesh"], b["mesh"], en_loc=m.en_loc, de_loc=m.de_loc))
    optimizer = j_loop.make_optimizer(lr, total)
    opt_state = optimizer.init(params)

    @jax.jit
    def step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(j_task.loss_fn)(params, None, batch)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    jlosses = []
    for idx in perm:
        params, opt_state, loss = step(params, opt_state, {k: jnp.asarray(v[idx]) for k, v in data.items()})
        jlosses.append(float(loss))

    t_task = t_loop.Task(model=tmodel, loss_p=2, out_dim=1, geom_fn=lambda b: t_build(
        b["mesh"], b["mesh"], b["mesh"], en_loc=m.en_loc, de_loc=m.de_loc, device="cpu"))
    state = t_loop.TrainState(tmodel, t_loop.make_optimizer(tmodel.parameters(), lr))
    train_epoch = t_loop.make_train_epoch(t_task, t_loop.make_lr_schedule(lr, total))
    state, losses = train_epoch(state, None, {k: t(v) for k, v in data.items()}, t(perm))
    np.testing.assert_allclose(losses.numpy(), jlosses, rtol=LOSS_RTOL)
    want = flax_params_to_state_dict(params)
    for k, v in tmodel.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=k)


def test_registered_dense_elasticity_problem_trains_and_serves(tmp_path):
    """``chip_smoke.py``'s elasticity problem on batched non-lazy geometry,
    registered through ``register_benchmark``, at a narrow width (hid 16,
    1 block) on 300-point clouds on the CPU: one ``runner.train`` step
    and a ``Predictor`` batch through the 3-D ``dist`` route, the served
    batch equal to the model on the geometry its ``geom_fn`` builds."""
    import importlib.util
    from pathlib import Path

    from position_induced_transformer_torch.train import benchmarks as t_bench
    from position_induced_transformer_torch.train import runner as t_runner
    from position_induced_transformer_torch.train.evaluate import Predictor

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_module", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    small = t_configs.apply_overrides(t_configs.ELASTICITY, ["model.hid_dim=16", "model.n_blocks=1"])
    cfg = cs.register_elasticity_dense(small)
    try:
        ckpt = str(tmp_path / "dense.pt")
        kw = dict(setup_kwargs={"n_points": 300}, device="cpu")
        problem, state, history = t_runner.train(cfg, epochs=1, ntrain=10, ntest=4, verbose=False,
                                                 checkpoint_path=ckpt, **kw)
        assert state.step == 1 and np.isfinite(history[0]["train_loss"])
        assert set(problem.train_data) == {"x", "mesh", "y"}
        batch = {k: t(v[:4]) for k, v in problem.test_data.items()}
        geom = problem.task.geom_fn(batch)
        assert geom.dist_proc.shape == (4, 300, 300) and geom.thr_up.shape == (4, 300, 1)
        pred = Predictor(cfg, ckpt, **kw)
        got = pred.predict_array({"x": batch["x"].numpy(), "mesh": batch["mesh"].numpy()})
        with torch.no_grad():
            want = state.model(geom, batch["x"]).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    finally:
        t_configs.REGISTRY.pop(cfg.name, None)
        t_bench.SETUPS.pop(cfg.name, None)
