"""The TF family's ablation variants (``--model-variant lite | transformer |
selfpit``), ``models/baselines.py`` and kernel #14's plain versions against
the JAX package, on the CPU.

On the CPU kernel #14's wrapper and autograd Function run its plain
versions. The attention ops (``MultiHeadSelfAtt``, ``SelfMultiHeadPosAtt``:
the projections, the attention and the GELU) with the same weights are held
against the JAX modules, forward and ``jax.grad``, at rtol 1e-5 / atol 1e-6
(both float32, sums in another order); the hybrid's bandwidth gradient and
the query and key projections' gradients, sums over the batch and the rows
of the logits' cancelling gradient ``p (dp - delta)``, at rtol 5e-4 / atol
5e-6 on terms normalised to unit size (tests/test_pallas.py's bound). The hybrid's thresholds are the per-head
quantile of the scaled distances taken in every call, as in JAX; their kept
sets are held equal to JAX's. Whole models with carried weights at rtol
1e-4 / atol 1e-5; training steps at losses rtol 2e-4 and weights rtol 5e-3 /
atol 2e-5 (tests/test_torch_tf_fixed.py's bounds). The CUDA kernels
themselves are tested on the card by test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from position_induced_transformer_torch import configs as t_configs
from position_induced_transformer_torch.kernels import dotatt as kd
from position_induced_transformer_torch.models import baselines as t_base
from position_induced_transformer_torch.models import pit_tf as t_tf
from position_induced_transformer_torch.train import benchmarks as t_bench
from position_induced_transformer_torch.train import loop as t_loop
from position_induced_transformer_torch.train import runner as t_runner
from position_induced_transformer_torch.utils.torch_compat import flax_tf_params_to_state_dict
from position_induced_transformer_tpu import configs as j_configs
from position_induced_transformer_tpu.models import baselines as j_base
from position_induced_transformer_tpu.models import pit_tf as j_tf
from position_induced_transformer_tpu.train import benchmarks as j_bench
from position_induced_transformer_tpu.train import loop as j_loop

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
DS_RTOL, DS_ATOL = 5e-4, 5e-6
MODEL_RTOL, MODEL_ATOL = 1e-4, 1e-5
LOSS_RTOL = 2e-4
PARAM_RTOL, PARAM_ATOL = 5e-3, 2e-5
t = lambda a: torch.from_numpy(np.array(a))


def _normalised(got, want):
    size = np.abs(want).max() + 1.0
    np.testing.assert_allclose(got / size, want / size, rtol=DS_RTOL, atol=DS_ATOL)


# ------------------------------------------------------------- the ops

# B, L, H, V, input width
SELF_CASES = {"h2_v16": (3, 40, 2, 16, 5), "h1_v8": (2, 17, 1, 8, 3), "h3_v5": (2, 33, 3, 5, 4)}
# locality, r of each head (two heads of V 16, L 40): tan(r) of either sign
HYBRID_CASES = {
    "local_mixed_signs": (10.0, (-0.3, 0.4)),
    "local_positive": (25.0, (0.2, 0.6)),
    "global": (200.0, (0.5, -0.2)),
}


def _inputs(B, L, HV, cin, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, L, cin)).astype(np.float32),
            rng.standard_normal((B, L, HV)).astype(np.float32), rng)


def _carry(module, params):
    for k, v in params.items():
        getattr(module, k).data = t(v)
    return module


@pytest.mark.parametrize("name", list(SELF_CASES))
def test_self_attention_matches_jax_forward_and_grad(name):
    """MultiHeadSelfAtt (kernel #14's plain forward and backward through
    DotAtt) against JAX's module and jax.grad of it in the three
    projections and the inputs."""
    B, L, H, V, cin = SELF_CASES[name]
    x, g, _ = _inputs(B, L, H * V, cin, 0)
    jm = j_tf.MultiHeadSelfAtt(H, H * V)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    f = lambda p, xx: jm.apply({"params": p}, xx)
    want = np.asarray(f(params, jnp.asarray(x)))
    jgp, jgx = jax.grad(lambda p, xx: jnp.sum(f(p, xx) * g), argnums=(0, 1))(params, jnp.asarray(x))
    m = _carry(t_tf.MultiHeadSelfAtt(cin, H, H * V), params)
    xt = t(x).requires_grad_(True)
    got = m(xt)
    (got * t(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(m.value.grad.numpy(), np.asarray(jgp["value"]), rtol=RTOL, atol=ATOL)
    for k in ("query", "key"):
        _normalised(getattr(m, k).grad.numpy(), np.asarray(jgp[k]))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=RTOL, atol=ATOL)


def _hybrid(name, L=40, H=2, V=16, cin=5, B=3, seed=0):
    loc, r = HYBRID_CASES[name]
    x, g, rng = _inputs(B, L, H * V, cin, seed)
    dist = rng.random((L, L)).astype(np.float32)
    jm = j_tf.SelfMultiHeadPosAtt(H, H * V, loc)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(dist), jnp.asarray(x))["params"]
    params = {**params, "band_width": jnp.asarray(np.reshape(r, (H, 1, 1)), jnp.float32)}
    return loc, dist, x, g, jm, params


@pytest.mark.parametrize("name", list(HYBRID_CASES))
def test_hybrid_attention_matches_jax_forward_and_grad(name):
    """SelfMultiHeadPosAtt (tan(r) of either sign, thresholds taken in the
    call) against JAX's module and jax.grad of it in r, the projections and
    the inputs."""
    loc, dist, x, g, jm, params = _hybrid(name)
    f = lambda p, xx: jm.apply({"params": p}, jnp.asarray(dist), xx)
    want = np.asarray(f(params, jnp.asarray(x)))
    jgp, jgx = jax.grad(lambda p, xx: jnp.sum(f(p, xx) * g), argnums=(0, 1))(params, jnp.asarray(x))
    m = _carry(t_tf.SelfMultiHeadPosAtt(5, 2, 32, loc), params)
    xt = t(x).requires_grad_(True)
    got = m(t(dist), xt)
    (got * t(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(m.weight.grad.numpy(), np.asarray(jgp["weight"]), rtol=RTOL, atol=ATOL)
    for k in ("query", "key", "band_width"):
        _normalised(getattr(m, k).grad.numpy(), np.asarray(jgp[k]))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=RTOL, atol=ATOL)


# name -> (B, L, H, V, kind): kind "self", "local" or "global" (hybrid)
PLAIN_CASES = {
    "self_h2_v16": (2, 30, 2, 16, "self"),
    "self_h1_v5_l1": (3, 1, 1, 5, "self"),
    "hybrid_local_h3": (2, 37, 3, 8, "local"),
    "hybrid_global_h2": (2, 25, 2, 12, "global"),
    "hybrid_local_h1_v33": (1, 50, 1, 33, "local"),
    "hybrid_empty_rows": (2, 20, 2, 4, "empty"),
}


def _plain_case(B, L, H, V, kind, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (t(rng.standard_normal((B, L, H, V)).astype(np.float32)) for _ in range(3))
    g = t(rng.standard_normal((B, L, H * V)).astype(np.float32))
    dist = thr = scale = None
    if kind != "self":
        dist = t(rng.random((L, L)).astype(np.float32))
        scale = t(rng.uniform(-0.8, 0.8, H).astype(np.float32))
    if kind in ("local", "empty"):
        thr = torch.quantile(dist * scale.reshape(-1, 1, 1), 0.2, dim=-1)
    if kind == "empty":  # every second row keeps nothing: uniform weights
        thr[:, ::2] = -1e30
    return q, k, v, g, dist, thr, scale


@pytest.mark.parametrize("name", list(PLAIN_CASES))
def test_plain_backward_entry_points_match_autograd(name):
    """The plain dq, dk, dv and dscale entry points (the kernels' backward
    contract) against torch.autograd of the plain forward; the plain row
    statistics and delta against their definitions."""
    q, k, v, g, dist, thr, scale = _plain_case(*PLAIN_CASES[name])
    leaves = [a.clone().requires_grad_(True) for a in (q, k, v)]
    s = None if scale is None else scale.clone().requires_grad_(True)
    out = kd.dotatt_reference(*leaves, dist, thr, s)
    (out * g).sum().backward()
    args = (q, k, v, g, dist, thr, scale)
    B, L, H, V = q.shape
    for fn, leaf in ((kd.dotatt_bwd_dq_reference, leaves[0]), (kd.dotatt_bwd_dk_reference, leaves[1]),
                     (kd.dotatt_bwd_dv_reference, leaves[2])):
        np.testing.assert_allclose(fn(*args).numpy(), leaf.grad.reshape(B, L, H * V).numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=fn.__name__)
    if s is not None:
        _normalised(kd.dotatt_bwd_dscale_reference(*args).numpy(), s.grad.numpy())
    x, _ = kd._logits(q, k, dist, thr, scale)
    stats = kd.dotatt_stats_reference(q, k, dist, thr, scale)
    np.testing.assert_array_equal(stats[0].numpy(), x.amax(-1).numpy())
    np.testing.assert_allclose(stats[1].numpy(), torch.exp(x - stats[0][..., None]).sum(-1).numpy(),
                               rtol=RTOL)
    delta = kd.dotatt_bwd_delta_reference(out.detach(), g, H)
    np.testing.assert_allclose(delta.numpy(), (g * out.detach()).reshape(B, L, H, V).sum(-1)
                               .transpose(1, 2).numpy(), rtol=RTOL, atol=ATOL)
    if PLAIN_CASES[name][-1] == "empty":
        w = torch.softmax(x, -1)
        assert torch.equal(w[:, :, ::2], torch.full_like(w[:, :, ::2], 1.0 / L))


@pytest.mark.parametrize("kind", ["self", "local", "global"])
def test_plain_forward_matches_the_jax_attention_core(kind):
    """The plain forward on given q, k, v against the JAX modules'
    attention core (models/pit_tf.py:180-194 and :231-266, written out in
    jnp on the same arrays), before the GELU."""
    q, k, v, _, dist, thr, scale = _plain_case(2, 29, 2, 16, kind, seed=4)
    Q, K, Vv = (jnp.asarray(a.numpy()).transpose(0, 2, 1, 3) for a in (q, k, v))
    logits = jnp.einsum("...mi,...ni->...mn", Q, K, preferred_element_type=jnp.float32) / 16 ** 0.5
    if dist is not None:
        scaled = jnp.asarray(dist.numpy()) * jnp.asarray(scale.numpy()).reshape(-1, 1, 1)
        if thr is not None:
            mask = jnp.quantile(scaled, 0.2, axis=-1, keepdims=True)
            scaled = jnp.where(scaled <= mask, scaled, jnp.finfo(jnp.float32).max)
        logits = logits - scaled[None]
    out = jnp.einsum("...nj,...jd->...nd", jax.nn.softmax(logits, axis=-1), Vv)
    want = np.asarray(jnp.transpose(out, (0, 2, 1, 3)).reshape(2, 29, 32))
    np.testing.assert_allclose(kd.dotatt_reference(q, k, v, dist, thr, scale).numpy(), want,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("loc", [1.0, 8.0])
@pytest.mark.parametrize("r", [0.4, -0.3], ids=["positive", "negative"])
@pytest.mark.parametrize("L", [64, 1024])
def test_hybrid_kept_sets_equal_jax_on_the_periodic_grid(L, r, loc):
    """The hybrid's in-call thresholds (the per-head row quantile of tan(r)
    d, burgers_tf's localities) keep the entries JAX keeps, for a positive
    and a negative tan(r), on the periodic 1-D grid's tied distances; at L
    64 the whole op too."""
    jd = j_tf.pairwise_dist_periodic_1d(L, L)
    dist = t_tf.pairwise_dist_periodic_1d(L, L)
    np.testing.assert_array_equal(dist.numpy(), np.asarray(jd))
    H = 2
    r_h = np.array([r, r / 2], np.float32).reshape(H, 1, 1)
    sc = jnp.tan(jnp.asarray(r_h))
    jscaled = jd * sc
    jkeep = np.asarray(jscaled <= jnp.quantile(jscaled, loc / 100.0, axis=-1, keepdims=True))
    m = t_tf.SelfMultiHeadPosAtt(4, H, 8, loc)
    m.band_width.data = t(r_h)
    tsc = torch.tan(m.band_width.detach()).reshape(-1)
    thr = m.thresholds(dist, tsc)
    keep = (dist * tsc.reshape(-1, 1, 1) <= thr[:, :, None]).numpy()
    assert int((keep != jkeep).sum()) == 0
    if L == 64:
        rng = np.random.default_rng(5)
        x = rng.standard_normal((2, L, 4)).astype(np.float32)
        jm = j_tf.SelfMultiHeadPosAtt(H, 8, loc)
        params = jm.init(jax.random.PRNGKey(0), jd, jnp.asarray(x))["params"]
        params = {**params, "band_width": jnp.asarray(r_h)}
        _carry(m, params)
        with torch.no_grad():
            got = m(dist, t(x)).numpy()
        want = np.asarray(jm.apply({"params": params}, jd, jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_public_function_dispatch_and_refusals():
    """Without a gradient the plain forward runs alone; a CPU tensor
    handed to a CUDA launcher, mismatched shapes and a width above 256
    raise; a head width of 257 has no kernel."""
    q, k, v, g, dist, thr, scale = _plain_case(2, 12, 2, 8, "local")
    np.testing.assert_array_equal(kd.dot_attention(q, k, v, dist, thr, scale).numpy(),
                                  kd.dotatt_reference(q, k, v, dist, thr, scale).numpy())
    with pytest.raises(ValueError, match="CUDA"):
        kd.dotatt_cuda(q, k, v, dist, thr, scale)
    with pytest.raises(ValueError, match="thr must be"):
        kd.dot_attention(q, k, v, dist, thr[:, :5], scale)
    with pytest.raises(ValueError, match="need dist"):
        kd.dot_attention(q, k, v, None, thr, scale)
    with pytest.raises(ValueError, match="largest"):
        kd._width(257)
    assert [kd._width(n) for n in (1, 16, 17, 64, 100, 256)] == [16, 16, 32, 64, 128, 256]
    assert kd.head_scale(32) == float(np.float32(32 ** 0.5))


# ------------------------------------------------------------- the models

NARROW = ["model.hid_dim=16", "model.n_blocks=1"]
# name -> (benchmark, variant, overrides, ntrain, ntest, setup kwargs)
FIXED = {
    "burgers_tf_lite": ("burgers_tf", "lite", ["grid=64", "latent_grid=32"], 10, 5, {}),
    "burgers_tf_transformer": ("burgers_tf", "transformer", ["grid=64", "latent_grid=32"], 10, 5, {}),
    "burgers_tf_selfpit": ("burgers_tf", "selfpit", ["grid=64", "latent_grid=64"], 10, 5, {}),
    "darcy_tf_lite": ("darcy_tf", "lite", ["latent_grid=4,4"], 8, 4, {"downsampling": 40}),
}


def _cfgs(name, overrides, variant):
    j_cfg = j_configs.apply_overrides(j_configs.get(name), NARROW + overrides)
    t_cfg = t_configs.apply_overrides(t_configs.get(name), NARROW + overrides)
    return (dataclasses.replace(j_cfg, model_variant=variant),
            dataclasses.replace(t_cfg, model_variant=variant))


@pytest.fixture(scope="module")
def fixed_problems():
    """name -> (JAX problem, port problem, JAX params) at the small sizes."""
    out = {}
    for key, (name, variant, overrides, ntrain, ntest, kw) in FIXED.items():
        j_cfg, t_cfg = _cfgs(name, overrides, variant)
        jp = j_bench.setup(j_cfg, None, ntrain=ntrain, ntest=ntest, **kw)
        tp = t_bench.setup(t_cfg, None, ntrain=ntrain, ntest=ntest, device="cpu", **kw)
        params = jp.init_fn(jax.random.PRNGKey(0), jp.train_data)["params"]
        out[key] = (jp, tp, params)
    return out


def _carried(jg) -> t_tf.TFGeometry:
    g = t_tf.TFGeometry(*(None if a is None else t(a) for a in jg))
    return g._replace(m_cross_t=g.m_cross.T.contiguous())


@pytest.mark.parametrize("name", list(FIXED))
def test_pittf_variant_forward_matches_jax(fixed_problems, name):
    """PiTTF of each variant with carried weights on JAX's geometry against
    the JAX model through each Task's forward; the attention kinds and the
    NonNeg constraint the variant sets."""
    jp, tp, params = fixed_problems[name]
    tp.model.load_state_dict(flax_tf_params_to_state_dict(params))
    jb = {"x": jp.train_data["x"][:4]}
    with torch.inference_mode():
        got = tp.task.forward(_carried(jp.geom), {"x": t(jb["x"])}).numpy()
    want = np.asarray(jp.task.forward(params, jp.geom, jb))
    np.testing.assert_allclose(got, want, rtol=MODEL_RTOL, atol=MODEL_ATOL)
    variant = FIXED[name][1]
    kinds = {"lite": ("MultiHeadSelfAtt", "MultiHeadPosAtt"),
             "transformer": ("MultiHeadSelfAtt", "MultiHeadSelfAtt"),
             "selfpit": ("SelfMultiHeadPosAtt", "SelfMultiHeadPosAtt")}[variant]
    assert (type(tp.model.MHPA_0).__name__, type(tp.model.down).__name__) == kinds
    assert (tp.task.param_constraint is t_bench.nonneg_bandwidths) == (variant == "selfpit")


def _keras_steps_match(jp, tp, params, perm, geom, constraint):
    """Two keras-Adam steps with JAX's value_and_grad (and the parameter
    constraint) against the port's train epoch on the same batches."""
    lr, total = 1e-2, 10
    optimizer = j_loop.make_optimizer(lr, total, flavor="keras")
    opt_state = optimizer.init(params)
    jlosses = []
    for idx in perm:
        batch = {k: v[idx] for k, v in jp.train_data.items()}
        loss, grads = jax.value_and_grad(jp.task.loss_fn)(params, jp.geom, batch)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        if constraint:
            params = jp.task.param_constraint(params)
        jlosses.append(float(loss))
    state = t_loop.TrainState(tp.model, t_loop.make_optimizer(tp.model.parameters(), lr, "keras"))
    train_epoch = t_loop.make_train_epoch(tp.task, t_loop.make_lr_schedule(lr, total))
    data = {k: t(v) for k, v in tp.train_data.items()}
    state, losses = train_epoch(state, geom, data, t(perm))
    np.testing.assert_allclose(losses.numpy(), jlosses, rtol=LOSS_RTOL)
    want = flax_tf_params_to_state_dict(params)
    for k, v in tp.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=k)
    return want


@pytest.mark.parametrize("name", list(FIXED))
def test_pittf_variant_keras_adam_steps_match_jax(fixed_problems, name):
    """Two keras-Adam steps of each variant (the train epoch runner.train
    runs) against JAX's loss, gradients and keras Adam; selfpit projects
    every band_width onto r >= 0 after each update on both sides, and some
    start negative."""
    jp, tp, params = fixed_problems[name]
    tp.model.load_state_dict(flax_tf_params_to_state_dict(params))
    selfpit = FIXED[name][1] == "selfpit"
    if selfpit:
        assert min(float(np.min(v["band_width"])) for v in params.values()
                   if "band_width" in v) < 0
    n = FIXED[name][3] - FIXED[name][3] % 4
    perm = np.arange(n)[: 8].reshape(2, 4)
    perm[1] = perm[1][::-1]
    want = _keras_steps_match(jp, tp, params, perm, _carried(jp.geom), selfpit)
    if selfpit:
        for k, v in tp.model.state_dict().items():
            if k.endswith("band_width"):
                assert (v >= 0).all() and (want[k] >= 0).all(), k


# the point-cloud family: elasticity_tf at hid 16 (8 heads of 2), one block
CLOUD_VARIANTS = ["lite", "transformer"]


@pytest.fixture(scope="module")
def cloud_problems():
    out = {}
    for variant in CLOUD_VARIANTS:
        j_cfg, t_cfg = _cfgs("elasticity_tf", [], variant)
        jp = j_bench.setup_elasticity_tf(j_cfg, ntrain=8, ntest=4, n_points=600)
        tp = t_bench.setup(t_cfg, ntrain=8, ntest=4, n_points=600, device="cpu")
        params = jp.model.init(jax.random.PRNGKey(0), jnp.asarray(jp.train_data["x"][:1]))["params"]
        out[variant] = (jp, tp, params)
    return out


@pytest.mark.parametrize("variant", CLOUD_VARIANTS)
def test_pointcloud_variant_forward_matches_jax(cloud_problems, variant, monkeypatch):
    """PiTTFPointCloud of each variant with carried weights against the JAX
    model, with the setup's thresholds (training) and without (serving);
    ``transformer`` builds no distances and reads no thresholds."""
    jp, tp, params = cloud_problems[variant]
    tp.model.load_state_dict(flax_tf_params_to_state_dict(params))
    x = jp.train_data["x"][:2]
    thr = (jp.train_data["thr_en"][:2], jp.train_data["thr_de"][:2])
    for with_thr in (True, False):
        jthr = [jnp.asarray(a) for a in thr] if with_thr else [None, None]
        want = np.asarray(jp.model.apply({"params": params}, jnp.asarray(x), *jthr))
        if variant == "transformer":
            monkeypatch.setattr(t_tf, "pairwise_dist_half", None)  # a call would raise
        with torch.inference_mode():
            got = tp.model(t(x), *[None if a is None else t(np.asarray(a)) for a in jthr]).numpy()
        np.testing.assert_allclose(got, want, rtol=MODEL_RTOL, atol=MODEL_ATOL)
    kinds = {type(getattr(tp.model, n)).__name__ for n in ("down", "PA_0", "up")}
    assert kinds == ({"MultiHeadPosAttBatched", "MultiHeadSelfAtt"} if variant == "lite"
                     else {"MultiHeadSelfAtt"})


@pytest.mark.parametrize("variant", CLOUD_VARIANTS)
def test_pointcloud_variant_keras_adam_steps_match_jax(cloud_problems, variant):
    """Two keras-Adam steps of each point-cloud variant with the setup's
    thresholds against JAX's."""
    jp, tp, params = cloud_problems[variant]
    tp.model.load_state_dict(flax_tf_params_to_state_dict(params))
    perm = np.array([[0, 1, 2, 3], [7, 6, 5, 4]])
    _keras_steps_match(jp, tp, params, perm, None, False)


# standalone baselines on a 32-point periodic grid (latent 16; SelfPiT's
# latent is the query grid): class name -> (JAX class, port class, latent)
BASELINES = {
    "LiteTransformer": (j_base.LiteTransformer, t_base.LiteTransformer, 16),
    "Transformer": (j_base.Transformer, t_base.Transformer, 16),
    "SelfPiT": (j_base.SelfPiT, t_base.SelfPiT, 32),
}


@pytest.mark.parametrize("name", list(BASELINES))
def test_baselines_match_jax(name):
    """Each baseline class with carried weights against the JAX class: the
    same parameter tree (names and shapes) and outputs."""
    jcls, tcls, Lt = BASELINES[name]
    L, hid, H = 32, 16, 2
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, L, 1)).astype(np.float32)
    mesh = np.linspace(0, 1, L + 1, dtype=np.float32)[:-1].reshape(-1, 1)
    jd = lambda a, b: j_tf.pairwise_dist_periodic_1d(a, b)
    jgeom = j_tf.TFGeometry(jd(L, L), jd(L, Lt), jd(Lt, Lt))
    kw = {} if name == "Transformer" else {"locality_encoder": 10.0, "locality_decoder": 20.0}
    jm = jcls(out_dim=1, hid_dim=hid, n_head=H, n_blocks=2, **kw)
    jargs = (jnp.asarray(mesh), jnp.asarray(x)) if name == "Transformer" else (
        jgeom, jnp.asarray(mesh), jnp.asarray(x))
    params = jm.init(jax.random.PRNGKey(2), *jargs)["params"]
    want = np.asarray(jm.apply({"params": params}, *jargs))
    model = tcls(2, 1, hid, H, n_blocks=2, **kw)
    sd = flax_tf_params_to_state_dict(params)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    model.load_state_dict(sd)
    targs = (t(mesh), t(x)) if name == "Transformer" else (_carried(jgeom), t(mesh), t(x))
    with torch.inference_mode():
        got = model(*targs).numpy()
    np.testing.assert_allclose(got, want, rtol=MODEL_RTOL, atol=MODEL_ATOL)


# ------------------------------------------------------------- the runner

@pytest.mark.parametrize("variant", ["lite", "transformer", "selfpit"])
def test_runner_trains_each_variant(variant, tmp_path):
    """runner.train(model_variant=) on burgers_tf at CPU sizes: finite
    losses, a checkpoint the variant's Predictor loads (and the pit model
    refuses), and selfpit's band widths projected onto r >= 0."""
    from position_induced_transformer_torch.train.evaluate import Predictor

    overrides = ["grid=64", "latent_grid=64" if variant == "selfpit" else "latent_grid=32"]
    cfg = t_configs.apply_overrides(t_configs.BURGERS_TF, NARROW + overrides)
    ck = str(tmp_path / "v.pt")
    problem, state, hist = t_runner.train(cfg, epochs=1, ntrain=10, ntest=5, verbose=False,
                                          device="cpu", model_variant=variant, checkpoint_path=ck)
    assert problem.config.model_variant == variant and np.isfinite(hist[-1]["train_loss"])
    widths = [v for k, v in state.model.state_dict().items() if k.endswith("band_width")]
    assert (len(widths) > 0) == (variant != "transformer")
    if variant == "selfpit":
        assert all((w >= 0).all() for w in widths)
    pred = Predictor(cfg, ck, device="cpu", model_variant=variant)
    assert type(pred.problem.model.MHPA_0).__name__ != "MultiHeadPosAtt"
    with pytest.raises(RuntimeError, match="state_dict"):
        Predictor(cfg, ck, device="cpu")


@pytest.mark.parametrize("case", ["unknown", "selfpit_point_cloud", "selfpit_grid"])
def test_variant_errors_match_jax(case):
    """The three refusals of _variant_attention, with JAX's words: an
    unknown variant, selfpit on a point cloud, selfpit where the latent
    grid is not the query grid (naca_tf; burgers_tf admits it)."""
    name, variant, cloud = {"unknown": ("sod_tf", "nope", False),
                            "selfpit_point_cloud": ("elasticity_tf", "selfpit", True),
                            "selfpit_grid": ("naca_tf", "selfpit", False)}[case]
    j_cfg = dataclasses.replace(j_configs.get(name), model_variant=variant)
    t_cfg = dataclasses.replace(t_configs.get(name), model_variant=variant)
    with pytest.raises(ValueError) as jerr:
        j_bench._variant_attention(j_cfg, point_cloud=cloud)
    with pytest.raises(ValueError) as terr:
        t_bench._variant_attention(t_cfg, point_cloud=cloud)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="latent == query" if case == "selfpit_grid" else "."):
        t_bench._make_model(t_cfg)
    ok = dataclasses.replace(t_configs.BURGERS_TF, model_variant="selfpit")
    assert t_bench._variant_attention(ok)["coder_attention"] == "hybrid"


# name -> (benchmark, variant): the full-width trees of every new kind
TREES = {
    "burgers_tf_lite": ("burgers_tf", "lite"),
    "burgers_tf_transformer": ("burgers_tf", "transformer"),
    "burgers_tf_selfpit": ("burgers_tf", "selfpit"),
    "elasticity_tf_lite": ("elasticity_tf", "lite"),
    "elasticity_tf_transformer": ("elasticity_tf", "transformer"),
}


@pytest.mark.parametrize("name", list(TREES))
def test_converter_carries_every_new_tree(name):
    """flax_tf_params_to_state_dict on each variant's full-width params:
    the query/key/value trees of a self op, a hybrid op's band_width,
    query, key and weight, the Dense and TFMlp trees; the result loads
    into the port's model of the same variant."""
    bench, variant = TREES[name]
    j_cfg = dataclasses.replace(j_configs.get(bench), model_variant=variant)
    t_cfg = dataclasses.replace(t_configs.get(bench), model_variant=variant)
    m = j_cfg.model
    if bench == "elasticity_tf":
        jm = j_tf.PiTTFPointCloud(out_dim=m.out_dim, hid_dim=m.hid_dim, n_head=m.n_head,
                                  locality_encoder=m.en_loc, locality_decoder=m.de_loc,
                                  n_blocks=m.n_blocks, **j_bench._variant_attention(j_cfg, True))
        shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x),
                                jax.ShapeDtypeStruct((1, 12, m.in_dim), jnp.float32))["params"]
    else:
        jm = j_tf.PiTTF(out_dim=m.out_dim, hid_dim=m.hid_dim, n_head=m.n_head,
                        locality_encoder=m.en_loc, locality_decoder=m.de_loc, n_blocks=m.n_blocks,
                        **j_bench._variant_attention(j_cfg))
        L = 12
        geom = j_tf.TFGeometry(jnp.zeros((L, L)), jnp.zeros((L, L)), jnp.zeros((L, L)))
        shapes = jax.eval_shape(
            lambda x: jm.init(jax.random.PRNGKey(0), geom, jnp.zeros((L, m.space_dim)), x),
            jax.ShapeDtypeStruct((1, L, m.in_dim), jnp.float32))["params"]
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = flax_tf_params_to_state_dict(params)
    model = t_bench._make_model(t_cfg)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    H, V = m.n_head, m.hid_dim // m.n_head
    proc = "PA_0" if bench == "elasticity_tf" else "MHPA_0"
    if variant == "selfpit":
        assert {k for k in sd if k.startswith("down.")} == {
            "down.band_width", "down.query", "down.key", "down.weight"}
    else:
        assert sd[f"{proc}.query"].shape == (H, m.hid_dim, V) and f"{proc}.value" in sd
    model.load_state_dict(sd)
