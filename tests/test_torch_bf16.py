"""Mixed precision (``compute_dtype="bfloat16"``) in the port against the
JAX package, on the CPU.

The contract is the JAX package's kernel route (its ``models/pit.py``
``_dispatch_posatt``): activations in bf16, the attention kernels float32
programs that take the bf16 values cast to float32 and give their result
back rounded to bf16. So each attention op of the port, fed bf16 values,
must equal JAX's float32 op on the same (bf16-representable) values,
rounded to bf16, within one bf16 ulp elementwise (the two float32 results
differ by float32 rounding, which may put them on either side of a bf16
rounding boundary). The ops' trailing GELU is taken out on both sides for
that comparison, so that the ulp bound holds the attention itself.

The JAX package runs its XLA path on the CPU, which rounds the attention
weights to bf16 and contracts in bf16; the port takes the kernel route on
every device. So whole models are held to JAX's bf16 forward on the kernel
route (the ``jax_kernel_route`` fixture: JAX's own float32 ops stand for its
kernels, as their plain versions), run eagerly, so that each bf16 op
rounds, as the port's do (under ``jit`` XLA's fusions keep more
precision). The port must lie within the tolerances below of it, measured
here, and at least CLOSER times as close to it as to JAX's float32 forward:
a port that computed in float32 would lie closer to the latter. It is also
held, more loosely, to JAX's bf16 forward on the XLA route. Distances are
relative L2 norms of the outputs.
"""

import contextlib
import dataclasses
import json

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from position_induced_transformer_torch import cli as t_cli
from position_induced_transformer_torch import configs as t_configs
from position_induced_transformer_torch.models import PiT as TPiT
from position_induced_transformer_torch.models import pit as t_pit
from position_induced_transformer_torch.models import pit_tf as t_tf
from position_induced_transformer_torch.models.geometry import Geometry as TGeometry
from position_induced_transformer_torch.ops import normalization as t_norm
from position_induced_transformer_torch.ops import posatt as t_posatt
from position_induced_transformer_torch.train import checkpoint as t_ckpt
from position_induced_transformer_torch.train import evaluate as t_eval
from position_induced_transformer_torch.train import loop as t_loop
from position_induced_transformer_torch.train import runner as t_runner
from position_induced_transformer_torch.utils.torch_compat import (
    flax_params_to_state_dict,
    flax_tf_params_to_state_dict,
)
from position_induced_transformer_tpu.data import meshes as j_meshes
from position_induced_transformer_tpu.models import PiT as JPiT
from position_induced_transformer_tpu.models import build_geometry as j_build
from position_induced_transformer_tpu.models import pit as j_pit
from position_induced_transformer_tpu.models import pit_tf as j_tf
from position_induced_transformer_tpu.ops import locality as j_loc
from position_induced_transformer_tpu.ops import normalization as j_norm
from position_induced_transformer_tpu.ops import posatt as j_posatt
from position_induced_transformer_tpu.train import loop as j_loop

torch.set_num_threads(2)

BF16 = torch.bfloat16
t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))

# Whole models: the port's bf16 forward against JAX's bf16 forward on the
# kernel route (the ``jax_kernel_route`` fixture), as a relative L2 distance.
# Measured on these inputs: 0 (equal to the bit) for Burgers, cylinder,
# burgers_tf's PiT and selfpit and the point cloud, 5.3e-4 for vorticity
# (instance norm), 1.3e-3 for burgers_tf's transformer; their distances
# from JAX's float32 forward are 2.2e-3 to 2.1e-2, at least 8.9 times as far
MODEL_BF16_REL = 5e-3
CLOSER = 2.0
# against JAX's bf16 forward on its XLA route, which rounds the attention
# weights to bf16 and contracts in bf16 (measured: 2.8e-3 to 2.7e-2)
XLA_BF16_REL = 5e-2
# three Adam steps: the bf16 losses against JAX's bf16 losses on the kernel
# route (measured: 7.9e-6 relative), at the float32 training tests' bound
LOSS_BF16_RTOL = 2e-4


def bf16_values(rng, shape, scale=1.0):
    """Random values that bf16 represents exactly: (float32 numpy, bf16
    tensor)."""
    v = torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(BF16)
    return v.float().numpy(), v


def assert_within_one_bf16_ulp(got, want32):
    """``got`` (a bf16 tensor) against ``want32`` rounded to bf16: no
    element more than one bf16 ulp (the spacing at the larger of the two)
    apart."""
    assert got.dtype == BF16
    want = torch.from_numpy(np.array(want32, np.float32)).to(BF16).double()
    got = got.double()
    assert got.shape == want.shape
    big = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    diff = (got - want).abs()
    assert (diff <= ulp).all(), float((diff / ulp).max())


@pytest.fixture
def no_gelu(monkeypatch):
    """Both packages' GELU as the identity: the TF ops end in one, and
    the ulp bound is on the attention before it."""
    ident = lambda x, approximate=False: x
    monkeypatch.setattr(flax.linen, "gelu", ident)
    monkeypatch.setattr(t_tf, "gelu", lambda x: x)


def _selector(n_head, v_dim, parts=1):
    """(H, parts * H * V, V) weights whose projection of an input
    [part 0 | part 1 | ...] of (H, V) blocks picks head h of part p exactly:
    one selector for each part."""
    width = parts * n_head * v_dim
    sel = np.zeros((parts, n_head, width, v_dim), np.float32)
    for p in range(parts):
        for h in range(n_head):
            sel[p, h, (p * n_head + h) * v_dim + np.arange(v_dim), np.arange(v_dim)] = 1.0
    return sel


# ---------------------------------------------------------------- per op

def _pit_op_case(kind, seed=0, B=3, Lo=24, Li=40, H=3, D=5):
    rng = np.random.default_rng(seed)
    lmda = rng.uniform(-1, 1, (H, 1, 1)).astype(np.float32)
    u32, u16 = bf16_values(rng, (B, Li, D))
    mq = mk = dist = None
    if kind == "batched":
        mq = rng.random((B, Lo, 2)).astype(np.float32)
        mk = rng.random((B, Li, 2)).astype(np.float32)
    elif kind == "dense":
        dist = rng.random((B, Lo, Li)).astype(np.float32)
    else:
        dist = rng.random((Lo, Li)).astype(np.float32)
    return dist, lmda, u32, u16, mq, mk


@pytest.mark.parametrize("locality", [0.3, 1.0], ids=["local", "global"])
@pytest.mark.parametrize("kind", ["fixed", "batched", "dense"])
def test_pit_attention_ops_round_trip_through_f32(kind, locality):
    """PiT's position attention on fixed (#1), lazy batched (#7) and dense
    batched (#9) geometry: the port's op on bf16 values equals JAX's float32
    op on the same values, rounded to bf16, within one ulp; the op gives
    bf16 back."""
    dist, lmda, u32, u16, mq, mk = _pit_op_case(kind)
    thr = None
    if kind == "fixed" and locality < 1.0:
        thr = np.asarray(j_loc.quantile_threshold(jnp.asarray(dist), locality))
    jarg = lambda a: None if a is None else jnp.asarray(a)
    want = j_pit._dispatch_posatt(jarg(dist), jnp.asarray(lmda), jnp.asarray(u32), locality,
                                  jarg(thr), False, jarg(mq), jarg(mk))
    assert want.dtype == jnp.float32
    op = t_pit.PosAttCross(lmda.shape[0], locality)
    op.lmda.data = t(lmda)
    targ = lambda a: None if a is None else t(a)
    with torch.no_grad():
        got = op(targ(dist), u16, targ(thr), mesh_q=targ(mq), mesh_k=targ(mk))
    assert_within_one_bf16_ulp(got, want)


def test_plain_position_attention_takes_bf16_values():
    """ops.posatt's plain op, the oracle the card's kernels are held to,
    takes bf16 values through the same round trip as the models' ops."""
    dist, lmda, u32, u16, _, _ = _pit_op_case("fixed", seed=1)
    want = j_posatt.position_attention(jnp.asarray(dist), jnp.asarray(lmda), jnp.asarray(u32), 0.4)
    got = t_posatt.position_attention(t(dist), t(lmda), u16, 0.4)
    assert_within_one_bf16_ulp(got, want)
    got32 = t_posatt.position_attention(t(dist), t(lmda), torch.from_numpy(u32), 0.4)
    assert torch.equal(got, got32.to(BF16))


TF_OPS = {  # kind, locality, bandwidth or None
    "tf_fixed_local": ("tf_fixed", 20.0, "tan_sin"),
    "tf_fixed_global_tan": ("tf_fixed", 200.0, "tan"),
    "tf_batched_local": ("tf_batched", 20.0, None),
    "tf_batched_global": ("tf_batched", 200.0, None),
    "dot": ("dot", None, None),
    "hybrid_local": ("hybrid", 30.0, None),
    "hybrid_global": ("hybrid", 200.0, None),
}


def _tf_op(name, seed=0, B=2, L=32, Lk=40, H=2, V=4):
    """JAX's float32 op and the port's op, one module each with the same
    parameters, and their inputs: the values (or [Q | K | V]) themselves,
    picked by selector weights, so that both see the same bf16 values."""
    kind, loc, bandwidth = TF_OPS[name]
    rng = np.random.default_rng(seed)
    parts = 3 if kind in ("dot", "hybrid") else 1
    Li = Lk if kind == "tf_fixed" else L
    x32, x16 = bf16_values(rng, (B, Li, parts * H * V))
    sel = _selector(H, V, parts)
    r = rng.uniform(-0.6, 0.6, (H, 1, 1)).astype(np.float32)
    jx = jnp.asarray(x32)
    if kind == "tf_fixed":
        dist = rng.random((L, Lk)).astype(np.float32)
        jd = jnp.asarray(dist)
        thr = None
        if loc <= 100:
            geom = j_tf.tf_precompute_thresholds(j_tf.TFGeometry(jd, jd), loc, loc)
            thr = geom.thr_up
        jm = j_tf.MultiHeadPosAtt(H, H * V, loc, bandwidth)
        want = jm.apply({"params": {"band_width": jnp.asarray(r), "weight": jnp.asarray(sel[0])}},
                        jd, jx, thr)
        tm = t_tf.MultiHeadPosAtt(H * V, H, H * V, loc, bandwidth)
        tm.band_width.data, tm.weight.data = t(r), t(sel[0])
        run = lambda: tm(t(dist), x16, None if thr is None else t(thr))
    elif kind == "tf_batched":
        coords = rng.random((B, L, 2)).astype(np.float32)
        jc = jnp.asarray(coords)
        diff = jc[:, :, None, :] - jc[:, None, :, :]
        thr = None if loc > 100 else j_loc.quantile_threshold(
            0.5 * jnp.sum(diff * diff, axis=-1), loc / 100.0)
        rb = r.reshape(1, H, 1, 1)
        jm = j_tf.MultiHeadPosAttBatched(H, H * V, loc)
        want = jm.apply({"params": {"band_width": jnp.asarray(rb), "weight": jnp.asarray(sel[0])}},
                        None, jx, thr, coords=jc)
        tm = t_tf.MultiHeadPosAttBatched(H * V, H, H * V, loc)
        tm.band_width.data, tm.weight.data = t(rb), t(sel[0])
        run = lambda: tm(None, x16, None if thr is None else t(thr), coords=t(coords))
    elif kind == "dot":
        jm = j_tf.MultiHeadSelfAtt(H, H * V)
        p = {"query": sel[0], "key": sel[1], "value": sel[2]}
        want = jm.apply({"params": {k: jnp.asarray(v) for k, v in p.items()}}, jx)
        tm = t_tf.MultiHeadSelfAtt(3 * H * V, H, H * V)
        for k, v in p.items():
            getattr(tm, k).data = t(v)
        run = lambda: tm(x16)
    else:
        dist = rng.random((L, L)).astype(np.float32)
        jm = j_tf.SelfMultiHeadPosAtt(H, H * V, loc)
        p = {"band_width": r, "query": sel[0], "key": sel[1], "weight": sel[2]}
        want = jm.apply({"params": {k: jnp.asarray(v) for k, v in p.items()}}, jnp.asarray(dist), jx)
        tm = t_tf.SelfMultiHeadPosAtt(3 * H * V, H, H * V, loc)
        for k, v in p.items():
            getattr(tm, k).data = t(v)
        run = lambda: tm(t(dist), x16)
    return np.asarray(want), run


@pytest.mark.parametrize("name", list(TF_OPS))
def test_tf_attention_ops_round_trip_through_f32(name, no_gelu):
    """The TF family's attention ops: fixed-mesh (#13), point-cloud (#11),
    dot-product (#14) and hybrid (#14). The port's op on bf16 inputs (its
    projections exact through selector weights) equals JAX's float32 op on
    the same values, rounded to bf16, within one ulp."""
    want, run = _tf_op(name)
    with torch.no_grad():
        got = run()
    assert_within_one_bf16_ulp(got, want)


def test_tf_ops_hand_the_kernels_float32(monkeypatch):
    """Each TF op casts its bf16 projections to float32 before the kernel
    wrapper, and the wrappers see no other dtype."""
    seen = []

    def spy(fn):
        def wrapped(*args, **kw):
            seen.extend(a.dtype for a in list(args) + list(kw.values()) if torch.is_tensor(a))
            return fn(*args, **kw)
        return wrapped

    for name in ("position_attention_tf_fixed", "position_attention_batched_tf_coords",
                 "dot_attention"):
        monkeypatch.setattr(t_tf, name, spy(getattr(t_tf, name)))
    for name in ("tf_fixed_local", "tf_batched_local", "dot", "hybrid_local"):
        with torch.no_grad():
            assert _tf_op(name)[1]().dtype == BF16
    assert seen and set(seen) == {torch.float32}


def test_instance_norm_keeps_float32_statistics():
    """bf16 in, bf16 out, the statistics in float32: equal to JAX's
    instance_norm of the same bf16 array within one ulp; statistics taken
    in bf16 would be off by far more on this offset field."""
    rng = np.random.default_rng(3)
    x32, x16 = bf16_values(rng, (2, 500, 6))
    x16 = (x16 + 40).to(BF16)
    want = np.asarray(j_norm.instance_norm(jnp.asarray(x16.float().numpy()).astype(jnp.bfloat16))
                      .astype(jnp.float32))
    got = t_norm.instance_norm(x16)
    assert_within_one_bf16_ulp(got, want)
    naive = (x16 - x16.mean(1, keepdim=True)) * torch.rsqrt(x16.var(1, keepdim=True, unbiased=False)
                                                              + 1e-5)
    assert (naive.double() - got.double()).abs().max() > 10 * (got.double() - t(want)).abs().max()


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_gelu_and_linear_round_as_jax(dtype):
    """The models' GELU and Linear below float32 equal JAX's to the bit:
    ``jax.nn.gelu`` in the dtype, op by op, and ``x @ W + b`` with the
    float32 parameters cast at use (the product rounded, then the sum)."""
    rng = np.random.default_rng(8)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    x = torch.from_numpy(rng.standard_normal((64, 24)).astype(np.float32) * 3).to(tdt)
    jx = jnp.asarray(x.float().numpy()).astype(jdt)
    want = np.asarray(jax.nn.gelu(jx, approximate=False).astype(jnp.float32))
    assert np.array_equal(t_pit.gelu(x).float().numpy(), want)
    w = rng.standard_normal((24, 10)).astype(np.float32)
    b = rng.standard_normal(10).astype(np.float32)
    want = np.asarray((jx @ jnp.asarray(w).astype(jdt) + jnp.asarray(b).astype(jdt)).astype(jnp.float32))
    got = t_pit.linear_at(x, torch.from_numpy(w.T.copy()), torch.from_numpy(b))
    assert got.dtype == tdt and np.array_equal(got.float().numpy(), want)


def test_float64_models_stay_float64(monkeypatch):
    """At the default compute dtype the models leave their input's dtype
    alone: a model converted to float64, with its attention on the plain
    version (as the card checks' float64 references run it), computes and
    answers in float64; only a lower compute dtype casts."""
    from position_induced_transformer_torch.kernels import posatt_tf_fixed as kf

    monkeypatch.setattr(t_tf, "position_attention_tf_fixed",
                        lambda d, thr, s, v, kind, loc: kf.posatt_tf_fixed_reference(
                            d, None if loc > 100 else thr, s, v, kf.KINDS[kind]))
    model = t_tf.PiTTF(2, 1, 16, 2, 8.0, 8.0, n_blocks=2,
                       generator=torch.Generator().manual_seed(0)).double()
    d = t_tf.pairwise_dist_periodic_1d(32, 32)
    geom = t_tf.tf_precompute_thresholds(t_tf.TFGeometry(d, d, d), 8.0, 8.0)
    geom = t_tf.TFGeometry(*(None if a is None else a.double() for a in geom))
    seen = _hidden_dtypes(model, ["en_layer", "MLP_1.mlp2"])
    with torch.no_grad():
        out = model(geom, torch.linspace(0, 1, 33)[:-1, None].double(), torch.rand(2, 32, 1).double())
    assert out.dtype == torch.float64 and set(seen.values()) == {torch.float64}


# ------------------------------------------------------------- per model

def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _hidden_dtypes(module, names):
    """Forward hooks recording the output dtype of each named submodule."""
    seen = {}
    for name in names:
        module.get_submodule(name).register_forward_hook(
            lambda m, i, o, name=name: seen.__setitem__(name, o.dtype))
    return seen


@pytest.fixture
def jax_kernel_route(monkeypatch):
    """JAX's bf16 models on the kernel route, on the CPU. PiT: the XLA
    fallback of ``_dispatch_posatt`` replaced by its kernel route (the
    values cast to float32, the float32 op, the result cast back), with
    ``position_attention`` standing for the Pallas kernels it is the plain
    version of. The TF family: each attention module's projections in the
    activations' dtype, then JAX's own float32 module on their float32
    values (selector weights pick them exactly, as in the per-op tests),
    the result rounded back before the module's GELU. Gives a context
    manager that puts both on the route."""
    f32_op = j_posatt.position_attention
    inside = []

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        kinds = (j_tf.MultiHeadPosAtt, j_tf.MultiHeadPosAttBatched, j_tf.MultiHeadSelfAtt,
                 j_tf.SelfMultiHeadPosAtt)
        if inside or context.method_name != "__call__" or not isinstance(mod, kinds):
            return next_fun(*args, **kwargs)
        p = mod.variables["params"]
        self_op = isinstance(mod, j_tf.MultiHeadSelfAtt)
        x = args[0] if self_op else args[1]
        names = {j_tf.MultiHeadSelfAtt: ("query", "key", "value"),
                 j_tf.SelfMultiHeadPosAtt: ("query", "key", "weight")}.get(type(mod), ("weight",))
        H, V = mod.n_head, mod.hid_dim // mod.n_head
        proj = [jnp.einsum("bnj,hjk->bnhk", x, p[k].astype(x.dtype)).reshape(*x.shape[:2], H * V)
                for k in names]
        sel = _selector(H, V, len(names))
        sub_params = {**{k: v for k, v in p.items() if k not in names},
                      **{k: jnp.asarray(sel[i]) for i, k in enumerate(names)}}
        sub_x = jnp.concatenate(proj, -1).astype(jnp.float32)
        sub_args = (sub_x,) if self_op else (args[0], sub_x) + tuple(args[2:])
        inside.append(mod)
        try:
            with monkeypatch.context() as m:
                m.setattr(flax.linen, "gelu", lambda v, approximate=False: v)
                out = mod.clone(parent=None).apply({"params": sub_params}, *sub_args, **kwargs)
        finally:
            inside.pop()
        return jax.nn.gelu(out.astype(x.dtype), approximate=False)

    @contextlib.contextmanager
    def route():
        with monkeypatch.context() as m, flax.linen.intercept_methods(interceptor):
            m.setattr(j_pit, "position_attention", lambda dist, lmda, inputs, locality, thr=None:
                      f32_op(dist, lmda, inputs.astype(jnp.float32), locality, thr=thr)
                      .astype(inputs.dtype))
            yield

    return route


def assert_closer_to_jax_bf16(got, want16, want32, xla16):
    """The port's bf16 output against JAX's bf16 output on the kernel route
    (within MODEL_BF16_REL, and CLOSER times as close as to JAX's float32
    output) and on JAX's XLA route (within XLA_BF16_REL)."""
    d16, d32, dx = rel(got, want16), rel(got, want32), rel(got, xla16)
    assert d16 <= MODEL_BF16_REL and d32 >= CLOSER * d16, (d16, d32)
    assert dx <= XLA_BF16_REL, dx


PIT_CASES = {  # config, metric, mesh builder, model overrides
    "burgers": (t_configs.BURGERS, "periodic1d", lambda: (j_meshes.grid_1d(64), j_meshes.grid_1d(16)),
                {}),
    "vorticity_instance_norm": (t_configs.VORTICITY, "periodic2d",
                                lambda: (j_meshes.grid_2d(12, False).reshape(-1, 2),
                                        j_meshes.grid_2d(6, False).reshape(-1, 2)), {}),
    "cylinder_residual": (t_configs.CYLINDER, "euclidean",
                          lambda: (np.random.default_rng(5).random((80, 2)).astype(np.float32),
                                   np.random.default_rng(6).random((24, 2)).astype(np.float32)),
                          {"en_loc": 0.1, "de_loc": 0.1}),
}


def _pit_pair(name, seed=0):
    cfg, metric, meshes, over = PIT_CASES[name]
    m = dataclasses.replace(cfg.model, hid_dim=16, n_blocks=2, **over)
    fields = dict(space_dim=m.space_dim, in_dim=m.in_dim, out_dim=m.out_dim, hid_dim=m.hid_dim,
                  n_head=m.n_head, n_blocks=m.n_blocks, en_loc=m.en_loc, de_loc=m.de_loc,
                  concat_mesh=m.concat_mesh, use_instance_norm=m.use_instance_norm,
                  residual_output=m.residual_output)
    mesh, ltt = (np.asarray(a, np.float32) for a in meshes())
    jg = j_build(jnp.asarray(mesh), jnp.asarray(ltt), jnp.asarray(mesh), metric=metric,
                 en_loc=m.en_loc, de_loc=m.de_loc)
    tg = TGeometry(**{f.name: None if getattr(jg, f.name) is None else t(getattr(jg, f.name))
                      for f in dataclasses.fields(TGeometry) if hasattr(jg, f.name)})
    x = np.random.default_rng(seed).standard_normal((3, len(mesh), m.in_dim)).astype(np.float32)
    jmodel = JPiT(**fields)
    params = jmodel.init(jax.random.PRNGKey(seed), jg, jnp.asarray(x))["params"]
    tmodel = TPiT(**fields, compute_dtype="bfloat16")
    tmodel.load_state_dict(flax_params_to_state_dict(params))
    return jmodel, params, jg, tmodel, tg, x


def _jax_forwards(apply, kernel_route):
    """JAX's float32 forward, its bf16 forward on the XLA route, and its
    bf16 forward on the kernel route: ``apply(compute_dtype)``."""
    want32, xla16 = apply("float32"), apply("bfloat16")
    with kernel_route():
        want16 = apply("bfloat16")
    assert want16.dtype == jnp.float32
    return [np.asarray(a) for a in (want32, xla16, want16)]


@pytest.mark.parametrize("name", list(PIT_CASES))
def test_pit_bf16_forward_is_jax_bf16(name, jax_kernel_route):
    """PiT at hid 16, 2 blocks: Burgers, vorticity (instance norm) and
    cylinder (``residual_output``). The output is float32, the MLPs run in
    bf16 and the parameters stay float32; the forward lies within
    MODEL_BF16_REL of JAX's bf16 forward on the kernel route and at least
    CLOSER times as far from JAX's float32 one."""
    jmodel, params, jg, tmodel, tg, x = _pit_pair(name)
    want32, xla16, want16 = _jax_forwards(
        lambda c: jmodel.clone(compute_dtype=c).apply({"params": params}, jg, jnp.asarray(x)),
        jax_kernel_route)
    seen = _hidden_dtypes(tmodel, ["en_layer.mlp1", "mlp.0.mlp2", "de.mlp2"])
    with torch.no_grad():
        got = tmodel(tg, torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert seen == {k: BF16 for k in seen}
    assert all(p.dtype == torch.float32 for p in tmodel.parameters())
    assert_closer_to_jax_bf16(got.numpy(), want16, want32, xla16)


TF_MODELS = {  # variant -> (processor, coder) attention
    "pit": ("position", "position"),
    "transformer": ("self", "self"),
    "selfpit": ("hybrid", "hybrid"),
}


@pytest.mark.parametrize("variant", list(TF_MODELS))
def test_pittf_bf16_forward_is_jax_bf16(variant, jax_kernel_route):
    """burgers_tf's PiTTF at hid 16, 2 blocks on a 32-point periodic grid
    (latent = query, as selfpit needs), and its transformer and selfpit
    variants: float32 output, bf16 inside, closer to JAX's bf16 forward."""
    pa, ca = TF_MODELS[variant]
    m = t_configs.BURGERS_TF.model
    L = 32
    d = j_tf.pairwise_dist_periodic_1d(L, L)
    jg = j_tf.tf_precompute_thresholds(j_tf.TFGeometry(d, d, d), m.en_loc, m.de_loc)
    mesh = jnp.asarray(j_meshes.grid_1d(L), jnp.float32)
    x = np.random.default_rng(1).standard_normal((3, L, 1)).astype(np.float32)
    kw = dict(out_dim=1, hid_dim=16, n_head=2, locality_encoder=m.en_loc,
              locality_decoder=m.de_loc, n_blocks=2, processor_attention=pa, coder_attention=ca)
    jm = j_tf.PiTTF(**kw)
    params = jm.init(jax.random.PRNGKey(2), jg, mesh, jnp.asarray(x))["params"]
    want32, xla16, want16 = _jax_forwards(
        lambda c: jm.clone(compute_dtype=c).apply({"params": params}, jg, mesh, jnp.asarray(x)),
        jax_kernel_route)
    tm = t_tf.PiTTF(in_dim=2, compute_dtype="bfloat16", **kw)
    tm.load_state_dict(flax_tf_params_to_state_dict(params))
    tg = t_tf.TFGeometry(*(None if a is None else t(a) for a in jg))
    seen = _hidden_dtypes(tm, ["en_layer", "MLP_0.mlp1", "de_layer.mlp1"])
    with torch.no_grad():
        got = tm(tg, t(mesh), torch.from_numpy(x))
    assert got.dtype == torch.float32 and seen == {k: BF16 for k in seen}
    assert_closer_to_jax_bf16(got.numpy(), want16, want32, xla16)


def test_point_cloud_bf16_forward_is_jax_bf16(jax_kernel_route):
    """elasticity_tf's PiTTFPointCloud at hid 16, 2 heads, 2 blocks on
    40-point clouds, setup-style thresholds on the float32 halved
    distances: float32 output, bf16 inside, closer to JAX's bf16 forward."""
    m = t_configs.ELASTICITY_TF.model
    rng = np.random.default_rng(4)
    x = rng.random((2, 40, 6)).astype(np.float32)
    c = jnp.asarray(x[..., :2])
    diff = c[:, :, None, :] - c[:, None, :, :]
    thr = j_loc.quantile_threshold(0.5 * jnp.sum(diff * diff, axis=-1), m.en_loc / 100.0)
    kw = dict(out_dim=1, hid_dim=16, n_head=2, locality_encoder=m.en_loc,
              locality_decoder=m.de_loc, n_blocks=2)
    jm = j_tf.PiTTFPointCloud(**kw)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(x), thr, thr)["params"]
    want32, xla16, want16 = _jax_forwards(
        lambda c: jm.clone(compute_dtype=c).apply({"params": params}, jnp.asarray(x), thr, thr),
        jax_kernel_route)
    tm = t_tf.PiTTFPointCloud(in_dim=6, compute_dtype="bfloat16", **kw)
    tm.load_state_dict(flax_tf_params_to_state_dict(params))
    seen = _hidden_dtypes(tm, ["en_layer", "MLP_1.mlp2", "de_layer.mlp2"])
    with torch.no_grad():
        got = tm(torch.from_numpy(x), t(thr), t(thr))
    assert got.dtype == torch.float32 and seen == {k: BF16 for k in seen}
    assert_closer_to_jax_bf16(got.numpy(), want16, want32, xla16)


# ------------------------------------------------ training and evaluation

def test_bf16_training_steps_hold_jax_bf16_losses(jax_kernel_route):
    """Three Adam steps of a bf16 Burgers PiT (hid 16, 2 blocks, 64 -> 16,
    batch 4) from the same weights and batches: the losses hold JAX's bf16
    losses (its kernel route, eager) at LOSS_BF16_RTOL, and every
    parameter and Adam moment stays float32."""
    jmodel, params, jg, tmodel, tg, _ = _pit_pair("burgers")
    jmodel = jmodel.clone(compute_dtype="bfloat16")
    rng = np.random.default_rng(7)
    xs = rng.random((3, 4, 64, 1)).astype(np.float32)
    ys = rng.random((3, 4, 64, 1)).astype(np.float32)
    optimizer = j_loop.make_optimizer(1e-3, 10)
    task = j_loop.Task(model=jmodel, loss_p=1, out_dim=1)
    opt_state, jlosses = optimizer.init(params), []
    for x, y in zip(xs, ys):
        with jax_kernel_route():
            loss, grads = jax.value_and_grad(task.loss_fn)(params, jg, {"x": jnp.asarray(x),
                                                                         "y": jnp.asarray(y)})
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        jlosses.append(float(loss))
    ttask = t_loop.Task(model=tmodel, loss_p=1, out_dim=1)
    state = t_loop.TrainState(tmodel, t_loop.make_optimizer(tmodel.parameters(), 1e-3))
    train_epoch = t_loop.make_train_epoch(ttask, t_loop.make_lr_schedule(1e-3, 10))
    data = {"x": torch.from_numpy(xs.reshape(12, 64, 1)), "y": torch.from_numpy(ys.reshape(12, 64, 1))}
    state, tlosses = train_epoch(state, tg, data, torch.arange(12).reshape(3, 4))
    np.testing.assert_allclose(tlosses.numpy(), jlosses, rtol=LOSS_BF16_RTOL)
    assert all(p.dtype == torch.float32 for p in tmodel.parameters())
    assert all(v.dtype == torch.float32 for s in state.optimizer.state.values()
               for v in s.values() if torch.is_tensor(v) and v.is_floating_point())


def _tiny(cfg, **kw):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, hid_dim=16, n_blocks=2), **kw)


def test_f32_checkpoint_evaluates_and_serves_at_bf16(tmp_path):
    """A checkpoint trained at float32 evaluates under
    ``model.compute_dtype=bfloat16`` with its float32 rel_l2 within rtol
    2e-2 (the JAX package's bound), and a bf16 Predictor and ``infer``
    answer from it in float32, close to the float32 Predictor."""
    cfg = _tiny(t_configs.BURGERS, grid=(64,), latent_grid=(16,), batch_size=8)
    ckpt = str(tmp_path / "b.pt")
    t_runner.train(cfg, epochs=2, ntrain=16, ntest=8, verbose=False, device="cpu",
                   checkpoint_path=ckpt)
    cfg16 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype="bfloat16"))
    r32 = t_eval.evaluate(cfg, ckpt, ntest=8, device="cpu")
    r16 = t_eval.evaluate(cfg16, ckpt, ntest=8, device="cpu")
    np.testing.assert_allclose(r16["rel_l2"], r32["rel_l2"], rtol=2e-2)
    p32 = t_eval.Predictor(cfg, ckpt, device="cpu")
    p16 = t_eval.Predictor(cfg16, ckpt, device="cpu")
    assert p16.problem.model.compute_dtype == BF16
    x = p32.problem.test_data["x"][:4]
    y32, y16 = p32.predict_array({"x": x}), p16.predict_array({"x": x})
    assert y16.dtype == np.float32 and rel(y16, y32) < 2e-2
    inp = tmp_path / "x.npy"
    np.save(inp, x)
    out = tmp_path / "y.npy"
    t_eval.infer(cfg16, ckpt, str(inp), output_path=str(out), device="cpu")
    np.testing.assert_array_equal(np.load(out), y16)


def test_cli_trains_evaluates_and_infers_at_bf16(tmp_path, capsys, monkeypatch):
    """``train --set model.compute_dtype=bfloat16 --device cpu``: every
    Linear of the run takes bf16 activations, the logged losses are finite
    and the checkpoint's parameters are float32; ``evaluate`` and
    ``infer`` of it with the same ``--set`` run at bf16 too."""
    dtypes = set()
    linear_at = t_pit.linear_at
    monkeypatch.setattr(t_pit, "linear_at", lambda x, w, b: dtypes.add(x.dtype) or linear_at(x, w, b))
    ckpt, log = tmp_path / "c.pt", tmp_path / "log.jsonl"
    common = ["--benchmark", "burgers", "--device", "cpu", "--set", "model.compute_dtype=bfloat16",
              "--set", "model.hid_dim=16", "--set", "model.n_blocks=2", "--set", "grid=64",
              "--set", "latent_grid=16"]
    t_cli.main(["train", *common, "--epochs", "2", "--ntrain", "16", "--ntest", "8",
                "--checkpoint", str(ckpt), "--log", str(log)])
    final = json.loads(capsys.readouterr().out.splitlines()[-1])["final"]
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [0, 1] and final["epoch"] == 1
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["rel_l2"]) for r in rows)
    assert dtypes == {BF16}
    state = t_ckpt.restore(str(ckpt))["state_dict"]
    assert {v.dtype for v in state.values()} == {torch.float32}
    dtypes.clear()
    t_cli.main(["evaluate", *common, "--checkpoint", str(ckpt), "--ntest", "8"])
    assert np.isfinite(json.loads(capsys.readouterr().out.splitlines()[-1])["rel_l2"])
    inp, out = tmp_path / "x.npy", tmp_path / "y.npy"
    np.save(inp, np.random.default_rng(0).standard_normal((3, 64, 1)).astype(np.float32))
    t_cli.main(["infer", *common, "--checkpoint", str(ckpt), "--input", str(inp),
                "--output", str(out)])
    y = np.load(out)
    assert y.shape == (3, 64, 1) and y.dtype == np.float32 and np.isfinite(y).all()
    assert dtypes == {BF16}
