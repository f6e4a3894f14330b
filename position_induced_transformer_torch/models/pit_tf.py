"""TF-semantics PiT (the JAX package's ``models/pit_tf.py``) as
``nn.Module``s: the fixed-mesh model ``PiTTF`` and the point-cloud model
``PiTTFPointCloud``.

The reference's older TensorFlow implementation differs from the torch one
(reference: tensorflow/5_Elasticity/utils.py:60-188): the value projection
lives inside the attention op (``v_dim = hid / heads``, one per head) with
a trailing GELU, the bandwidth is ``r^2``, locality is a percentile in [0,
100] (above 100: global), and every stage adds an MLP of the attention to
a linear map of its input. Distances are ``|x_i - x_j|^2 / 2`` between the
first two input channels of each sample.

Every position attention op takes a hand-written kernel: with a threshold
for each local op (precomputed at setup) the coordinate kernel #11, which
computes the distances itself; otherwise the model builds the (B, L, L)
halved distances once, takes the missing thresholds from them, and every
position op reads them through kernel #9.

``PiTTF`` (burgers_tf, sod_tf, darcy_tf, vorticity_tf, naca_tf) runs over
precomputed distance matrices that every sample shares (:class:`TFGeometry`),
with a bandwidth that varies by experiment (``tan_sin``, ``square`` or
``tan``, the last of either sign before keras' NonNeg projection) and
every position attention op through kernel #13 (``kernels/posatt_tf_fixed.py``).
Its processor adds ``MLP(PA(x)) + W(x)``; the 1-D experiments add a
decoder self-attention ``up2``. Submodule names follow the JAX parameter tree
(``en_layer``, ``down``, ``mlp1``, ``w1``, ``PA_<i>``, ``MLP_<i>``,
``W_<i>``, ``up``, ``mlp2``, ``w2``, ``de_layer``; ``PiTTF``'s ``MHPA_<i>``,
``up2``, ``mlp`` and ``w``), so that
``utils.torch_compat.flax_tf_params_to_state_dict`` carries JAX weights
over.

The ablation variants swap attention kinds per role (``processor_attention``
and ``coder_attention``): ``"position"`` (PiT), ``"self"``
(:class:`MultiHeadSelfAtt`, dot-product attention) or, in ``PiTTF``,
``"hybrid"`` (:class:`SelfMultiHeadPosAtt`, dot-product logits minus the
scaled distances). Both take kernel #14 (``kernels/dotatt.py``).

``compute_dtype`` (e.g. ``"bfloat16"``) runs the activations in that dtype,
as ``models.pit.PiT``'s does: the Dense layers, the value, query and key
projections and the GELUs; the parameters stay float32 master weights,
cast at use, and distances, thresholds, the bandwidths, the softmax and the
model's output stay float32. Each attention op hands its projections to
its kernel as float32 and casts the result back (the kernels are float32
programs, on the CPU as on the card), where the JAX package's XLA path
rounds the attention weights to bf16 and contracts in bf16.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from position_induced_transformer_torch.kernels.dotatt import dot_attention
from position_induced_transformer_torch.kernels.posatt_batched import (
    position_attention_batched_dist,
    position_attention_batched_tf_coords,
)
from position_induced_transformer_torch.kernels.posatt_tf_fixed import (
    percentile_thresholds,
    position_attention_tf_fixed,
)
from position_induced_transformer_torch.models.pit import (
    at_least_f32,
    gelu,
    linear_at,
    resolve_compute_dtype,
    to_compute_dtype,
)
from position_induced_transformer_torch.ops.initializers import glorot_uniform, he_normal_tf
from position_induced_transformer_torch.ops.locality import quantile_threshold


def pairwise_dist_half(mesh1: torch.Tensor, mesh2: torch.Tensor) -> torch.Tensor:
    """``|p - q|^2 / 2`` between two point sets, (L1, L2) or batched (B,
    L1, L2): diff, square, sum, halve, in the JAX package's op order."""
    diff = mesh1[..., :, None, :] - mesh2[..., None, :, :]
    return 0.5 * torch.sum(diff * diff, dim=-1)


class TFDense(nn.Module):
    """A keras/flax ``Dense``: he-normal weight (stored ``(out, in)``),
    zero bias; cast to the activations' dtype at use, as flax's ``Dense(dtype=)``
    (:func:`~.pit.linear_at`)."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(he_normal_tf((in_features, out_features), generator).T.contiguous())
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x):
        return linear_at(x, self.weight, self.bias)


class TFMlp(nn.Module):
    """Dense -> exact GELU -> Dense (reference utils.py ``mlp``)."""

    def __init__(self, in_features: int, width1: int, width2: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mlp1 = TFDense(in_features, width1, generator)
        self.mlp2 = TFDense(width1, width2, generator)

    def forward(self, x):
        return self.mlp2(gelu(self.mlp1(x)))


class MultiHeadPosAttBatched(nn.Module):
    """Point-cloud position attention with per-head value projections:
    ``band_width`` r (1, H, 1, 1), bandwidth ``r^2``; ``weight`` (H, in, V)
    with V = hid / H. ``locality``: a percentile, above 100 global."""

    def __init__(self, in_features: int, n_head: int, hid_dim: int, locality: float,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_head = n_head
        self.hid_dim = hid_dim
        self.locality = locality
        v_dim = round(hid_dim / n_head)
        self.band_width = nn.Parameter(glorot_uniform((1, n_head, 1, 1), generator))
        self.weight = nn.Parameter(he_normal_tf((n_head, in_features, v_dim), generator))

    def forward(self, dist, inputs, thr=None, coords=None, band=None):
        """``dist``: the pre-built (B, L, L) halved distances, or None when
        ``coords`` (B, L, d) are given; ``thr`` (B, L, 1) on the halved
        distances, computed here from ``dist`` when a local op has none;
        ``band``: a kept-column ``BandSpec`` (coordinate path, needs
        ``thr``)."""
        if self.locality > 100:
            thr = None
        elif thr is None:
            if dist is None:
                dist = pairwise_dist_half(coords, coords)
            thr = quantile_threshold(dist, self.locality / 100.0)
        scales = (self.band_width * self.band_width).reshape(self.n_head, 1)
        B, L = inputs.shape[:2]
        values = at_least_f32(project(inputs, self.weight).reshape(B, L, self.hid_dim))
        if dist is None:
            out = position_attention_batched_tf_coords(coords, coords, scales, values, thr, band)
        else:
            out = position_attention_batched_dist(dist, scales, values, thr)
        return gelu(out.to(inputs.dtype))


class MultiHeadSelfAtt(nn.Module):
    """Dot-product self-attention with per-head projections ``query``,
    ``key`` and ``value``, (H, in, V) each with V = hid / H, he-normal, and
    a trailing exact GELU (the ``lite`` and ``transformer`` variants'
    attention); the attention itself is kernel #14."""

    def __init__(self, in_features: int, n_head: int, hid_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        shape = (n_head, in_features, round(hid_dim / n_head))
        self.query = nn.Parameter(he_normal_tf(shape, generator))
        self.key = nn.Parameter(he_normal_tf(shape, generator))
        self.value = nn.Parameter(he_normal_tf(shape, generator))

    def forward(self, inputs):
        proj = lambda w: at_least_f32(project(inputs, w))
        out = dot_attention(proj(self.query), proj(self.key), proj(self.value))
        return gelu(out.to(inputs.dtype))


class SelfMultiHeadPosAtt(nn.Module):
    """Hybrid attention (the ``selfpit`` variant's): logits ``q.k / sqrt(V)
    - tan(r_h) d`` over one (L, L) distance matrix, masked above each
    head's row quantile of ``tan(r_h) d`` for a ``locality`` of 100 or
    less. ``band_width`` r (H, 1, 1), ``query`` and ``key`` glorot-uniform
    (keras' default), ``weight`` (the values) he-normal; a trailing exact
    GELU. ``tan(r)`` takes either sign: keras' NonNeg projection follows
    each update (``train.benchmarks.nonneg_bandwidths``). The attention is
    kernel #14."""

    def __init__(self, in_features: int, n_head: int, hid_dim: int, locality: float,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.locality = locality
        shape = (n_head, in_features, round(hid_dim / n_head))
        self.band_width = nn.Parameter(glorot_uniform((n_head, 1, 1), generator))
        self.query = nn.Parameter(glorot_uniform(shape, generator))
        self.key = nn.Parameter(glorot_uniform(shape, generator))
        self.weight = nn.Parameter(he_normal_tf(shape, generator))

    def thresholds(self, dist, sc):
        """The heads' keep thresholds (H, L) on ``dist * sc`` (None for a
        global op): the per-head row quantile of the scaled distances, each
        forward, as the JAX package takes it where it is given none. No
        gradient flows through a threshold."""
        if self.locality > 100:
            return None
        with torch.no_grad():
            scaled = dist * sc.detach().reshape(-1, 1, 1)
            return quantile_threshold(scaled, self.locality / 100.0)[..., 0].contiguous()

    def forward(self, dist, inputs):
        """``dist`` (L, L), ``inputs`` (B, L, in)."""
        sc = torch.tan(self.band_width).reshape(-1)
        proj = lambda w: at_least_f32(project(inputs, w))
        out = dot_attention(proj(self.query), proj(self.key), proj(self.weight), dist,
                            self.thresholds(dist, sc), sc)
        return gelu(out.to(inputs.dtype))


def project(inputs: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The per-head projections ``inputs @ weight[h]`` (B, L, H, V) of
    ``inputs`` (B, L, in) by ``weight`` (H, in, V), in the inputs' dtype
    (the float32 weight cast at use)."""
    return torch.einsum("bnj,hjk->bnhk", inputs, weight.to(inputs.dtype))


def _given_thresholds(loc_en, loc_de, thr_en, thr_de):
    """Distinct locality -> given threshold, the first one not None: with
    ``loc_en == loc_de`` either threshold serves both ops."""
    given = {}
    for loc, t in ((loc_en, thr_en), (loc_de, thr_de)):
        if given.get(loc) is None:
            given[loc] = t
    return given


class PiTTFPointCloud(nn.Module):
    """``forward(inputs, thr_en=None, thr_de=None, band_en=None,
    band_de=None)`` with ``inputs`` (B, L, in_dim) returns (B, L, out_dim).

    - encoder: GELU(Dense(x)) -> MLP(attention down) + Dense -> GELU
    - processor: n_blocks x [MLP(global attention) + Dense -> GELU]
    - decoder: MLP(attention up) + Dense -> GELU -> MLP head

    ``thr_en`` / ``thr_de``: per-sample thresholds (B, L, 1) on the halved
    distances (setup computes them once for the constant clouds), and
    ``band_en`` / ``band_de`` their kept-column bands. ``processor_attention``
    and ``coder_attention``: ``"position"`` or ``"self"`` (the ``lite`` and
    ``transformer`` variants); a self op reads neither distances nor
    thresholds, and with no position op the model builds none.
    ``compute_dtype``: the activations' dtype; the distances and thresholds
    are built from the float32 coordinates before the inputs are cast, and
    the output is float32.
    """

    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        hid_dim: int,
        n_head: int,
        locality_encoder: float,
        locality_decoder: float,
        n_blocks: int = 4,
        processor_attention: str = "position",
        coder_attention: str = "position",
        compute_dtype: str = "float32",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        for kind in (processor_attention, coder_attention):
            if kind not in ("position", "self"):
                raise ValueError(
                    f"unknown point-cloud attention kind {kind!r} (position | self)"
                )
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        self.locality_encoder = locality_encoder
        self.locality_decoder = locality_decoder
        self.n_blocks = n_blocks
        self.coder_attention = coder_attention
        g = generator

        def att(kind, loc):
            if kind == "self":
                return MultiHeadSelfAtt(hid_dim, n_head, hid_dim, g)
            return MultiHeadPosAttBatched(hid_dim, n_head, hid_dim, loc, g)

        self.en_layer = TFDense(in_dim, hid_dim, g)
        self.down = att(coder_attention, locality_encoder)
        self.mlp1 = TFMlp(hid_dim, hid_dim, hid_dim, g)
        self.w1 = TFDense(hid_dim, hid_dim, g)
        for i in range(n_blocks):
            self.add_module(f"PA_{i}", att(processor_attention, 200.0))
            self.add_module(f"MLP_{i}", TFMlp(hid_dim, hid_dim, hid_dim, g))
            self.add_module(f"W_{i}", TFDense(hid_dim, hid_dim, g))
        self.up = att(coder_attention, locality_decoder)
        self.mlp2 = TFMlp(hid_dim, hid_dim, hid_dim, g)
        self.w2 = TFDense(hid_dim, hid_dim, g)
        self.de_layer = TFMlp(hid_dim, hid_dim, out_dim, g)

    def forward(self, inputs, thr_en=None, thr_de=None, band_en=None, band_de=None):
        coords = inputs[..., :2].contiguous()
        loc_en, loc_de = self.locality_encoder, self.locality_decoder
        given = _given_thresholds(loc_en, loc_de, thr_en, thr_de)
        # the (B, L, L) distances exist only to give a local position op its
        # missing thresholds; then every position op reads them (kernel #9),
        # else each computes its own from the coordinates (kernel #11)
        need_thr = self.coder_attention == "position"
        m_dist = None
        if need_thr and any(t is None and loc <= 100 for loc, t in given.items()):
            m_dist = pairwise_dist_half(coords, coords)
        thr = {
            loc: (t if t is not None or loc > 100 or not need_thr
                  else quantile_threshold(m_dist, loc / 100.0))
            for loc, t in given.items()
        }
        band = {loc_en: band_en, loc_de: band_de}
        if loc_en == loc_de:
            band[loc_en] = band_en if band_en is not None else band_de
        pass_coords = coords if m_dist is None else None

        def att(op, x, loc=None):
            if isinstance(op, MultiHeadSelfAtt):
                return op(x)
            if loc is None:
                return op(m_dist, x, coords=pass_coords)
            return op(m_dist, x, thr[loc], coords=pass_coords, band=band[loc])

        en = gelu(self.en_layer(to_compute_dtype(inputs, self.compute_dtype)))
        x = gelu(self.mlp1(att(self.down, en, loc_en)) + self.w1(en))
        for i in range(self.n_blocks):
            pa = att(getattr(self, f"PA_{i}"), x)
            x = gelu(getattr(self, f"MLP_{i}")(pa) + getattr(self, f"W_{i}")(x))
        de = gelu(self.mlp2(att(self.up, x, loc_de)) + self.w2(x))
        return at_least_f32(self.de_layer(de))


# ------------------------------------------------------------ fixed meshes


class TFGeometry(NamedTuple):
    """The precomputed distance matrices of a fixed-mesh PiTTF: ``m_qry``
    (L_qry, L_qry, only the decoder self-attention reads it), ``m_cross``
    (L_qry, L_ltt) and ``m_ltt`` (L_ltt, L_ltt), and the thresholds of the
    local ops, (rows, 2) each: the quantiles at p and at 1 - p of each row
    of ``m_cross.T`` (``thr_down``), ``m_cross`` (``thr_up``) and ``m_qry``
    (``thr_qry``). ``m_cross_t``: ``m_cross.T`` stored contiguous for the
    encoder's kernel. Built by :func:`tf_precompute_thresholds`."""

    m_qry: Optional[torch.Tensor]
    m_cross: torch.Tensor
    m_ltt: Optional[torch.Tensor] = None
    thr_down: Optional[torch.Tensor] = None
    thr_up: Optional[torch.Tensor] = None
    thr_qry: Optional[torch.Tensor] = None
    m_cross_t: Optional[torch.Tensor] = None

    def to(self, device) -> "TFGeometry":
        return TFGeometry(*(None if t is None else t.to(device) for t in self))

    def cross_t(self) -> torch.Tensor:
        """``m_cross.T``, contiguous: the encoder's distances."""
        return self.m_cross_t if self.m_cross_t is not None else self.m_cross.T.contiguous()


def tf_precompute_thresholds(geom: TFGeometry, en_loc: float, de_loc: float) -> TFGeometry:
    """Fill the thresholds for percentile localities (0-100; above 100 the
    op is global and has none), and ``m_cross_t``. Both quantiles of each
    row are stored, so that a head's sign-aware keep threshold is a
    rescale: ``quantile(s d, p)`` is ``s quantile(d, p)`` for ``s >= 0`` and
    ``s quantile(d, 1 - p)`` for ``s < 0``."""
    cross_t = geom.m_cross.T.contiguous()
    thr = lambda m, loc: None if m is None else percentile_thresholds(m, loc)
    return geom._replace(
        thr_down=thr(cross_t, en_loc), thr_up=thr(geom.m_cross, de_loc),
        thr_qry=thr(geom.m_qry, de_loc), m_cross_t=cross_t,
    )


def pairwise_dist_periodic_1d(res1: int, res2: int, device="cpu") -> torch.Tensor:
    """Squared distance on the periodic unit grids of ``res1`` and ``res2``
    points, over its largest value 0.25: the minimum over the direct and
    the two unit-shifted differences, in the JAX package's op order."""
    g1 = torch.linspace(0, 1, res1 + 1, dtype=torch.float32, device=device)[:-1].reshape(-1, 1)
    g2 = torch.linspace(0, 1, res2 + 1, dtype=torch.float32, device=device)[:-1].reshape(1, -1)
    d2 = (g1 - g2) ** 2
    d2 = torch.minimum(d2, (g1 + 1 - g2) ** 2)
    d2 = torch.minimum(d2, (g1 - 1 - g2) ** 2)
    return d2 / 0.25


def _sqrt_rn(y: torch.Tensor) -> torch.Tensor:
    """The square root of a float32 ``y`` >= 0, correctly rounded to float32
    on every device, as XLA's is. torch's CPU sqrt calls MKL's vector math,
    which is not correctly rounded, and in some processes keeps only about
    half the bits; three Newton steps in float64 from its result reach the
    float64 root, which rounds to the float32 one."""
    y64 = y.double()
    r = torch.sqrt(y64)
    r = torch.where(r > 0, r, 1.0)
    for _ in range(3):
        r = 0.5 * (r + y64 / r)
    return torch.where(y64 > 0, r, 0.0).float()


def pairwise_dist_periodic_2d(mesh1: torch.Tensor, mesh2: torch.Tensor) -> torch.Tensor:
    """Squared distance on the unit torus: the smallest norm over the direct
    image and the four unit shifts (no diagonal ones), squared. The root is
    taken once, of the smallest squared norm (a correctly rounded root is
    monotone, so the value is the same), by :func:`_sqrt_rn`: a local op's
    kept set jumps with these distances, which tie on a regular grid."""
    shifts = torch.tensor(
        [[0.0, 0.0], [1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]],
        dtype=torch.float32, device=mesh1.device,
    )
    diff = mesh1[:, None, :] - mesh2[None, :, :]
    x = diff[None] + shifts[:, None, None, :]
    return _sqrt_rn(torch.amin(torch.sum(x * x, dim=-1), dim=0)) ** 2


# 0.25 pi (1 - 1e-7), a Python double that JAX rounds to float32 once
_TAN_SIN = torch.tensor(0.25 * math.pi * (1 - 1e-7), dtype=torch.float32)


def _bandwidth(r: torch.Tensor, kind: str) -> torch.Tensor:
    """The scale of each head from its parameter r: ``tan_sin``
    (tan(0.25 pi (1 - 1e-7) (1 + sin r)), never negative), ``square`` (r^2)
    or ``tan`` (tan r, of either sign: keras' NonNeg projection of r follows
    each optimizer update, ``train.benchmarks.nonneg_bandwidths``; a clamp
    here would stop the gradient at r < 0)."""
    if kind == "tan_sin":
        return torch.tan(_TAN_SIN.to(r.device) * (1.0 + torch.sin(r)))
    if kind == "square":
        return r * r
    if kind == "tan":
        return torch.tan(r)
    raise ValueError(f"unknown bandwidth kind {kind!r}")


class MultiHeadPosAtt(nn.Module):
    """Fixed-mesh position attention with per-head value projections:
    ``band_width`` r (H, 1, 1), the bandwidth ``bandwidth`` of it,
    ``weight`` (H, in, V) with V = hid / H. ``locality``: a percentile,
    above 100 global."""

    def __init__(self, in_features: int, n_head: int, hid_dim: int, locality: float,
                 bandwidth: str = "tan_sin", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_head = n_head
        self.hid_dim = hid_dim
        self.locality = locality
        self.bandwidth = bandwidth
        v_dim = round(hid_dim / n_head)
        self.band_width = nn.Parameter(glorot_uniform((n_head, 1, 1), generator))
        self.weight = nn.Parameter(he_normal_tf((n_head, in_features, v_dim), generator))

    def forward(self, dist, inputs, thr=None):
        """``dist`` (L_out, L_in), ``inputs`` (B, L_in, in), ``thr`` (L_out,
        2): the quantiles at p and 1 - p of each row, computed from ``dist``
        when a local op has none."""
        scales = _bandwidth(self.band_width, self.bandwidth).reshape(self.n_head, 1)
        B, L = inputs.shape[:2]
        values = at_least_f32(project(inputs, self.weight).reshape(B, L, self.hid_dim))
        out = position_attention_tf_fixed(dist, thr, scales, values, self.bandwidth, self.locality)
        return gelu(out.to(inputs.dtype))


class PiTTF(nn.Module):
    """``forward(geom, mesh, inputs)``: ``geom`` a :class:`TFGeometry`,
    ``mesh`` (L, d) or (B, L, d) the query mesh, ``inputs`` (B, L, c) ->
    (B, L, out_dim); ``in_dim`` = d + c.

    - encoder: GELU(Dense([mesh, inputs])) -> attention ``down`` over
      ``m_cross.T``
    - processor: n_blocks x [MLP(global attention over ``m_ltt``) + Dense ->
      GELU]
    - decoder: attention ``up`` over ``m_cross`` [-> ``up2`` over ``m_qry``,
      MLP of it + Dense -> GELU] -> MLP head

    ``processor_attention`` / ``coder_attention``: the kind of the processor's
    and of the coders' ops (:func:`tf_attention`): ``lite`` is ``("self",
    "position")``, ``transformer`` ``("self", "self")``, ``selfpit``
    ``("hybrid", "hybrid")``. Only position ops read the precomputed
    thresholds. ``compute_dtype``: the activations' dtype from the
    encoder's input (the mesh concat) on; the output is float32.
    """

    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        hid_dim: int,
        n_head: int,
        locality_encoder: float,
        locality_decoder: float,
        n_blocks: int = 4,
        bandwidth: str = "tan_sin",
        use_decoder_selfatt: bool = True,
        processor_attention: str = "position",
        coder_attention: str = "position",
        compute_dtype: str = "float32",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        self.n_blocks = n_blocks
        self.use_decoder_selfatt = use_decoder_selfatt
        g = generator
        pa_kind, ca_kind = processor_attention, coder_attention
        att = lambda kind, loc: tf_attention(kind, hid_dim, n_head, hid_dim, loc, bandwidth, g)
        self.en_layer = TFDense(in_dim, hid_dim, g)
        self.down = att(ca_kind, locality_encoder)
        for i in range(n_blocks):
            self.add_module(f"MHPA_{i}", att(pa_kind, 200.0))
            self.add_module(f"MLP_{i}", TFMlp(hid_dim, hid_dim, hid_dim, g))
            self.add_module(f"W_{i}", TFDense(hid_dim, hid_dim, g))
        self.up = att(ca_kind, locality_decoder)
        if use_decoder_selfatt:
            self.up2 = att(ca_kind, locality_decoder)
            self.mlp = TFMlp(hid_dim, hid_dim, hid_dim, g)
            self.w = TFDense(hid_dim, hid_dim, g)
        self.de_layer = TFMlp(hid_dim, hid_dim, out_dim, g)

    def forward(self, geom: TFGeometry, mesh: torch.Tensor, inputs: torch.Tensor):
        if mesh.ndim == 2:
            mesh = mesh.expand(inputs.shape[0], *mesh.shape)
        en = gelu(self.en_layer(to_compute_dtype(torch.cat([mesh, inputs], dim=-1),
                                                 self.compute_dtype)))
        x = apply_attention(self.down, geom.cross_t(), en, geom.thr_down)
        for i in range(self.n_blocks):
            pa = apply_attention(getattr(self, f"MHPA_{i}"), geom.m_ltt, x)
            x = gelu(getattr(self, f"MLP_{i}")(pa) + getattr(self, f"W_{i}")(x))
        de = apply_attention(self.up, geom.m_cross, x, geom.thr_up)
        if self.use_decoder_selfatt:
            de2 = apply_attention(self.up2, geom.m_qry, de, geom.thr_qry)
            de = gelu(self.mlp(de2) + self.w(de))
        return at_least_f32(self.de_layer(de))


def tf_attention(kind: str, in_features: int, n_head: int, hid_dim: int, locality: float,
                 bandwidth: str = "tan_sin", generator: Optional[torch.Generator] = None):
    """The fixed-mesh attention op of one kind: ``"position"``
    (:class:`MultiHeadPosAtt`), ``"self"`` (:class:`MultiHeadSelfAtt`) or
    ``"hybrid"`` (:class:`SelfMultiHeadPosAtt`)."""
    if kind == "position":
        return MultiHeadPosAtt(in_features, n_head, hid_dim, locality, bandwidth, generator)
    if kind == "self":
        return MultiHeadSelfAtt(in_features, n_head, hid_dim, generator)
    if kind == "hybrid":
        return SelfMultiHeadPosAtt(in_features, n_head, hid_dim, locality, generator)
    raise ValueError(f"unknown attention kind {kind!r}")


def apply_attention(op: nn.Module, dist, x, thr=None):
    """One fixed-mesh attention op on ``x``: a position op over ``dist``
    with the thresholds ``thr``; a self op reads neither; a hybrid op reads
    ``dist`` and takes its thresholds in the call, as the JAX package's
    PiTTF passes none."""
    if isinstance(op, MultiHeadSelfAtt):
        return op(x)
    if isinstance(op, SelfMultiHeadPosAtt):
        return op(dist, x)
    return op(dist, x, thr)
