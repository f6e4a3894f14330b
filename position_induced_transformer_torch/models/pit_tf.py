"""TF-semantics point-cloud PiT (the JAX package's ``models/pit_tf.py``,
its point-cloud half) as ``nn.Module``s.

The reference's older TensorFlow implementation differs from the torch one
(reference: tensorflow/5_Elasticity/utils.py:60-188): the value projection
lives inside the attention op (``v_dim = hid / heads``, one per head) with
a trailing GELU, the bandwidth is ``r^2``, locality is a percentile in [0,
100] (above 100: global), and every stage adds an MLP of the attention to
a linear map of its input. Distances are ``|x_i - x_j|^2 / 2`` between the
first two input channels of each sample.

Every attention op takes a hand-written kernel: with a threshold for each
local op (precomputed at setup) the coordinate kernel #11, which computes
the distances itself; otherwise the model builds the (B, L, L) halved
distances once, takes the missing thresholds from them, and all six ops
read them through kernel #9. Submodule names follow the JAX parameter tree
(``en_layer``, ``down``, ``mlp1``, ``w1``, ``PA_<i>``, ``MLP_<i>``,
``W_<i>``, ``up``, ``mlp2``, ``w2``, ``de_layer``), so that
``utils.torch_compat.flax_tf_params_to_state_dict`` carries JAX weights
over. Only ``"position"`` attention and float32 are ported.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from position_induced_transformer_torch.kernels.posatt_batched import (
    position_attention_batched_dist,
    position_attention_batched_tf_coords,
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
    zero bias."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(he_normal_tf((in_features, out_features), generator).T.contiguous())
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class TFMlp(nn.Module):
    """Dense -> exact GELU -> Dense (reference utils.py ``mlp``)."""

    def __init__(self, in_features: int, width1: int, width2: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mlp1 = TFDense(in_features, width1, generator)
        self.mlp2 = TFDense(width1, width2, generator)

    def forward(self, x):
        return self.mlp2(F.gelu(self.mlp1(x), approximate="none"))


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
        values = torch.einsum("bnj,hjk->bnhk", inputs, self.weight).reshape(B, L, self.hid_dim)
        if dist is None:
            out = position_attention_batched_tf_coords(coords, coords, scales, values, thr, band)
        else:
            out = position_attention_batched_dist(dist, scales, values, thr)
        return F.gelu(out, approximate="none")


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
    ``band_en`` / ``band_de`` their kept-column bands.
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
            if kind != "position":
                raise NotImplementedError(
                    f"{kind!r} attention is not ported; the point-cloud model takes "
                    "'position' attention only"
                )
        if compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype {compute_dtype!r}: the port computes in float32 only"
            )
        self.locality_encoder = locality_encoder
        self.locality_decoder = locality_decoder
        self.n_blocks = n_blocks
        g = generator
        att = lambda loc: MultiHeadPosAttBatched(hid_dim, n_head, hid_dim, loc, g)
        self.en_layer = TFDense(in_dim, hid_dim, g)
        self.down = att(locality_encoder)
        self.mlp1 = TFMlp(hid_dim, hid_dim, hid_dim, g)
        self.w1 = TFDense(hid_dim, hid_dim, g)
        for i in range(n_blocks):
            self.add_module(f"PA_{i}", att(200.0))
            self.add_module(f"MLP_{i}", TFMlp(hid_dim, hid_dim, hid_dim, g))
            self.add_module(f"W_{i}", TFDense(hid_dim, hid_dim, g))
        self.up = att(locality_decoder)
        self.mlp2 = TFMlp(hid_dim, hid_dim, hid_dim, g)
        self.w2 = TFDense(hid_dim, hid_dim, g)
        self.de_layer = TFMlp(hid_dim, hid_dim, out_dim, g)

    def forward(self, inputs, thr_en=None, thr_de=None, band_en=None, band_de=None):
        coords = inputs[..., :2].contiguous()
        loc_en, loc_de = self.locality_encoder, self.locality_decoder
        given = _given_thresholds(loc_en, loc_de, thr_en, thr_de)
        # the (B, L, L) distances exist only to give a local op its missing
        # thresholds; then every op reads them (kernel #9), else every op
        # computes its own from the coordinates (kernel #11)
        m_dist = None
        if any(t is None and loc <= 100 for loc, t in given.items()):
            m_dist = pairwise_dist_half(coords, coords)
        thr = {
            loc: t if t is not None or loc > 100 else quantile_threshold(m_dist, loc / 100.0)
            for loc, t in given.items()
        }
        band = {loc_en: band_en, loc_de: band_de}
        if loc_en == loc_de:
            band[loc_en] = band_en if band_en is not None else band_de
        pass_coords = coords if m_dist is None else None
        gelu = lambda t: F.gelu(t, approximate="none")

        en = gelu(self.en_layer(inputs))
        a = self.down(m_dist, en, thr[loc_en], coords=pass_coords, band=band[loc_en])
        x = gelu(self.mlp1(a) + self.w1(en))
        for i in range(self.n_blocks):
            pa = getattr(self, f"PA_{i}")(m_dist, x, coords=pass_coords)
            x = gelu(getattr(self, f"MLP_{i}")(pa) + getattr(self, f"W_{i}")(x))
        a = self.up(m_dist, x, thr[loc_de], coords=pass_coords, band=band[loc_de])
        de = gelu(self.mlp2(a) + self.w2(x))
        return self.de_layer(de)
