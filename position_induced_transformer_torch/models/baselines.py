"""The TF family's ablation baselines as standalone models (the JAX
package's ``models/baselines.py``; reference:
tensorflow/1_InviscidBurgers/utils.py:230-553).

- ``LiteTransformer``: dot-product self-attention in the processor, position
  attention in the encoder and decoder.
- ``Transformer``: dot-product self-attention everywhere; no geometry.
- ``SelfPiT``: hybrid attention everywhere (``q.k / sqrt(V) - tan(r) d``).

Their runnable path is ``BenchmarkConfig.model_variant`` (``lite``,
``transformer``, ``selfpit``), which swaps the attention kinds of each
benchmark's own ``PiTTF`` or ``PiTTFPointCloud``; these classes mirror the
1-D experiment's baselines, with the JAX parameter tree's names, so that
``utils.torch_compat.flax_tf_params_to_state_dict`` carries its weights
over. ``in_dim`` is the mesh's dimension plus the input channels.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from position_induced_transformer_torch.models.pit_tf import (
    MultiHeadPosAtt,
    MultiHeadSelfAtt,
    SelfMultiHeadPosAtt,
    TFDense,
    TFGeometry,
    TFMlp,
)


def _gelu(t):
    return F.gelu(t, approximate="none")


class _EncProcDec(nn.Module):
    """The baselines' scaffold: ``en_layer``; ``n_blocks`` x [``MLP_<i>`` of
    the attention + ``W_<i>`` -> GELU]; ``mlp`` + ``w`` -> GELU; the MLP head
    ``de_layer``. Subclasses add the attention ops."""

    def __init__(self, in_dim: int, out_dim: int, hid_dim: int, n_head: int, n_blocks: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hid_dim, self.n_head, self.n_blocks = hid_dim, n_head, n_blocks
        g = generator
        self.en_layer = TFDense(in_dim, hid_dim, g)
        for i in range(n_blocks):
            self.add_module(f"MLP_{i}", TFMlp(hid_dim, hid_dim, hid_dim, g))
            self.add_module(f"W_{i}", TFDense(hid_dim, hid_dim, g))
        self.mlp = TFMlp(hid_dim, hid_dim, hid_dim, g)
        self.w = TFDense(hid_dim, hid_dim, g)
        self.de_layer = TFMlp(hid_dim, hid_dim, out_dim, g)

    def _encode(self, mesh, inputs):
        if mesh.ndim == 2:
            mesh = mesh.expand(inputs.shape[0], *mesh.shape)
        return _gelu(self.en_layer(torch.cat([mesh, inputs], dim=-1)))

    def _process(self, x, attend):
        for i in range(self.n_blocks):
            pa = attend(i, x)
            x = _gelu(getattr(self, f"MLP_{i}")(pa) + getattr(self, f"W_{i}")(x))
        return x

    def _decode(self, de, de2):
        return self.de_layer(_gelu(self.mlp(de2) + self.w(de)))


class LiteTransformer(_EncProcDec):
    """``forward(geom, mesh, inputs)``: position attention ``down`` over
    ``m_cross.T``, self-attention processor ``PA_<i>``, position attention
    ``up`` over ``m_cross`` and ``up2`` over ``m_qry`` (tan-sin bandwidth,
    thresholds in the call)."""

    def __init__(self, in_dim: int, out_dim: int, hid_dim: int, n_head: int, n_blocks: int = 4,
                 locality_encoder: float = 100.0, locality_decoder: float = 100.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_dim, out_dim, hid_dim, n_head, n_blocks, generator)
        g = generator
        self.down = MultiHeadPosAtt(hid_dim, n_head, hid_dim, locality_encoder, generator=g)
        for i in range(n_blocks):
            self.add_module(f"PA_{i}", MultiHeadSelfAtt(hid_dim, n_head, hid_dim, g))
        self.up = MultiHeadPosAtt(hid_dim, n_head, hid_dim, locality_decoder, generator=g)
        self.up2 = MultiHeadPosAtt(hid_dim, n_head, hid_dim, locality_decoder, generator=g)

    def forward(self, geom: TFGeometry, mesh, inputs):
        x = self.down(geom.cross_t(), self._encode(mesh, inputs))
        x = self._process(x, lambda i, xx: getattr(self, f"PA_{i}")(xx))
        de = self.up(geom.m_cross, x)
        return self._decode(de, self.up2(geom.m_qry, de))


class Transformer(_EncProcDec):
    """``forward(mesh, inputs)``: self-attention ``down``, ``PA_<i>``,
    ``up`` and ``up2``; no geometry."""

    def __init__(self, in_dim: int, out_dim: int, hid_dim: int, n_head: int, n_blocks: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_dim, out_dim, hid_dim, n_head, n_blocks, generator)
        att = lambda: MultiHeadSelfAtt(hid_dim, n_head, hid_dim, generator)
        self.down = att()
        for i in range(n_blocks):
            self.add_module(f"PA_{i}", att())
        self.up = att()
        self.up2 = att()

    def forward(self, mesh, inputs):
        x = self.down(self._encode(mesh, inputs))
        x = self._process(x, lambda i, xx: getattr(self, f"PA_{i}")(xx))
        de = self.up(x)
        return self._decode(de, self.up2(de))


class SelfPiT(_EncProcDec):
    """``forward(geom, mesh, inputs)``: hybrid attention everywhere, ``down``
    over ``m_cross.T``, the global processor ``MHPA_<i>`` over ``m_ltt``,
    ``up`` over ``m_cross`` and ``up2`` over ``m_qry``; every matrix square
    (latent == query resolution)."""

    def __init__(self, in_dim: int, out_dim: int, hid_dim: int, n_head: int, n_blocks: int = 4,
                 locality_encoder: float = 100.0, locality_decoder: float = 100.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_dim, out_dim, hid_dim, n_head, n_blocks, generator)
        att = lambda loc: SelfMultiHeadPosAtt(hid_dim, n_head, hid_dim, loc, generator)
        self.down = att(locality_encoder)
        for i in range(n_blocks):
            self.add_module(f"MHPA_{i}", att(200.0))
        self.up = att(locality_decoder)
        self.up2 = att(locality_decoder)

    def forward(self, geom: TFGeometry, mesh, inputs):
        x = self.down(geom.cross_t(), self._encode(mesh, inputs))
        x = self._process(x, lambda i, xx: getattr(self, f"MHPA_{i}")(geom.m_ltt, xx))
        de = self.up(geom.m_cross, x)
        return self._decode(de, self.up2(geom.m_qry, de))
