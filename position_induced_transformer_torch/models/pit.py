"""Position-induced Transformer (torch-semantics family) as ``nn.Module``s.

Encoder -> processor -> decoder. The module is resolution-independent:
mesh metric and sizes live in the :class:`~.geometry.Geometry` passed to
``forward``, so re-binding a model to a finer mesh is building a new
Geometry. Submodule names follow the reference torch state dict (``down``,
``en_layer.mlp1/mlp2``, ``conv.<i>``, ``mlp.<i>``, ``up``, ``de``), so
weights carried over from the JAX package with
``utils.torch_compat.flax_params_to_state_dict`` load unchanged.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from position_induced_transformer_torch.kernels.posatt_batched import (
    position_attention_batched,
)
from position_induced_transformer_torch.kernels.posatt_pallas import (
    position_attention_fixed,
)
from position_induced_transformer_torch.models.geometry import Geometry
from position_induced_transformer_torch.ops.distances import pairwise_sq_dist
from position_induced_transformer_torch.ops.initializers import (
    kaiming_normal,
    torch_linear_bias,
    uniform01,
)
from position_induced_transformer_torch.ops.locality import robust_topk_threshold
from position_induced_transformer_torch.ops.normalization import instance_norm


class TorchLinear(nn.Module):
    """``nn.Linear`` with kaiming-normal weights and the default uniform
    bias, drawn from ``generator``."""

    def __init__(
        self, in_features: int, out_features: int,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.weight = nn.Parameter(
            kaiming_normal((out_features, in_features), generator)
        )
        self.bias = nn.Parameter(
            torch_linear_bias(in_features, (out_features,), generator)
        )

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class KaimingMLP(nn.Module):
    """Two linear layers with the exact (erf) GELU between them."""

    def __init__(
        self, in_features: int, hidden: int, features: int,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.mlp1 = TorchLinear(in_features, hidden, generator)
        self.mlp2 = TorchLinear(hidden, features, generator)

    def forward(self, x):
        return self.mlp2(F.gelu(self.mlp1(x), approximate="none"))


def _dispatch_posatt(dist, lmda, inputs, locality, thr, mesh_q=None, mesh_k=None, band=None):
    """Route an attention op to its kernel wrapper; each launches its CUDA
    kernel for CUDA tensors and runs the plain version for CPU tensors.

    Fixed meshes (a 2-D ``dist``) take the fixed-mesh kernel. Lazy
    per-sample geometry (``dist`` None, raw coordinates ``mesh_q`` and
    ``mesh_k``) takes the batched kernel; without precomputed thresholds a
    local op first computes the robust wide-gap ones from the distances,
    so that its kept sets match every other path's.
    """
    if dist is None:
        if locality < 1.0 and thr is None:
            thr = robust_topk_threshold(pairwise_sq_dist(mesh_q, mesh_k), locality)
        return position_attention_batched(mesh_q, mesh_k, lmda, inputs, locality, thr, band)
    if dist.ndim != 2:
        raise NotImplementedError(
            "batched (B, L_out, L_in) distances are not ported; per-sample "
            "meshes take a lazy Geometry"
        )
    return position_attention_fixed(dist, lmda, inputs, locality, thr=thr)


class PosAtt(nn.Module):
    """Self position attention with residual-by-concat ``[inputs, conv]``;
    holds only the (n_head, 1, 1) bandwidth parameter."""

    def __init__(
        self, n_head: int, locality: float = 1.0,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.locality = locality
        self.lmda = nn.Parameter(uniform01((n_head, 1, 1), generator))

    def forward(self, dist, inputs, thr=None, mesh_q=None, mesh_k=None, band=None):
        conv = _dispatch_posatt(
            dist, self.lmda, inputs, self.locality, thr, mesh_q, mesh_k, band
        )
        return torch.cat([inputs, conv], dim=-1)


class PosAttCross(nn.Module):
    """Cross position attention: the convolution only, no concat."""

    def __init__(
        self, n_head: int, locality: float,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.locality = locality
        self.lmda = nn.Parameter(uniform01((n_head, 1, 1), generator))

    def forward(self, dist, inputs, thr=None, mesh_q=None, mesh_k=None, band=None):
        return _dispatch_posatt(
            dist, self.lmda, inputs, self.locality, thr, mesh_q, mesh_k, band
        )


class PiT(nn.Module):
    """``forward(geom, func_in)`` with ``func_in`` (B, L_in, in_dim) returns
    (B, L_out, out_dim).

    - encoder: [mesh concat ->] cross attention onto the latent mesh ->
      MLP(H*(space+in) -> hid -> hid) -> GELU
    - processor: n_blocks x [global self attention (concat residual) ->
      MLP((1+H)*hid -> hid -> hid) -> GELU]
    - decoder: cross attention up -> MLP(H*hid -> hid -> out_dim)
    """

    def __init__(
        self,
        space_dim: int,
        in_dim: int,
        out_dim: int,
        hid_dim: int,
        n_head: int,
        n_blocks: int,
        en_loc: float,
        de_loc: float,
        concat_mesh: bool = True,
        use_instance_norm: bool = False,
        residual_output: bool = False,
        compute_dtype: str = "float32",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype {compute_dtype!r}: the port computes in "
                "float32 only"
            )
        self.concat_mesh = concat_mesh
        self.use_instance_norm = use_instance_norm
        self.residual_output = residual_output
        enc_in = n_head * (in_dim + (space_dim if concat_mesh else 0))
        g = generator
        self.down = PosAttCross(n_head, en_loc, g)
        self.en_layer = KaimingMLP(enc_in, hid_dim, hid_dim, g)
        self.conv = nn.ModuleList(PosAtt(n_head, 1.0, g) for _ in range(n_blocks))
        self.mlp = nn.ModuleList(
            KaimingMLP((1 + n_head) * hid_dim, hid_dim, hid_dim, g)
            for _ in range(n_blocks)
        )
        self.up = PosAttCross(n_head, de_loc, g)
        self.de = KaimingMLP(n_head * hid_dim, hid_dim, out_dim, g)

    def encoder(self, geom: Geometry, func_in: torch.Tensor) -> torch.Tensor:
        if self.concat_mesh:
            mesh = geom.mesh_in
            if mesh.ndim == 2:  # fixed mesh: broadcast over the batch
                mesh = mesh.expand(func_in.shape[0], -1, -1)
            func_in = torch.cat([mesh, func_in], dim=-1)
        f = self.down(
            geom.dist_down, func_in, geom.thr_down,
            mesh_q=geom.mesh_ltt, mesh_k=geom.mesh_in, band=geom.band_down,
        )
        return F.gelu(self.en_layer(f), approximate="none")

    def processor(self, geom: Geometry, f: torch.Tensor) -> torch.Tensor:
        for a, w in zip(self.conv, self.mlp):
            f = a(geom.dist_proc, f, mesh_q=geom.mesh_ltt, mesh_k=geom.mesh_ltt)
            f = F.gelu(w(f), approximate="none")
        return f

    def decoder(self, geom: Geometry, f: torch.Tensor) -> torch.Tensor:
        f = self.up(
            geom.dist_up, f, geom.thr_up,
            mesh_q=geom.mesh_out, mesh_k=geom.mesh_ltt, band=geom.band_up,
        )
        return self.de(f)

    def forward(self, geom: Geometry, func_in: torch.Tensor) -> torch.Tensor:
        f = self.encoder(geom, func_in)
        if self.use_instance_norm:
            f = instance_norm(f)
        f = self.processor(geom, f)
        if self.use_instance_norm:
            f = instance_norm(f)
        out = self.decoder(geom, f)
        if self.residual_output:
            out = out + func_in
        return out
