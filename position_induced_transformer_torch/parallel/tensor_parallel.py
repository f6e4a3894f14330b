"""Tensor parallelism over the model axis for the torch-family PiT: the
counterpart of the JAX package's ``_param_pspec``, ``param_shardings`` and
``shard_state`` (``parallel/sharding.py``), whose collectives GSPMD writes
there and this module spells out.

A rank of model index m of M holds:

- each ``KaimingMLP`` (``en_layer``, ``mlp.<i>``, ``de``) column- then
  row-parallel: rows ``[m h / M, (m + 1) h / M)`` of ``mlp1``'s weight and
  bias (its output features), the same columns of ``mlp2``'s weight (its
  input features) and ``mlp2``'s whole bias, added once after the sum of
  the partial products over the model group;
- each ``PosAtt`` / ``PosAttCross`` bandwidth's heads ``[m H / M, (m + 1)
  H / M)`` where M divides the head count (the attention runs on those
  heads and the outputs are gathered over the group in head order), and
  all heads otherwise;
- its optimizer's moments split as its parameters are.

An MLP width that M does not divide raises the JAX package's
``ValueError``; nothing falls back to a replicated MLP. The TF family
(``PiTTF``, ``PiTTFPointCloud`` and the variants) raises
``NotImplementedError``.

The collectives are ``torch.autograd.Function``s, each forward with its
adjoint: :class:`_CopyToModel` (identity; the gradients summed),
:class:`_SumOverModel` (the sum; identity) and :class:`_GatherHeads` (an
all-gather on the feature axis; a reduce-scatter). A gradient that reaches
a tensor every model rank uses (the residual ``u`` of a processor block,
the gathered head outputs) is summed over the group exactly once.
"""

from __future__ import annotations

import copy

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from position_induced_transformer_torch.models.pit import PiT, _dispatch_posatt, gelu, linear_at
from position_induced_transformer_torch.parallel.sharding import DataMesh, all_gather
from position_induced_transformer_torch.train.loop import TrainState


def _split_dim(name: str, shape, model_axis_size: int):
    """The axis along which the parameter ``name`` splits over the model
    group, or None (replicated): the JAX package's ``_param_pspec`` on the
    port's parameter names and its (out, in) weight layout."""
    if model_axis_size <= 1:
        return None
    parts = name.split(".")
    leaf = parts[-1]
    if leaf == "lmda":
        return 0 if shape[0] % model_axis_size == 0 else None

    def check(dim: int, what: str):
        if dim % model_axis_size:
            raise ValueError(
                f"tensor parallelism: {what} ({dim}) at {name} is not divisible by "
                f"the 'model' axis size {model_axis_size} — choose a model axis that "
                "divides hid_dim"
            )

    if "mlp1" in parts and leaf == "weight":
        check(shape[0], "mlp1 output features")
        return 0  # column parallel
    if "mlp1" in parts and leaf == "bias":
        check(shape[0], "mlp1 bias features")
        return 0
    if "mlp2" in parts and leaf == "weight":
        check(shape[1], "mlp2 input features")
        return 1  # row parallel (summed after)
    return None


def _require_pit(model) -> None:
    if not isinstance(model, PiT):
        raise NotImplementedError(
            f"the model (head) axis is ported for the torch-family PiT only; "
            f"{type(model).__name__} is of the TF family (PiTTF, PiTTFPointCloud "
            "and the variants), whose model axis is not ported yet"
        )


def check_model_axis(mesh, model: nn.Module) -> None:
    """Refuse the TF family under a model axis of more than one rank
    (``NotImplementedError``), at every entry point that takes a mesh."""
    if isinstance(mesh, DataMesh) and mesh.model > 1:
        _require_pit(model)


def param_shardings(mesh: DataMesh, model: nn.Module) -> dict:
    """Each parameter name of a whole ``PiT`` -> the axis it splits along
    over ``mesh``'s model axis, or None where it is replicated. Raises as
    :func:`shard_model` does."""
    _require_pit(model)
    return {n: _split_dim(n, tuple(p.shape), mesh.model) for n, p in model.named_parameters()}


def _part(t: torch.Tensor, dim, mesh: DataMesh) -> torch.Tensor:
    return t if dim is None else t.chunk(mesh.model, dim)[mesh.model_rank].clone()


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a collective takes it: float32 below float32 (exact for a
    gather, one rounding for a sum), else a copy."""
    return t.float() if t.dtype.itemsize < 4 else t.clone()


def _summed(group, t: torch.Tensor) -> torch.Tensor:
    out = _wire(t)
    dist.all_reduce(out, group=group)
    return out.to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(ctx.group, g), None


class _SumOverModel(torch.autograd.Function):
    """The sum over the model group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _summed(group, x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherHeads(torch.autograd.Function):
    """Every model rank's heads joined on the feature axis in head order;
    backward the reduce-scatter: the gradients summed, this rank's
    features kept."""

    @staticmethod
    def forward(ctx, x, group, index):
        ctx.group, ctx.index, ctx.width = group, index, x.shape[-1]
        return all_gather(group, _wire(x), dim=-1).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        g = _summed(ctx.group, g).narrow(-1, ctx.index * ctx.width, ctx.width)
        return g.contiguous(), None, None


class _Part(nn.Module):
    """A linear layer's part: its weight (out, in) and bias as given."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias)


class ParallelMLP(nn.Module):
    """A ``KaimingMLP`` over the model group: ``mlp1`` column-parallel,
    ``mlp2`` row-parallel with one sum, in float32 below float32 (each
    partial product of the weight rounded to the activations' dtype), then
    rounded and the whole bias added, as ``linear_at`` rounds."""

    def __init__(self, mlp: nn.Module, mesh: DataMesh):
        super().__init__()
        d = lambda t, dim: _part(t.detach(), dim, mesh)
        self.mlp1 = _Part(d(mlp.mlp1.weight, 0), d(mlp.mlp1.bias, 0))
        self.mlp2 = _Part(d(mlp.mlp2.weight, 1), mlp.mlp2.bias.detach().clone())
        self.group = mesh.model_group

    def forward(self, x):
        h = gelu(linear_at(x, self.mlp1.weight, self.mlp1.bias))
        w2 = self.mlp2.weight.to(h.dtype)
        part = F.linear(h.float(), w2.float()) if h.dtype.itemsize < 4 else F.linear(h, w2)
        return _SumOverModel.apply(part, self.group).to(h.dtype) + self.mlp2.bias.to(h.dtype)


class ParallelPosAtt(nn.Module):
    """``PosAtt`` (``concat``: the residual ``[inputs, conv]``) or
    ``PosAttCross`` over the model group, with the same ``forward``: this
    rank's heads where the model axis divides them, the outputs gathered;
    all heads otherwise, the output then a tensor every rank's MLP reads
    (its gradient summed)."""

    def __init__(self, att: nn.Module, mesh: DataMesh, concat: bool):
        super().__init__()
        self.split = att.lmda.shape[0] % mesh.model == 0
        self.lmda = nn.Parameter(_part(att.lmda.detach(), 0 if self.split else None, mesh).clone())
        self.locality, self.concat = att.locality, concat
        self.group, self.index = mesh.model_group, mesh.model_rank

    def forward(self, dist, inputs, thr=None, mesh_q=None, mesh_k=None, band=None):
        attend = lambda u: _dispatch_posatt(dist, self.lmda, u, self.locality, thr, mesh_q,
                                            mesh_k, band)
        if self.split:
            u = _CopyToModel.apply(inputs, self.group)
            conv = _GatherHeads.apply(attend(u), self.group, self.index)
            return torch.cat([u, conv], dim=-1) if self.concat else conv
        conv = attend(inputs)
        out = torch.cat([inputs, conv], dim=-1) if self.concat else conv
        return _CopyToModel.apply(out, self.group)


def shard_model(model: nn.Module, mesh: DataMesh) -> nn.Module:
    """This rank's part of a whole ``PiT`` (a new module; ``model`` is left
    as it is), its parameters under the whole model's names and in its
    order. ``tensor_parallel_dims`` maps each name to the axis it splits
    along (None: replicated)."""
    dims = param_shardings(mesh, model)  # raises before anything is built
    tp = copy.deepcopy(model)
    tp.down = ParallelPosAtt(model.down, mesh, concat=False)
    tp.en_layer = ParallelMLP(model.en_layer, mesh)
    for i in range(len(model.conv)):
        tp.conv[i] = ParallelPosAtt(model.conv[i], mesh, concat=True)
        tp.mlp[i] = ParallelMLP(model.mlp[i], mesh)
    tp.up = ParallelPosAtt(model.up, mesh, concat=False)
    tp.de = ParallelMLP(model.de, mesh)
    tp.tensor_parallel_dims = dims
    return tp


def _remap_moments(optimizer, params, names, dims, fn) -> dict:
    """``optimizer``'s state dict with every state tensor of a split
    parameter's shape passed through ``fn(tensor, dim)``, in parameter
    order."""
    sd = optimizer.state_dict()
    for i in sorted(sd["state"]):
        dim, shape = dims[names[i]], tuple(params[i].shape)
        sd["state"][i] = {k: fn(v, dim) if dim is not None and torch.is_tensor(v)
                          and tuple(v.shape) == shape else v
                          for k, v in sd["state"][i].items()}
    return sd


def shard_state(mesh: DataMesh, state: TrainState) -> TrainState:
    """This rank's part of a whole ``PiT``'s training state: the model
    (:func:`shard_model`) and an optimizer of the same kind and settings
    over its parameters, holding their slices of the moments."""
    model = shard_model(state.model, mesh)
    names = [n for n, _ in state.model.named_parameters()]
    sd = _remap_moments(state.optimizer, list(state.model.parameters()), names,
                        model.tensor_parallel_dims, lambda t, d: _part(t, d, mesh))
    optimizer = type(state.optimizer)(model.parameters(), **state.optimizer.defaults)
    optimizer.load_state_dict(sd)
    return TrainState(model, optimizer, state.step)


def gather_state_dict(mesh: DataMesh, model: nn.Module) -> dict:
    """The whole model's state dict from every model rank's part (a
    collective of the model group): the one-process layout."""
    dims = model.tensor_parallel_dims
    return {k: t if dims.get(k) is None else all_gather(mesh.model_group, t, dim=dims[k])
            for k, t in model.state_dict().items()}


def gather_state(mesh: DataMesh, state: TrainState, whole: nn.Module) -> TrainState:
    """The one-process training state from every model rank's part: the
    gathered weights loaded into ``whole`` (a ``PiT`` of the same
    configuration) and an optimizer over its parameters holding the
    gathered moments. A collective of the model group."""
    whole.load_state_dict(gather_state_dict(mesh, state.model))
    names = [n for n, _ in state.model.named_parameters()]
    sd = _remap_moments(state.optimizer, list(state.model.parameters()), names,
                        state.model.tensor_parallel_dims,
                        lambda t, d: all_gather(mesh.model_group, t, dim=d))
    optimizer = type(state.optimizer)(whole.parameters(), **state.optimizer.defaults)
    optimizer.load_state_dict(sd)
    return TrainState(whole, optimizer, state.step)
