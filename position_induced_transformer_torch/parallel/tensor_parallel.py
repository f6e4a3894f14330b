"""Tensor parallelism over the model axis for both families (the torch
family's ``PiT``; the TF family's ``PiTTF``, ``PiTTFPointCloud`` and their
``lite`` / ``transformer`` / ``selfpit`` variants): the
counterpart of the JAX package's ``_param_pspec``, ``param_shardings`` and
``shard_state`` (``parallel/sharding.py``), whose collectives GSPMD writes
there and this module spells out.

A rank of model index m of M holds:

- each two-layer MLP (``KaimingMLP``: ``en_layer``, ``mlp.<i>``, ``de``;
  ``TFMlp``: ``MLP_<i>``, ``mlp``, ``mlp1``, ``mlp2``, ``de_layer``)
  column- then row-parallel: rows ``[m h / M, (m + 1) h / M)`` of
  ``mlp1``'s weight and bias (its output features), the same columns of
  ``mlp2``'s weight (its input features) and ``mlp2``'s whole bias, added
  once after the sum of the partial products over the model group;
- except where JAX's rule, which tests ``mlp1`` in a leaf's path before
  ``mlp2``, splits an MLP's ``mlp2`` by its output features too: the MLP
  named ``mlp1`` (``PiTTFPointCloud``'s encoder), whose hidden features and
  outputs are gathered over the group;
- each ``PosAtt`` / ``PosAttCross`` bandwidth's heads ``[m H / M, (m + 1)
  H / M)`` where M divides the head count (the attention runs on those
  heads and the outputs are gathered over the group in head order), and
  all heads otherwise;
- everything else whole: in the TF family every attention op (its
  ``band_width``, ``weight``, ``query``, ``key``, ``value``) and every
  plain ``TFDense`` (``en_layer``, ``W_<i>``, ``w``, ``w1``, ``w2``), so
  every model rank computes every head of every attention op;
- its optimizer's moments split as its parameters are.

An MLP width that M does not divide raises the JAX package's
``ValueError``; nothing falls back to a replicated MLP.

The collectives are ``torch.autograd.Function``s, each forward with its
adjoint: :class:`_CopyToModel` (identity; the gradients summed),
:class:`_SumOverModel` (the sum; identity), :class:`_GatherHeads` (an
all-gather on the feature axis; a reduce-scatter) and
:class:`_GatherWhole` (the same all-gather; this rank's slice of a
gradient every rank holds whole). In ``PiT`` a gradient that reaches a
tensor every model rank uses (the residual ``u`` of a processor block, the
gathered head outputs) is summed over the group exactly once, after each
attention op. The TF family adds a replicated ``Dense`` beside every MLP
(``MLP_<i>(PA(x)) + W_<i>(x)``), so there every replicated tensor carries
its whole gradient: each MLP sums its input's gradient
(:class:`_CopyToModel`) and its output's forward, and every replicated
parameter takes the same update on every model rank.
"""

from __future__ import annotations

import copy
import inspect

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from position_induced_transformer_torch.models.pit import PiT, _dispatch_posatt, gelu, linear_at
from position_induced_transformer_torch.models.pit_tf import TFMlp
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


def param_shardings(mesh: DataMesh, model: nn.Module) -> dict:
    """Each parameter name of a whole model of either family -> the axis
    it splits along over ``mesh``'s model axis, or None where it is
    replicated. Raises as :func:`shard_model` does."""
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


class _GatherWhole(torch.autograd.Function):
    """Every model rank's features joined on the feature axis in rank
    order, as :class:`_GatherHeads`; backward this rank's features of the
    gradient, which every rank holds whole (the TF family's convention)."""

    @staticmethod
    def forward(ctx, x, group, index):
        ctx.index, ctx.width = index, x.shape[-1]
        return all_gather(group, _wire(x), dim=-1).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.index * ctx.width, ctx.width).contiguous(), None, None


class _Part(nn.Module):
    """A linear layer's part: its weight (out, in) and bias as given."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias)


class ParallelMLP(nn.Module):
    """A ``KaimingMLP`` or ``TFMlp`` over the model group: ``mlp1``
    column-parallel, the GELU on this rank's slice, then ``mlp2``
    row-parallel with one sum, in float32 below float32 (each partial
    product of the weight rounded to the activations' dtype), then rounded
    and the whole bias added, as ``linear_at`` rounds.

    ``gathered``: ``mlp2`` column-parallel too (JAX's layout for the MLP
    named ``mlp1``): the hidden features gathered (their gradient
    reduce-scattered), this rank's output features computed with its slice
    of the bias, and the outputs gathered. ``copy_in``: the input's
    gradient summed over the group here (the TF family's convention, in
    which every replicated tensor carries its whole gradient)."""

    def __init__(self, mlp: nn.Module, mesh: DataMesh, copy_in: bool = False,
                 gathered: bool = False):
        super().__init__()
        d = lambda t, dim: _part(t.detach(), dim, mesh)
        self.mlp1 = _Part(d(mlp.mlp1.weight, 0), d(mlp.mlp1.bias, 0))
        if gathered:
            self.mlp2 = _Part(d(mlp.mlp2.weight, 0), d(mlp.mlp2.bias, 0))
        else:
            self.mlp2 = _Part(d(mlp.mlp2.weight, 1), mlp.mlp2.bias.detach().clone())
        self.group, self.index = mesh.model_group, mesh.model_rank
        self.copy_in, self.gathered = copy_in, gathered

    def forward(self, x):
        if self.copy_in:
            x = _CopyToModel.apply(x, self.group)
        h = gelu(linear_at(x, self.mlp1.weight, self.mlp1.bias))
        if self.gathered:
            h = _GatherHeads.apply(h, self.group, self.index)
            out = linear_at(h, self.mlp2.weight, self.mlp2.bias)
            return _GatherWhole.apply(out, self.group, self.index)
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
    """This rank's part of a whole model of either family (a new module;
    ``model`` is left as it is), its parameters under the whole model's
    names and in its order. ``tensor_parallel_dims`` maps each name to the
    axis it splits along (None: replicated). In a ``PiT`` the MLPs and the
    attention ops become parts; in the TF family each ``TFMlp`` does, and
    the rest stays whole."""
    dims = param_shardings(mesh, model)  # raises before anything is built
    tp = copy.deepcopy(model)
    if isinstance(model, PiT):
        tp.down = ParallelPosAtt(model.down, mesh, concat=False)
        tp.en_layer = ParallelMLP(model.en_layer, mesh)
        for i in range(len(model.conv)):
            tp.conv[i] = ParallelPosAtt(model.conv[i], mesh, concat=True)
            tp.mlp[i] = ParallelMLP(model.mlp[i], mesh)
        tp.up = ParallelPosAtt(model.up, mesh, concat=False)
        tp.de = ParallelMLP(model.de, mesh)
    else:
        for name, mlp in model.named_modules():
            if isinstance(mlp, TFMlp):
                parent, _, leaf = name.rpartition(".")
                setattr(tp.get_submodule(parent), leaf, ParallelMLP(
                    mlp, mesh, copy_in=True, gathered=dims[f"{name}.mlp2.weight"] == 0))
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


def _same_kind(optimizer, params):
    """An optimizer of ``optimizer``'s kind and settings over ``params``,
    from the defaults its constructor takes (``load_state_dict`` adds
    torch's own, which ``KerasAdam`` does not take)."""
    takes = inspect.signature(type(optimizer)).parameters
    return type(optimizer)(params, **{k: v for k, v in optimizer.defaults.items() if k in takes})


def shard_state(mesh: DataMesh, state: TrainState) -> TrainState:
    """This rank's part of a whole model's training state: the model
    (:func:`shard_model`) and an optimizer of the same kind and settings
    over its parameters, holding their slices of the moments."""
    model = shard_model(state.model, mesh)
    names = [n for n, _ in state.model.named_parameters()]
    sd = _remap_moments(state.optimizer, list(state.model.parameters()), names,
                        model.tensor_parallel_dims, lambda t, d: _part(t, d, mesh))
    optimizer = _same_kind(state.optimizer, model.parameters())
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
    gathered weights loaded into ``whole`` (a model of the same
    configuration) and an optimizer over its parameters holding the
    gathered moments. A collective of the model group."""
    whole.load_state_dict(gather_state_dict(mesh, state.model))
    names = [n for n, _ in state.model.named_parameters()]
    sd = _remap_moments(state.optimizer, list(state.model.parameters()), names,
                        state.model.tensor_parallel_dims,
                        lambda t, d: all_gather(mesh.model_group, t, dim=d))
    optimizer = _same_kind(state.optimizer, whole.parameters())
    optimizer.load_state_dict(sd)
    return TrainState(whole, optimizer, state.step)
