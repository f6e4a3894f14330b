"""Pipeline parallelism: the GPipe stage split of the PiT processor (the
JAX package's ``parallel/pipeline.py``) on ``torch.distributed``.

The processor's ``n_blocks`` blocks split into ``K`` contiguous stages of
``n_blocks / K``; rank s of a ``stage=K`` world holds stage s's blocks
``[s k, (s + 1) k)`` (:func:`stack_processor_params`). A batch splits into
micro-batches that stream through the stages GPipe-style: stage 0 takes
them from its encoder's output, each stage sends its output on to the next
by a point-to-point send over the stage group, and the last stage's output
reaches every rank by one broadcast (JAX's masked ``psum``). The encoder,
the decoder, instance norm and ``residual_output`` are replicated: every
rank runs them on the whole batch, as :func:`make_pipelined_apply` mirrors
``PiT.forward``.

Gradients flow back through the schedule (:class:`_Pipeline`): the last
stage's gradient of each micro-batch goes back stage by stage, each stage
accumulating its blocks' gradients, and stage 0's gradient of the
processor input reaches every rank's encoder by one broadcast. So every
rank computes the same gradients of the replicated parameters and its own
stage's of the blocks; the blocks of other stages keep no gradient and no
optimizer step, and :func:`sync_stages` brings every rank the whole model
(and its moments) from the stages that own them, before a checkpoint.

Gloo's ``send``, ``recv`` and ``all_gather`` take CPU tensors only: a CUDA
tensor of a gloo group goes through host memory, a choice by the group's
backend (NCCL takes it directly).

For the torch family's fixed meshes only: the TF family and per-sample
geometries are refused (:func:`enable_pipeline`).
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Optional

import torch
import torch.distributed as dist

from position_induced_transformer_torch.models.pit import gelu
from position_induced_transformer_torch.ops.normalization import instance_norm
from position_induced_transformer_torch.parallel.sharding import StageMesh


def make_stage_mesh(n_stages: int) -> StageMesh:
    """The 1-D ``stage`` mesh over the default process group, which must
    hold exactly ``n_stages`` ranks (a world of one: one stage, no
    group)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_stages:
        raise ValueError(
            f"stage mesh needs {n_stages} devices but only {world} are available "
            "(the world size of the default process group)"
        )
    if not dist.is_initialized():
        return StageMesh(n_stages)
    return StageMesh(n_stages, dist.get_rank(), dist.group.WORLD)


def stack_processor_params(model, n_blocks: int, n_stages: int, stage: int):
    """Stage ``stage``'s processor blocks of ``model``, ``(conv, mlp)``
    pairs ``[stage k, (stage + 1) k)`` with ``k = n_blocks / n_stages``;
    a block count the stages do not divide raises."""
    k, rem = divmod(n_blocks, n_stages)
    if rem:
        raise ValueError(f"n_blocks={n_blocks} not divisible by n_stages={n_stages}")
    return [(model.conv[i], model.mlp[i]) for i in range(stage * k, (stage + 1) * k)]


def _stage_apply(blocks, geom, f):
    """One stage's blocks: global self position attention (concat
    residual) -> MLP -> GELU, as ``PiT.processor``."""
    for a, w in blocks:
        f = a(geom.dist_proc, f, mesh_q=geom.mesh_ltt, mesh_k=geom.mesh_ltt)
        f = gelu(w(f))
    return f


def _on_host(group, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _wire(t: torch.Tensor) -> torch.Tensor:
    return t.float() if t.dtype.itemsize < 4 else t


def _send(group, t: torch.Tensor, dst: int) -> None:
    t = _wire(t.detach()).contiguous()
    dist.send(t.cpu() if _on_host(group, t) else t, dst=dst, group=group)


def _recv(group, like: torch.Tensor, src: int) -> torch.Tensor:
    buf = torch.empty(like.shape, dtype=_wire(like).dtype,
                      device="cpu" if _on_host(group, like) else like.device)
    dist.recv(buf, src=src, group=group)
    return buf.to(device=like.device, dtype=like.dtype)


def _broadcast(group, t: torch.Tensor, src: int) -> torch.Tensor:
    buf = _wire(t.detach()).contiguous().clone()
    if group is not None:
        dist.broadcast(buf, src=src, group=group)
    return buf.to(t.dtype)


class _Schedule:
    """One pipelined processor call: stage ``mesh.rank``'s blocks over
    ``n_micro`` micro-batches, keeping each micro-batch's input and output
    (and, under autograd, their graph) for the backward."""

    def __init__(self, mesh: StageMesh, blocks, geom, n_micro: int):
        self.mesh, self.blocks, self.geom, self.n_micro = mesh, blocks, geom, n_micro
        self.first, self.last = mesh.rank == 0, mesh.rank == mesh.stage - 1

    def forward(self, f: torch.Tensor, grad: bool) -> torch.Tensor:
        g, s = self.mesh.group, self.mesh.rank
        self.xs, self.ys = [], []
        for micro in f.detach().chunk(self.n_micro):
            x = micro if self.first else _recv(g, micro, s - 1)
            if grad:
                x = x.detach().requires_grad_()
            y = _stage_apply(self.blocks, self.geom, x)
            if not self.last:
                _send(g, y, s + 1)
            self.xs.append(x)
            self.ys.append(y)
        out = torch.cat([y.detach() for y in self.ys]) if self.last else f.detach()
        return _broadcast(g, out, self.mesh.stage - 1)

    def backward(self, grad_out: torch.Tensor) -> torch.Tensor:
        g, s = self.mesh.group, self.mesh.rank
        gouts = grad_out.chunk(self.n_micro)
        gins = [None] * self.n_micro
        for i in reversed(range(self.n_micro)):
            gy = gouts[i] if self.last else _recv(g, self.ys[i], s + 1)
            torch.autograd.backward(self.ys[i], gy)
            if self.first:
                gins[i] = self.xs[i].grad
            else:
                _send(g, self.xs[i].grad, s - 1)
        self.xs = self.ys = None
        grad_f = torch.cat(gins) if self.first else grad_out
        return _broadcast(g, grad_f, 0)


def _keep(t):
    return t


class _Pipeline(torch.autograd.Function):
    """The pipelined processor under autograd: forward the schedule,
    building each micro-batch's graph of this stage's blocks; backward the
    gradients back through the stages (each stage's block gradients
    accumulating), stage 0's gradient of the input broadcast to every
    rank."""

    @staticmethod
    def forward(ctx, f, schedule):
        ctx.schedule = schedule
        # the stage's graphs keep their own tensors: an enclosing
        # torch.utils.checkpoint (a rollout step) recomputes the whole
        # forward at the start of its backward on every rank alike, never
        # at the first use of one stage's tensor
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(_keep, _keep):
            return schedule.forward(f, grad=True)

    @staticmethod
    def backward(ctx, grad_out):
        return ctx.schedule.backward(grad_out), None


def pipeline_processor(mesh: StageMesh, blocks, geom, f: torch.Tensor,
                       n_micro: int) -> torch.Tensor:
    """The GPipe processor over ``mesh``'s stages: ``f`` (B, L_ltt, hid),
    the same on every rank, with B divisible by ``n_micro``; ``blocks``
    this rank's stage (:func:`stack_processor_params`). Every rank returns
    the last stage's output."""
    B = f.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by n_micro={n_micro}")
    schedule = _Schedule(mesh, blocks, geom, n_micro)
    if torch.is_grad_enabled() and f.requires_grad:
        return _Pipeline.apply(f, schedule)
    return schedule.forward(f, grad=False)


def make_pipelined_apply(model, mesh: StageMesh, n_micro: int):
    """``apply(model, geom, x) -> out``: the whole PiT forward with the
    processor pipelined over ``mesh``'s stages (encoder and decoder
    replicated). It mirrors ``PiT.forward`` (instance norm placement, the
    float32 output, ``residual_output``): a composition flag added there
    must be mirrored here."""
    blocks = stack_processor_params(model, len(model.conv), mesh.stage, mesh.rank)

    def apply(model, geom, x):
        if getattr(geom, "dist_proc", None) is None:
            raise ValueError(
                "pipeline parallelism requires a materialized fixed-mesh "
                "geometry (geom.dist_proc is None — lazy/per-sample-mesh "
                "geometries are not supported)"
            )
        f = model.encoder(geom, x)
        if model.use_instance_norm:
            f = instance_norm(f)
        f = pipeline_processor(mesh, blocks, geom, f, n_micro)
        if model.use_instance_norm:
            f = instance_norm(f)
        out = model.decoder(geom, f)
        out = out.float() if out.dtype.itemsize < 4 else out
        if model.residual_output:
            out = out + x
        return out

    return apply


def pipeline_task(task, mesh: StageMesh, n_micro: int):
    """``task`` with its forward's processor pipelined over ``mesh``'s
    stages (``apply_fn``; ``pp_micro`` the micro-batch count): the train
    epoch, eval epoch and prediction run it unchanged."""
    apply = make_pipelined_apply(task.model, mesh, n_micro)
    return dataclasses.replace(
        task, apply_fn=lambda model, g, b: apply(model, g, b["x"]), pp_micro=n_micro
    )


def _pick_n_micro(batch_size: int, n_stages: int) -> int:
    """The GPipe schedule's micro-batch count: ``n_stages`` where it
    divides the batch, else the largest divisor of the batch in [2,
    n_stages]; failing that one, with a warning (the stages then run
    strictly one after another). ``PIT_PP_MICRO`` overrides it (the JAX
    package's knob)."""
    env = os.environ.get("PIT_PP_MICRO")
    if env:
        return int(env)
    if batch_size <= 1:
        return 1
    if batch_size % n_stages == 0:
        return n_stages
    for m in range(min(batch_size, n_stages), 1, -1):
        if batch_size % m == 0:
            return m
    warnings.warn(
        f"pipeline batch {batch_size} has no divisor in [2, {n_stages}]; "
        "the GPipe schedule runs with ONE microbatch (stages strictly "
        "sequential — expect no speedup). Pick a batch size divisible "
        "by the stage count.",
        stacklevel=3,
    )
    return 1


def enable_pipeline(problem, mesh: StageMesh, batch_size: int = 0) -> int:
    """Switch a problem onto the GPipe pipeline (a ``stage=K`` mesh): the
    one place the runner, ``evaluate`` and ``Predictor`` share. Swaps
    ``problem.task`` for the pipelined one (:func:`pipeline_task`), with
    the micro-batch count picked from ``batch_size``
    (:func:`_pick_n_micro`), and returns that count; callers then treat
    the batch as unsharded. The TF family and per-sample geometries raise
    ``ValueError``."""
    if getattr(problem.task, "pp_micro", 0):
        raise ValueError(
            "this problem is already pipeline-parallel (enable_pipeline "
            "was called on it before); build a fresh Problem to change "
            "the stage mesh"
        )
    if problem.task.apply_fn is not None or problem.task.geom_fn is not None:
        raise ValueError(
            "pipeline parallelism ('stage=K') supports the torch-family "
            "fixed-mesh PiT benchmarks only (the TF-semantics call "
            "signature and per-sample-mesh geometries are not stage-"
            "splittable)"
        )
    n_micro = _pick_n_micro(batch_size, mesh.stage)
    problem.task = pipeline_task(problem.task, mesh, n_micro)
    return n_micro


def sync_stages(mesh: StageMesh, model, optimizer: Optional[torch.optim.Optimizer] = None):
    """Every rank's ``model`` (and ``optimizer``'s state of its
    parameters) made whole: each processor block broadcast from the stage
    that owns it. A collective of the stage group; nothing to do in a
    world of one."""
    if mesh.group is None:
        return
    n_blocks = len(model.conv)
    k = n_blocks // mesh.stage
    params = list(model.parameters())
    index = {id(p): i for i, p in enumerate(params)}
    for owner in range(mesh.stage):
        owned = [p for i in range(owner * k, (owner + 1) * k)
                 for m in (model.conv[i], model.mlp[i]) for p in m.parameters()]
        with torch.no_grad():
            for p in owned:
                p.copy_(_broadcast(mesh.group, p, owner))
        if optimizer is None:
            continue
        box = [{index[id(p)]: {n: v.cpu() if torch.is_tensor(v) else v
                               for n, v in optimizer.state[p].items()}
                for p in owned if p in optimizer.state}] if mesh.rank == owner else [None]
        dist.broadcast_object_list(box, src=owner, group=mesh.group)
        if mesh.rank != owner:
            for i, st in box[0].items():
                p = params[i]
                optimizer.state[p] = {n: v.to(p.device) if torch.is_tensor(v) and v.ndim else v
                                      for n, v in st.items()}
