"""The data-parallel training step with its collectives spelled out (the
JAX package's ``parallel/shard_map_step.py``).

Each rank computes the loss and gradients of its shard of the batch, the
gradients (and the loss) are summed over the data group and then over the
dcn group (:func:`..sharding.all_reduce_grads`), and every rank applies the
same optimizer step and parameter constraint. The train epoch
(``train/loop.py``) runs this same reduction once per optimizer step.
Under a model axis ``task.model`` is this rank's part
(``tensor_parallel.shard_state``), whose forward and backward carry the
model group's collectives; the gradient sum runs among the ranks of this
rank's model index.
"""

from __future__ import annotations

import torch

from position_induced_transformer_torch.parallel.sharding import (
    DataMesh,
    all_reduce_grads,
    shard_batch,
)
from position_induced_transformer_torch.train.loop import Task, TrainState


def make_shard_map_train_step(task: Task, optimizer: torch.optim.Optimizer, mesh: DataMesh):
    """``step(state, geom, batch) -> (state, loss)``: ``batch`` is this
    rank's shard (:func:`shard_batch_arrays`), ``optimizer`` the optimizer
    of ``task.model`` (``state.optimizer``), at the learning rate it holds.
    ``loss`` is the loss of the global batch, the same on every rank."""

    def step(state: TrainState, geom, batch):
        model = state.model
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss = task.loss_fn(geom, batch)
        loss.backward()
        loss = all_reduce_grads(mesh, list(model.parameters()), loss, task.batch_mean_loss)
        optimizer.step()
        if task.param_constraint is not None:
            with torch.no_grad():
                task.param_constraint(model)
        state.step += 1
        return state, loss

    return step


def shard_batch_arrays(mesh: DataMesh, batch: dict) -> dict:
    """This rank's shard of a batch dict: rows ``[r B / n, (r + 1) B / n)``
    of every variable (:func:`..sharding.shard_batch`)."""
    return shard_batch(mesh, batch)
