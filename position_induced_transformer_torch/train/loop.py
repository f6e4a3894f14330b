"""Training and evaluation loops (the JAX package's ``train/loop.py``).

A :class:`Task` binds a model to its loss conventions. One training step
is: gather a batch on the device, forward, batch-summed relative-Lp loss,
backward, Adam with the learning rate of a per-step cosine schedule. The
JAX package runs a whole epoch as one jitted ``lax.scan``; here an epoch
is a Python loop over the rows of a (n_batches, B) index matrix, with the
dataset already on the device and the losses kept there until the caller
reads them.

The schedule is a plain function of the step count, matching
``optax.cosine_decay_schedule`` (and its warmup head) in closed form; the
loop sets each step's learning rate from it. ``torch.optim``'s
``CosineAnnealingLR`` is not used: its recursive update drifts from the
closed form.

Ported: non-rollout tasks and the ``adam`` optimizer. Rollout training
and the keras Adam of the TF family raise "not ported".
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from position_induced_transformer_torch.ops.metrics import rel_lp_norm


@dataclasses.dataclass
class TrainState:
    """The model being trained (the same module as ``Task.model``), its
    optimizer, and the number of optimizer steps taken."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


@dataclasses.dataclass(frozen=True)
class Task:
    model: Any  # nn.Module with forward(geom, x)
    loss_p: int = 2
    out_dim: int = 1
    swap_loss_args: bool = False  # vorticity/cylinder pass (pred, true)
    postprocess: Optional[Callable] = None  # e.g. a denormalizer
    rollout_steps: int = 0
    batch_mean_loss: bool = False  # TF loss convention: mean over batch

    def forward(self, geom, batch):
        out = self.model(geom, batch["x"])
        if self.postprocess is not None:
            out = self.postprocess(out)
        return out

    def _loss(self, true, pred, weights=None):
        """Batch-summed relative-Lp loss; ``weights`` masks padded eval
        duplicates. The one place the swap and batch-mean conventions live.
        """
        if self.swap_loss_args:
            true, pred = pred, true
        loss = rel_lp_norm(true, pred, self.out_dim, self.loss_p, weights=weights)
        if self.batch_mean_loss:
            # mean over the valid samples of a padded eval tail batch
            denom = true.shape[0] if weights is None else weights.sum()
            loss = loss / denom
        return loss

    def loss_fn(self, geom, batch):
        """Batch-summed training loss (divide by the sample count outside)."""
        if self.rollout_steps:
            raise NotImplementedError(
                "rollout training is not ported yet (it lands with the other "
                "fixed-mesh benchmarks)"
            )
        return self._loss(batch["y"], self.forward(geom, batch))


def make_lr_schedule(
    lr: float, total_steps: int, eta_min: float = 0.0, warmup_steps: int = 0
) -> Callable[[int], float]:
    """Per-step cosine decay from ``lr`` to ``eta_min`` over ``total_steps``
    (the step clamped there), with an optional linear 0 -> lr warmup head
    over which the cosine then runs on the remaining steps: the closed form
    of ``optax.cosine_decay_schedule`` and ``optax.join_schedules``."""
    alpha = eta_min / lr if lr else 0.0

    def cosine(step: int, decay_steps: int) -> float:
        if decay_steps <= 0:
            raise ValueError(f"the cosine decay needs positive steps, got {decay_steps}")
        t = min(step, decay_steps)
        return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay_steps)) + alpha)

    def schedule(step: int) -> float:
        if not warmup_steps:
            return cosine(step, total_steps)
        if step < warmup_steps:
            return lr * step / warmup_steps
        return cosine(step - warmup_steps, max(total_steps - warmup_steps, 1))

    return schedule


def make_optimizer(params, lr: float, flavor: str = "adam") -> torch.optim.Optimizer:
    """Adam with optax's (and torch's) epsilon, 1e-8, outside the bias
    correction's root. Its learning rate is set per step from
    :func:`make_lr_schedule` by the train epoch."""
    if flavor == "keras":
        raise NotImplementedError(
            "the keras Adam of the TF family is not ported yet"
        )
    if flavor != "adam":
        raise ValueError(f"unknown optimizer flavor {flavor!r}")
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _gather(data, idx):
    return {k: v[idx] for k, v in data.items()}


def make_train_epoch(task: Task, schedule: Callable[[int], float], grad_accum: int = 1):
    """``train_epoch(state, geom, data, perm) -> (state, losses)``: one
    optimizer step per row of the (n_batches, B) index matrix ``perm``;
    ``data`` maps names to tensors on the model's device. ``losses`` holds
    each step's batch-summed loss on the device (the JAX epoch returns
    their sum), so the loop never waits for the device.

    ``grad_accum`` splits every batch into that many sequential
    microbatches whose gradients add up before the one optimizer step:
    batch-summed losses add, ``batch_mean_loss`` tasks average (equal
    microbatch sizes). The reported loss keeps the unsplit convention.
    """
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def train_epoch(state: TrainState, geom, data, perm):
        model, opt = state.model, state.optimizer
        model.train()
        losses = []
        for idx in perm:
            for group in opt.param_groups:
                group["lr"] = schedule(state.step)
            opt.zero_grad(set_to_none=True)
            loss = 0.0
            for midx in idx.reshape(grad_accum, -1):
                micro = task.loss_fn(geom, _gather(data, midx))
                if task.batch_mean_loss:
                    micro = micro / grad_accum
                micro.backward()
                loss = loss + micro.detach()
            opt.step()
            state.step += 1
            losses.append(loss)
        return state, torch.stack(losses)

    return train_epoch


def make_eval_epoch(task: Task, metrics: Optional[dict] = None):
    """``eval_epoch(geom, data, perm, n_valid=None) -> {name: sum}`` under
    ``torch.inference_mode``. ``metrics`` maps names to
    ``fn(true, pred, weights=...)`` with batch-summed outputs; the default
    is the task loss (batch-summed even for ``batch_mean_loss`` tasks).
    Positions of ``perm`` at or past ``n_valid`` (default: the dataset
    size) are the padded tail of :func:`eval_permutation` and weigh 0.
    Sums stay on the device."""

    def eval_epoch(geom, data, perm, n_valid=None):
        if task.rollout_steps:
            raise NotImplementedError("rollout evaluation is not ported yet")
        if n_valid is None:
            n_valid = next(iter(data.values())).shape[0]
        task.model.eval()
        wts = (torch.arange(perm.numel(), device=perm.device) < n_valid)
        wts = wts.to(torch.float32).reshape(perm.shape)
        sums: dict = {}
        with torch.inference_mode():
            for idx, w in zip(perm, wts):
                batch = _gather(data, idx)
                pred = task.forward(geom, batch)
                if metrics is None:
                    loss = task._loss(batch["y"], pred, weights=w)
                    if task.batch_mean_loss:
                        loss = loss * w.sum()
                    vals = {"loss": loss}
                else:
                    vals = {n: fn(batch["y"], pred, weights=w) for n, fn in metrics.items()}
                for n, v in vals.items():
                    sums[n] = sums[n] + v if n in sums else v
        return sums

    return eval_epoch


def epoch_permutation(seed: int, epoch: int, n: int, batch_size: int) -> torch.Tensor:
    """Shuffled (n_batches, batch_size) index matrix from a
    ``torch.Generator`` seeded from (seed, epoch), so a resumed run replays
    the same shuffles; drops the remainder like ``ntrain // batch``. (Not
    the JAX PRNG's permutation: parity tests hand both sides one matrix.)"""
    # the CPU generator keeps 32 bits of its seed: mix (seed, epoch) into them
    mixed = int(np.random.SeedSequence([seed, epoch]).generate_state(1)[0])
    gen = torch.Generator().manual_seed(mixed)
    n_batches = n // batch_size
    perm = torch.randperm(n, generator=gen)[: n_batches * batch_size]
    return perm.reshape(n_batches, batch_size)


def eval_permutation(n: int, batch_size: int) -> torch.Tensor:
    """Sequential (ceil(n/batch), batch) index matrix covering all ``n``
    samples; the final partial batch repeats the last index (masked out by
    ``n_valid``)."""
    n_batches = -(-n // batch_size)
    return torch.clamp(torch.arange(n_batches * batch_size), max=n - 1).reshape(
        n_batches, batch_size
    )
