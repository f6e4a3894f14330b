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

Autoregressive tasks (``rollout_steps > 0``: vorticity) train by
backpropagation through the whole unrolled rollout, each rollout step's
forward checkpointed by ``torch.utils.checkpoint`` as ``Task.remat_rollout``
says. The optimizers: ``adam`` and the keras Adam of the TF family
(:class:`KerasAdam`).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Callable, Optional

import numpy as np
import torch

from position_induced_transformer_torch.ops.metrics import rel_lp_norm
from position_induced_transformer_torch.utils import profiling

_REMAT_MODES = {True: "full", "full": "full", "1": "full", "true": "full",
                "dots": "dots",
                False: "none", "none": "none", "0": "none", "false": "none"}


def _dots_saveable():
    """Selective checkpointing that keeps the outputs of the matmuls
    (``aten.mm``, ``aten.addmm``, ``aten.bmm``) and recomputes everything
    else, the counterpart of ``jax.checkpoint_policies.dots_saveable``. A
    kernel launched through ctypes is no aten op: its output is recomputed,
    as a Pallas output is under ``dots_saveable``."""
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    saved = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default}

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)


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
    geom_fn: Optional[Callable] = None  # batch -> Geometry (per-sample meshes)
    # the batch variables geom_fn cannot do without (a deployment input
    # must carry them); None = found by probing geom_fn, which reads
    # required keys as batch[k] and optional ones as batch.get(k)
    geometry_required_keys: Optional[tuple] = None
    # (model, geom, batch) -> out, in place of model(geom, x): the TF
    # family's call takes x, thr_en, thr_de, band_en, band_de; it gets the
    # batch's x only, as a deployment input carries no more
    apply_fn: Optional[Callable] = None
    keras_adam: bool = False  # train with KerasAdam (make_optimizer "keras")
    # BPTT memory against recompute, per rollout step: True / "full"
    # checkpoints the step's forward and recomputes all of it in the
    # backward; "dots" keeps the matmul outputs and recomputes the rest;
    # False / "none" keeps every activation. PIT_ROLLOUT_REMAT overrides it
    remat_rollout: Any = True
    # the TF rollout convention: one loss over the trajectory, the mean over
    # steps of the stepwise error (else the per-step losses are summed)
    trajectory_loss: bool = False

    def _geometry(self, geom, batch):
        return self.geom_fn(batch) if self.geom_fn is not None else geom

    def _apply(self, geom, x):
        if self.apply_fn is not None:
            return self.apply_fn(self.model, geom, {"x": x})
        return self.model(geom, x)

    def forward(self, geom, batch):
        out = self._apply(self._geometry(geom, batch), batch["x"])
        if self.postprocess is not None:
            out = self.postprocess(out)
        return out

    def remat_mode(self) -> str:
        """``"full"``, ``"dots"`` or ``"none"``, from ``PIT_ROLLOUT_REMAT``
        when it is set, else from ``remat_rollout``; any other value raises
        ``ValueError``."""
        mode = os.environ.get("PIT_ROLLOUT_REMAT") or self.remat_rollout
        try:
            return _REMAT_MODES[mode]
        except (KeyError, TypeError):
            raise ValueError(
                f"unrecognized PIT_ROLLOUT_REMAT/remat_rollout value "
                f"{mode!r}; expected full|dots|none (a typo here would "
                "silently store all BPTT activations)"
            ) from None

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

    def rollout_preds(self, geom, batch):
        """The unrolled autoregressive predictions, through which gradients
        flow: ``rollout_steps`` forwards, each fed the window of the last
        ``memory`` frames with its predecessor's output appended, laid out
        as ``batch["y"]``. Under autograd each step's forward is
        checkpointed as :meth:`remat_mode` says (``torch.utils.checkpoint``,
        non-reentrant); ``postprocess`` applies to each step's output, which
        is both fed back and scored. The JAX package's ``PIT_ROLLOUT_UNROLL``
        (the unroll factor of its rollout scan) has no counterpart in this
        eager loop."""
        from torch.utils.checkpoint import checkpoint

        g = self._geometry(geom, batch)
        mode = self.remat_mode()
        apply = lambda w: self._apply(g, w)
        if torch.is_grad_enabled() and mode != "none":
            kw = {"context_fn": _dots_saveable} if mode == "dots" else {}
            step = lambda w: checkpoint(apply, w, use_reentrant=False, **kw)
        else:
            step = apply
        window, outs = batch["x"], []
        for _ in range(self.rollout_steps):
            out = step(window)
            if self.postprocess is not None:
                out = self.postprocess(out)
            window = torch.cat([window[..., 1:], out], dim=-1)
            outs.append(out)
        return torch.stack(outs, dim=-1).reshape(batch["y"].shape)

    def stepwise_rel(self, y, pred, swap: bool = False):
        """The per-sample per-step relative Lp error (B, steps) of (B, ...,
        steps) trajectories; ``swap`` normalises by the prediction (the
        reference's (pred, true) argument order)."""
        b, s = y.shape[0], y.shape[-1]
        t, q = y.reshape(b, -1, s), pred.reshape(b, -1, s)
        if swap:
            t, q = q, t
        if self.loss_p == 1:
            return (t - q).abs().sum(dim=1) / t.abs().sum(dim=1)
        if self.loss_p == 2:
            return torch.linalg.vector_norm(t - q, dim=1) / torch.linalg.vector_norm(t, dim=1)
        p = float(self.loss_p)
        num = ((t - q).abs() ** p).sum(dim=1) ** (1.0 / p)
        return num / (t.abs() ** p).sum(dim=1) ** (1.0 / p)

    def loss_fn(self, geom, batch):
        """Batch-summed training loss (divide by the sample count outside).
        A rollout task sums its per-step losses (the torch convention), or
        with ``trajectory_loss`` takes their mean over the steps."""
        if not self.rollout_steps:
            return self._loss(batch["y"], self.forward(geom, batch))
        pred = self.rollout_preds(geom, batch)
        rel = self.stepwise_rel(batch["y"], pred, swap=self.swap_loss_args)
        loss = rel.mean(dim=-1).sum() if self.trajectory_loss else rel.sum()
        if self.batch_mean_loss:
            loss = loss / rel.shape[0]
        return loss

    def rollout(self, geom, x, steps: int):
        """Autoregressive prediction from the windows ``x``: (B, L,
        out_dim, steps), each step's output stacked on a last axis. A
        rollout task feeds the window back; a one-step residual model
        (cylinder: as many outputs as inputs) takes its output as the next
        input."""
        g = self._geometry(geom, {"x": x})
        window, outs = x, []
        for _ in range(steps):
            out = self._apply(g, window)
            if self.postprocess is not None:
                out = self.postprocess(out)
            if self.rollout_steps or window.shape[-1] > out.shape[-1]:
                window = torch.cat([window[..., 1:], out], dim=-1)
            else:
                window = out
            outs.append(out)
        return torch.stack(outs, dim=-1)


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


class KerasAdam(torch.optim.Optimizer):
    """``tf.keras.optimizers.Adam``'s update, as the JAX package's
    ``_keras_adam``: with ``t`` the steps taken before this one,

        m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
        p -= lr * sqrt(1 - b2^(t+1)) / (1 - b1^(t+1)) * m / (sqrt(v) + eps)

    epsilon (1e-7) outside the root of the *uncorrected* v, where torch's
    Adam adds it to the corrected root. The train epoch sets ``lr`` to the
    schedule's value at ``t`` before each step, as keras reads its decayed
    rate at the pre-increment count."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                if not self.state[p]:
                    self.state[p] = {"step": 0, "exp_avg": torch.zeros_like(p),
                                     "exp_avg_sq": torch.zeros_like(p)}
            states = [self.state[p] for p in params]
            t = states[0]["step"] + 1
            grads = [p.grad for p in params]
            ms = [s["exp_avg"] for s in states]
            vs = [s["exp_avg_sq"] for s in states]
            torch._foreach_mul_(ms, b1)
            torch._foreach_add_(ms, grads, alpha=1.0 - b1)
            torch._foreach_mul_(vs, b2)
            torch._foreach_addcmul_(vs, grads, grads, value=1.0 - b2)
            denom = torch._foreach_sqrt(vs)
            torch._foreach_add_(denom, group["eps"])
            lr_t = group["lr"] * math.sqrt(1.0 - b2**t) / (1.0 - b1**t)
            torch._foreach_addcdiv_(params, ms, denom, value=-lr_t)
            for s in states:
                s["step"] = t
        return None


def make_optimizer(params, lr: float, flavor: str = "adam") -> torch.optim.Optimizer:
    """``adam``: torch's Adam, whose epsilon (1e-8, as optax's) sits
    outside the bias correction's root; ``keras``: :class:`KerasAdam`, for
    the TF family. The train epoch sets the learning rate per step from
    :func:`make_lr_schedule`."""
    if flavor == "keras":
        return KerasAdam(params, lr=lr)
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
    Under ``utils.profiling.debug_nans`` a step with a non-finite loss or
    gradient raises ``FloatingPointError`` before its update.
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
            if profiling.debug_nans_enabled():
                profiling.check_finite(loss, dict(model.named_parameters()))
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
    A rollout task ignores ``metrics``: one unroll gives its ``loss``,
    ``rel_l2_step`` (the mean over steps of the stepwise error) and
    ``rel_l2_final`` (the last step's). Positions of ``perm`` at or past
    ``n_valid`` (default: the dataset size) are the padded tail of
    :func:`eval_permutation` and weigh 0. Sums stay on the device."""

    def rollout_sums(geom, batch, w):
        pred = task.rollout_preds(geom, batch)
        rel_loss = task.stepwise_rel(batch["y"], pred, swap=task.swap_loss_args)
        if task.trajectory_loss:
            loss = (w * rel_loss.mean(dim=-1)).sum()
        else:
            loss = (w[:, None] * rel_loss).sum()
        rel = task.stepwise_rel(batch["y"], pred)  # the true denominator
        return {"loss": loss, "rel_l2_step": (w * rel.mean(dim=-1)).sum(),
                "rel_l2_final": (w * rel[:, -1]).sum()}

    def eval_epoch(geom, data, perm, n_valid=None):
        if n_valid is None:
            n_valid = next(iter(data.values())).shape[0]
        task.model.eval()
        wts = (torch.arange(perm.numel(), device=perm.device) < n_valid)
        wts = wts.to(torch.float32).reshape(perm.shape)
        sums: dict = {}
        with torch.inference_mode():
            for idx, w in zip(perm, wts):
                batch = _gather(data, idx)
                if task.rollout_steps:
                    vals = rollout_sums(geom, batch, w)
                elif metrics is None:
                    loss = task._loss(batch["y"], task.forward(geom, batch), weights=w)
                    if task.batch_mean_loss:
                        loss = loss * w.sum()
                    vals = {"loss": loss}
                else:
                    pred = task.forward(geom, batch)
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
