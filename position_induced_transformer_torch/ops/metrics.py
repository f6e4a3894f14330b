"""Relative-error losses and metrics (those training and evaluation use),
and the stepwise and whole-trajectory errors of rollouts.

Per-sample, per-output-variable relative norms over the mesh axis,
averaged over variables and **summed over the batch** (the caller divides
by the dataset size), as the JAX package's ``ops/metrics.py`` does; the
TF-side :func:`rel_norm_mean` takes the norm over each flattened sample
and **means** over the batch.
"""

from __future__ import annotations

import torch


def _reshape(true: torch.Tensor, pred: torch.Tensor, out_dim: int):
    return (
        true.reshape(true.shape[0], -1, out_dim),
        pred.reshape(pred.shape[0], -1, out_dim),
    )


def _weighted_sum(rel: torch.Tensor, weights) -> torch.Tensor:
    if weights is not None:
        rel = rel * weights
    return rel.sum()


def rel_lp_norm(
    true: torch.Tensor,
    pred: torch.Tensor,
    out_dim: int,
    p: float = 2,
    weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """Relative Lp error, mean over variables, sum over batch.

    ``weights``: optional (B,) per-sample weights for the batch sum (0
    drops a sample, as the padded tail of an eval batch is dropped).
    """
    t, q = _reshape(true, pred, out_dim)
    if p == 1:
        true_norm = t.abs().sum(dim=1)
        diff_norm = (t - q).abs().sum(dim=1)
    elif p == 2:
        true_norm = torch.sqrt((t * t).sum(dim=1))
        diff = t - q
        diff_norm = torch.sqrt((diff * diff).sum(dim=1))
    else:
        true_norm = (t.abs() ** p).sum(dim=1) ** (1.0 / p)
        diff_norm = ((t - q).abs() ** p).sum(dim=1) ** (1.0 / p)
    return _weighted_sum((diff_norm / true_norm).mean(dim=-1), weights)


def rel_max_norm(
    true: torch.Tensor,
    pred: torch.Tensor,
    out_dim: int,
    weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """Relative L-infinity error, mean over variables, sum over batch."""
    t, q = _reshape(true, pred, out_dim)
    true_norm = t.abs().amax(dim=1)
    diff_norm = (t - q).abs().amax(dim=1)
    return _weighted_sum((diff_norm / true_norm).mean(dim=-1), weights)


def rel_norm_mean(true: torch.Tensor, pred: torch.Tensor, p: float = 1) -> torch.Tensor:
    """TF-side loss: the relative Lp error of each flattened sample,
    averaged over the batch (``p == 1``: sums of absolute values; any
    other ``p``: the vector p-norm)."""
    t, q = true.reshape(true.shape[0], -1), pred.reshape(pred.shape[0], -1)
    if p == 1:
        rel = (t - q).abs().sum(dim=1) / t.abs().sum(dim=1)
    else:
        rel = (torch.linalg.vector_norm(t - q, ord=p, dim=1)
               / torch.linalg.vector_norm(t, ord=p, dim=1))
    return rel.mean()


def rel_l1_quartiles(true: torch.Tensor, pred: torch.Tensor):
    """The (25 %, 50 %, 75 %) linear quantiles of the per-sample relative
    L1 error of the first output variable, over the batch."""
    t, q = true[..., 0], pred[..., 0]
    rel = (t - q).abs().sum(dim=1) / t.abs().sum(dim=1)
    qs = torch.tensor([0.25, 0.5, 0.75], dtype=rel.dtype, device=rel.device)
    return tuple(torch.quantile(rel, qs, interpolation="linear"))


def rel_norm_step(true: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Per-rollout-step relative L2 error of (B, ..., steps) trajectories,
    averaged over the batch: a (steps,) vector."""
    b, s = true.shape[0], true.shape[-1]
    t, q = true.reshape(b, -1, s), pred.reshape(b, -1, s)
    rel = torch.linalg.vector_norm(t - q, dim=1) / torch.linalg.vector_norm(t, dim=1)
    return rel.mean(dim=0)


def rel_norm_traj(true: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Whole-trajectory relative L2 error of (B, ..., steps) tensors,
    averaged over the batch."""
    t, q = true.reshape(true.shape[0], -1), pred.reshape(pred.shape[0], -1)
    rel = torch.linalg.vector_norm(t - q, dim=1) / torch.linalg.vector_norm(t, dim=1)
    return rel.mean()
