"""Relative-error losses and metrics (those training and evaluation use).

Per-sample, per-output-variable relative norms over the mesh axis,
averaged over variables and **summed over the batch** (the caller divides
by the dataset size), as the JAX package's ``ops/metrics.py`` does.
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


def rel_l1_quartiles(true: torch.Tensor, pred: torch.Tensor):
    """The (25 %, 50 %, 75 %) linear quantiles of the per-sample relative
    L1 error of the first output variable, over the batch."""
    t, q = true[..., 0], pred[..., 0]
    rel = (t - q).abs().sum(dim=1) / t.abs().sum(dim=1)
    qs = torch.tensor([0.25, 0.5, 0.75], dtype=rel.dtype, device=rel.device)
    return tuple(torch.quantile(rel, qs, interpolation="linear"))
