"""Plain PyTorch operators: distances, locality, initializers, position
attention, metrics and normalization."""

from position_induced_transformer_torch.ops.distances import (
    euclidean_sq,
    pairwise_sq_dist,
    periodic1d_sq,
    periodic2d_sq,
)
from position_induced_transformer_torch.ops.locality import (
    batched_halfdist_percentile_thresholds,
    batched_topk_thresholds,
    keep_mask,
    quantile_threshold,
    robust_topk_threshold,
    topk_keep_count,
    topk_threshold,
)
from position_induced_transformer_torch.ops.metrics import (
    rel_l1_quartiles,
    rel_lp_norm,
    rel_max_norm,
    rel_norm_mean,
    rel_norm_step,
    rel_norm_traj,
)
from position_induced_transformer_torch.ops.normalization import (
    PixelWiseNormalizer,
    instance_norm,
)
from position_induced_transformer_torch.ops.posatt import (
    attention_weights,
    bandwidth_scale,
    convolve,
    position_attention,
)

__all__ = [
    "euclidean_sq",
    "periodic1d_sq",
    "periodic2d_sq",
    "pairwise_sq_dist",
    "keep_mask",
    "quantile_threshold",
    "topk_threshold",
    "robust_topk_threshold",
    "topk_keep_count",
    "batched_topk_thresholds",
    "batched_halfdist_percentile_thresholds",
    "rel_lp_norm",
    "rel_max_norm",
    "rel_norm_mean",
    "rel_l1_quartiles",
    "rel_norm_step",
    "rel_norm_traj",
    "PixelWiseNormalizer",
    "instance_norm",
    "attention_weights",
    "bandwidth_scale",
    "convolve",
    "position_attention",
]
