"""Hand-written Hopper kernels and their wrappers."""

from position_induced_transformer_torch.kernels.posatt_pallas import (  # noqa: F401
    PosAttFixed,
    posatt_bwd_dscale_cuda,
    posatt_bwd_dscale_reference,
    posatt_bwd_du_cuda,
    posatt_bwd_du_reference,
    posatt_fixed_cuda,
    posatt_fixed_reference,
    posatt_stats_cuda,
    posatt_stats_reference,
    position_attention_fixed,
)
