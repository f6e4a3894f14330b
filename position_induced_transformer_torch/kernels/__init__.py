"""Hand-written Hopper kernels and their wrappers."""

from position_induced_transformer_torch.kernels.posatt_pallas import (  # noqa: F401
    posatt_fixed_cuda,
    posatt_fixed_reference,
    position_attention_fixed,
)
