"""Parameter initializers drawn from an explicit ``torch.Generator``.

- ``kaiming_normal``: N(0, 2/fan_in) for a torch ``(out, in)`` weight, as
  ``nn.init.kaiming_normal_`` with its defaults.
- ``torch_linear_bias``: ``nn.Linear``'s default bias, U(+-1/sqrt(fan_in)).
- ``uniform01``: U[0, 1) for the per-head bandwidth ``lmda``.

The generator's stream differs from ``jax.random``; weights are carried
across packages with ``utils.torch_compat``, not regenerated.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def kaiming_normal(
    shape: Sequence[int], generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """Weight init N(0, 2/fan_in) for an ``(out, in)`` weight."""
    fan_in = shape[1]
    std = math.sqrt(2.0 / fan_in)
    return std * torch.randn(tuple(shape), generator=generator)


def torch_linear_bias(
    fan_in: int, shape: Sequence[int], generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    bound = 1.0 / math.sqrt(fan_in)
    return (2.0 * torch.rand(tuple(shape), generator=generator) - 1.0) * bound


def uniform01(
    shape: Sequence[int], generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    return torch.rand(tuple(shape), generator=generator)
