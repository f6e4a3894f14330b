"""Parameter initializers drawn from an explicit ``torch.Generator``.

- ``kaiming_normal``: N(0, 2/fan_in) for a torch ``(out, in)`` weight, as
  ``nn.init.kaiming_normal_`` with its defaults.
- ``torch_linear_bias``: ``nn.Linear``'s default bias, U(+-1/sqrt(fan_in)).
- ``uniform01``: U[0, 1) for the per-head bandwidth ``lmda``.
- ``he_normal_tf`` and ``glorot_uniform``: the TF-semantics family's
  initializers, ``jax.nn.initializers.he_normal`` / ``glorot_uniform``
  with JAX's fan counts (:func:`jax_fans`).

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


def jax_fans(shape: Sequence[int]):
    """(fan_in, fan_out) as ``jax.nn.initializers`` count them for a
    parameter of ``shape`` in the JAX layout: the last two axes are (in,
    out) and every leading axis multiplies both, so a (1, H, 1, 1) or (H, 1,
    1) bandwidth has fan_in = fan_out = H and an (H, in, V) weight
    fan_in = H * in."""
    if len(shape) < 2:
        n = shape[0] if len(shape) else 1
        return n, n
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def he_normal_tf(
    shape: Sequence[int], generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """``jax.nn.initializers.he_normal`` (keras "he_normal") for a
    parameter of ``shape`` in the JAX layout: a normal truncated at +-2
    standard deviations with std ``sqrt(2 / fan_in) / 0.8796...`` (the
    truncated unit normal's own std), drawn by the inverse CDF."""
    fan_in, _ = jax_fans(shape)
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2, (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2
    u = lo + (hi - lo) * torch.rand(tuple(shape), generator=generator, dtype=torch.float64)
    return (std * math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).clamp(-2 * std, 2 * std).float()


def glorot_uniform(
    shape: Sequence[int], generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """``jax.nn.initializers.glorot_uniform`` (keras' default for
    ``add_weight``): U(+-sqrt(6 / (fan_in + fan_out))) with JAX's fans."""
    fan_in, fan_out = jax_fans(shape)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return (2.0 * torch.rand(tuple(shape), generator=generator) - 1.0) * limit
