"""A model bound to its output conventions (the forward half of the JAX
package's ``train/loop.Task``; losses and the optimizer come with the
training slice)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional


@dataclasses.dataclass(frozen=True)
class Task:
    model: Any  # nn.Module with forward(geom, x)
    loss_p: int = 2
    out_dim: int = 1
    swap_loss_args: bool = False
    postprocess: Optional[Callable] = None  # e.g. a denormalizer

    def forward(self, geom, batch):
        out = self.model(geom, batch["x"])
        if self.postprocess is not None:
            out = self.postprocess(out)
        return out
