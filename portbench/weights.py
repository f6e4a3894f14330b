"""Seeded weights made on the device in two large draws.

Every parameter is a slice of one standard normal and one uniform draw of
a ``torch.Generator`` on the run's device, shaped and scaled by the
reference family's ``init_rule``. The program and the reference both get
these tensors; neither makes weights of its own for the comparison.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.seeds import stream_seed


def generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, purpose))


def make(shapes: dict, init_rule, seed: int, device) -> dict:
    """name -> float32 tensor on ``device``, drawn as ``init_rule(name,
    shapes)`` says: ``("normal", std)``, ``("truncnormal", std)`` (a normal
    clipped at two deviations), ``("uniform", lo, hi)`` or ``("zeros",)``."""
    names = sorted(shapes)
    total = sum(int(np.prod(shapes[n])) for n in names)
    g = generator(seed, "weights", device)
    normal = torch.randn(total, generator=g, device=device)
    uniform = torch.rand(total, generator=g, device=device)
    out, off = {}, 0
    for n in names:
        k = int(np.prod(shapes[n]))
        rule = init_rule(n, shapes)
        z, u = normal[off : off + k], uniform[off : off + k]
        if rule[0] == "normal":
            t = z * rule[1]
        elif rule[0] == "truncnormal":
            t = z.clamp(-2.0, 2.0) * rule[1]
        elif rule[0] == "uniform":
            t = rule[1] + (rule[2] - rule[1]) * u
        elif rule[0] == "zeros":
            t = torch.zeros_like(z)
        else:
            raise ValueError(f"unknown init rule {rule!r} for {n}")
        out[n] = t.reshape(shapes[n]).contiguous()
        off += k
    return out
