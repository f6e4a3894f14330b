"""Independent streams of the run's ``--seed``: one for each use (weights,
inputs, batch order, traffic, samples). Numpy only."""

from __future__ import annotations

import numpy as np


def stream_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one use of ``seed``; any whole number is taken."""
    tag = int.from_bytes(purpose.encode()[:8].ljust(8, b"\0"), "little")
    return int(np.random.SeedSequence([int(seed), tag]).generate_state(1, np.uint64)[0] >> 1)


def rng(seed: int, purpose: str) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, purpose))
