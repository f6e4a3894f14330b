"""Batching conventions shared by prediction and serving."""

from __future__ import annotations

import numpy as np


def padded_batches(n: int, batch_size: int):
    """Index arrays covering all ``n`` samples in batches of one size; the
    final partial batch repeats the last index (slice the concatenated
    outputs to ``[:n]`` to drop the duplicates)."""
    for i in range(0, n, batch_size):
        yield np.minimum(np.arange(i, i + batch_size), n - 1)


def round_batch(bs: int, k: int) -> int:
    """Round ``bs`` down to a multiple of ``k`` (floor ``k``)."""
    return max(k, bs - bs % k) if k > 1 else bs
