"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W
limit), and the card's name and power limit as ``nvidia-smi`` reads them,
which every result records beside the peaks. The port sets no TF32, so
float32 products run outside the tensor cores: 67 TFLOP/s applies."""

from __future__ import annotations

import subprocess

PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """Least seconds for ``flops`` float32 operations and ``nbytes`` bytes
    of device memory traffic."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)


def card() -> str:
    """``name, power.limit`` of each card, or why it could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return "; ".join(out.stdout.strip().splitlines())
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
