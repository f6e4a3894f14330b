"""The model's float32 operations in the untraced window (matrix products
2 m n k, position attention 2 H B D per kept entry, and for training the
backward products the gradients need) over that window's length by the
host's clock at 67 TFLOP/s, %. The traced window is not used: its
profiler slows the host."""

from portbench.readers import mfu


def read(w):
    return mfu(w)
