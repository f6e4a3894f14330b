"""Least work of a fixed-mesh position attention op (the torch family's
#1 forward, #3 dscale and #4 du): one distance matrix (L_out, L_in) shared
by the batch, ``H`` heads over values (B, L_in, D).

Each op does 2 H B D operations per kept entry (a masked weight is exactly
0 and needs none): the forward's contraction, dscale's products of the
cotangent with the values, du's products of the weights with the
cotangent. Bytes: each input read once and each output written once, in
float32: the forward reads the distances, the thresholds and the values and
writes (B, L_out, H D); dscale reads the distances, thresholds, values and
the cotangent and writes H numbers; du reads the distances, thresholds
and the cotangent and writes (B, L_in, D). A bound is the larger of the
operations over the peak rate and the bytes over the peak bandwidth.
"""


def op(L_out: int, L_in: int, H: int, B: int, D: int, kept: int, needs_du: bool) -> dict:
    flops = 2 * H * B * D * kept
    base = L_out * L_in + L_out  # distances, thresholds
    return {
        "fwd": (flops, 4 * (base + L_in * B * D + H * L_out * B * D)),
        "dscale": (flops, 4 * (base + L_in * B * D + H * L_out * B * D + H)),
        "du": (flops, 4 * (base + H * L_out * B * D + L_in * B * D)) if needs_du else None,
    }
