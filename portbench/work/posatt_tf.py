"""Least work of a point-cloud position attention op of the TF family (#9
or #11 forward, #10 or #12 dscale and dv): per sample its own cloud of L
points in ``d`` dimensions, ``H`` heads of ``V`` value columns each.

2 H V operations per kept entry in each of the forward, dscale and dv. A
kernel that works the distances out of the coordinates reads the
coordinates (``from_coords``), else it reads the (B, L, L) distances.
Bytes, each once in float32: the forward reads those, the thresholds and
the values (B, L, H V) and writes its output (B, L, H V); dscale reads
them, the values and the cotangent and writes H numbers; dv reads them
and the cotangent and writes (B, L, H V)."""


def op(B: int, L: int, d: int, H: int, V: int, kept: int, local: bool,
       from_coords: bool) -> dict:
    flops = 2 * H * V * kept
    base = (2 * B * L * d) if from_coords else B * L * L
    base += B * L if local else 0
    hv = B * L * H * V
    return {
        "fwd": (flops, 4 * (base + 2 * hv)),
        "dscale": (flops, 4 * (base + 2 * hv + H)),
        "du": (flops, 4 * (base + 2 * hv)),
    }
