"""Work of the TF-family point-cloud PiT: the operations of its matrix
products (Dense layers, MLPs and the per-head value projections) and of
its six position attention ops, for a batch (forward only for inference;
forward and the backward products the gradients need for a training step:
the first Dense layer's input is data and takes none). Training reads its
thresholds from setup and works the distances out of the coordinates
(#11, #12); a predicted batch builds the (B, L, L) distances once and every
op reads them (#9)."""

from portbench.work import gemm, posatt_tf


def model_work(cfg: dict, kept: dict, B: int, n_points: int, train: bool) -> dict:
    """``kept``: kept entries of each op summed over the batch's clouds
    (``down``, ``proc``, ``up``)."""
    m = cfg["model"]
    H, hid = m["n_head"], m["hid_dim"]
    V = round(hid / H)
    rows = B * n_points
    sq = lambda: gemm.linear(rows, hid, hid)
    mats = [gemm.linear(rows, m["in_dim"], hid, needs_dx=False)]
    n_ops = m["n_blocks"] + 2
    mats += [sq() for _ in range(n_ops)]  # value projections
    mats += [sq() for _ in range(2 * (m["n_blocks"] + 2))]  # mlp1, MLP_i, mlp2
    mats += [sq() for _ in range(m["n_blocks"] + 2)]  # w1, W_i, w2
    mats += [sq(), gemm.linear(rows, hid, m["out_dim"])]  # de_layer
    keys = ["down"] + ["proc"] * m["n_blocks"] + ["up"]
    locs = [m["en_loc"]] + [200.0] * m["n_blocks"] + [m["de_loc"]]
    ops = [posatt_tf.op(B, n_points, 2, H, V, kept[k], loc <= 100, from_coords=train)
           for k, loc in zip(keys, locs)]
    parts = ("fwd", "dscale", "du") if train else ("fwd",)
    posatt = [o[p] for o in ops for p in parts]
    flops = sum(g["fwd"] + (g["bwd"] if train else 0) for g in mats)
    return {"flops": flops + sum(f for f, _ in posatt), "posatt": posatt}


def window_work(cfg: dict, ref, ref_inputs, x, batches, train: bool) -> tuple:
    """(operations, summed roofline bound in seconds of the position
    attention ops) of the units of work that took the rows ``batches`` (a
    list of index tensors) of the inputs ``x``: each batch's kept sets are
    the reference's for its clouds (the input's first two channels), with
    the thresholds of training (fixed at setup) or of a prediction (per
    request)."""
    from portbench import peaks

    thresholds = "setup" if train else "quantile"
    flops = bound = 0.0
    for r in batches:
        kept = ref.kept_counts(cfg, x[r][..., :2], thresholds)
        w = model_work(cfg, kept, len(r), cfg["inputs"]["n_points"], train)
        flops += w["flops"]
        bound += sum(peaks.bound_s(f, b) for f, b in w["posatt"])
    return flops, bound
