"""Work of the torch-family PiT on a fixed mesh: the operations of its
matrix products and of its position attention ops, per sample of a
forward (inference) and per step of training (forward and the backward
products the gradients need: the encoder's input function takes none,
so the encoder op needs no du)."""

from portbench.work import gemm, posatt_fixed


def model_work(cfg: dict, kept: dict, B: int, n_points: int, n_latent: int, train: bool) -> dict:
    """``{"flops", "posatt": [(flops, bytes), ...]}`` of a batch of ``B``;
    ``kept``: kept entries of each op of one sample (``down``, ``proc``,
    ``up``)."""
    m = cfg["model"]
    H, hid = m["n_head"], m["hid_dim"]
    d_in = m["in_dim"] + (m["space_dim"] if m.get("concat_mesh", True) else 0)
    rows_l, rows_o = B * n_latent, B * n_points
    mats = [gemm.linear(rows_l, H * d_in, hid), gemm.linear(rows_l, hid, hid)]
    for _ in range(m["n_blocks"]):
        mats += [gemm.linear(rows_l, (1 + H) * hid, hid), gemm.linear(rows_l, hid, hid)]
    mats += [gemm.linear(rows_o, H * hid, hid), gemm.linear(rows_o, hid, m["out_dim"])]
    ops = [posatt_fixed.op(n_latent, n_points, H, B, d_in, kept["down"], needs_du=False)]
    ops += [posatt_fixed.op(n_latent, n_latent, H, B, hid, kept["proc"], needs_du=True)
            for _ in range(m["n_blocks"])]
    ops += [posatt_fixed.op(n_points, n_latent, H, B, hid, kept["up"], needs_du=True)]
    parts = ("fwd", "dscale", "du") if train else ("fwd",)
    posatt = [o[p] for o in ops for p in parts if o[p] is not None]
    flops = sum(g["fwd"] + (g["bwd"] if train else 0) for g in mats)
    return {"flops": flops + sum(f for f, _ in posatt), "posatt": posatt}


def window_work(cfg: dict, ref, ref_inputs: dict, x, batches, train: bool) -> tuple:
    """(operations, summed roofline bound in seconds of the position
    attention ops) of the units of work that took the rows ``batches`` (a
    list of index tensors) of the inputs ``x``. On a fixed mesh the kept
    sets are those of the reference's geometry of ``ref_inputs``, the same
    for every sample; only the batch sizes count."""
    from collections import Counter

    from portbench import peaks

    kept = ref.kept_counts(ref.context(cfg, ref_inputs))
    inp = cfg["inputs"]
    flops = bound = 0.0
    for B, k in Counter(len(r) for r in batches).items():
        w = model_work(cfg, kept, B, inp["n_points"], inp["n_latent"], train)
        flops += k * w["flops"]
        bound += k * sum(peaks.bound_s(f, b) for f, b in w["posatt"])
    return flops, bound
