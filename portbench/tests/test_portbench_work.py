"""The work counts against brute-force counts at tiny shapes: a forward's
matrix-product operations as torch's flop counter counts the reference's
products, and the position attention ops' operations from their kept
entries counted one by one."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness, weights
from portbench.reference import common
from portbench.tests.conftest import SEED, TINY
from portbench.work import gemm, posatt_fixed, posatt_tf


def _reference_flops(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_gemm_counts():
    assert gemm.linear(3, 4, 5) == {"fwd": 120, "bwd": 240}
    assert gemm.linear(3, 4, 5, needs_dx=False) == {"fwd": 120, "bwd": 120}


def test_posatt_fixed_counts():
    o = posatt_fixed.op(L_out=7, L_in=11, H=2, B=3, D=5, kept=20, needs_du=False)
    assert o["fwd"][0] == 2 * 2 * 3 * 5 * 20 and o["du"] is None
    # bytes: distances, thresholds, values, output, each once in float32
    assert o["fwd"][1] == 4 * (7 * 11 + 7 + 11 * 3 * 5 + 2 * 7 * 3 * 5)
    assert o["dscale"][1] == o["fwd"][1] + 4 * 2


def test_posatt_tf_counts():
    o = posatt_tf.op(B=2, L=9, d=2, H=4, V=3, kept=50, local=True, from_coords=True)
    assert o["fwd"][0] == 2 * 4 * 3 * 50
    assert o["fwd"][1] == 4 * (2 * 2 * 9 * 2 + 2 * 9 + 2 * 2 * 9 * 12)
    dist = posatt_tf.op(B=2, L=9, d=2, H=4, V=3, kept=50, local=False, from_coords=False)
    assert dist["fwd"][1] == 4 * (2 * 81 + 2 * 2 * 9 * 12)


def test_pit_forward_counts_match_the_flop_counter():
    """The reference's dense forward does every matrix product the work
    counts plus each attention op over all its entries: the counter's
    total equals the work's GEMMs plus 2 H B D L_out L_in per op."""
    from portbench.inputs import cylinder as ic
    from portbench.reference import pit
    from portbench.work import pit as wp

    cfg = harness.config("cylinder", TINY["cylinder"])
    m, ltt = ic.mesh(cfg, SEED, "cpu")
    g = pit.geometry(cfg, m, ltt)
    w = weights.make(pit.param_shapes(cfg), pit.init_rule, SEED, "cpu")
    B, L, Ll = 3, cfg["inputs"]["n_points"], cfg["inputs"]["n_latent"]
    x = torch.randn(B, L, 3)
    got = _reference_flops(lambda: pit.forward(cfg, w, g, x, common.Precision()))
    kept = pit.kept_counts(g)
    # kept entries one by one
    assert kept["down"] == sum(int(v) for row in g["keep_down"] for v in row)
    work = wp.model_work(cfg, kept, B, L, Ll, train=False)
    mo = cfg["model"]
    H, hid, d_in = mo["n_head"], mo["hid_dim"], mo["in_dim"] + mo["space_dim"]
    posatt_kept = 2 * H * B * (d_in * kept["down"] + mo["n_blocks"] * hid * kept["proc"]
                               + hid * kept["up"])
    posatt_dense = 2 * H * B * (d_in * Ll * L + mo["n_blocks"] * hid * Ll * Ll + hid * L * Ll)
    assert work["flops"] - posatt_kept + posatt_dense == got


def test_pit_tf_forward_counts_match_the_flop_counter():
    from portbench.inputs import elasticity_tf as ie
    from portbench.reference import pit_tf_pointcloud as ptf
    from portbench.work import pit_tf_pointcloud as wtf

    cfg = harness.config("elasticity_tf", TINY["elasticity_tf"])
    L = cfg["inputs"]["n_points"]
    ext, r, _ = ie.clouds(SEED, 2, L)
    x = torch.from_numpy(ie.model_input(ext, r))
    w = weights.make(ptf.param_shapes(cfg), ptf.init_rule, SEED, "cpu")
    got = _reference_flops(lambda: ptf.forward(cfg, w, x, "quantile", common.Precision()))
    kept = ptf.kept_counts(cfg, x[..., :2], "quantile")
    _, keeps = ptf.keeps(cfg, x[..., :2], "quantile")
    assert kept["down"] == int(keeps[cfg["model"]["en_loc"]].sum())
    work = wtf.model_work(cfg, kept, 2, L, train=False)
    mo = cfg["model"]
    HV = mo["hid_dim"]
    n_ops = mo["n_blocks"] + 2
    posatt_kept = 2 * HV * (kept["down"] + mo["n_blocks"] * kept["proc"] + kept["up"])
    posatt_dense = 2 * HV * n_ops * 2 * L * L
    assert work["flops"] - posatt_kept + posatt_dense == got


@pytest.mark.parametrize("family", ["pit", "pit_tf_pointcloud"])
def test_training_adds_the_backward_products(family):
    """A step's operations: the forward's, each GEMM's weight gradient, the
    input gradients except the first layer's, and dscale and du/dv for the
    attention ops (none for the torch family's encoder input)."""
    import importlib

    wk = importlib.import_module(f"portbench.work.{family}")
    if family == "pit":
        cfg = harness.config("cylinder", TINY["cylinder"])
        kept = {"down": 10, "proc": 64 * 64, "up": 300}
        args = (cfg, kept, 2, 300, 64)
    else:
        cfg = harness.config("elasticity_tf", TINY["elasticity_tf"])
        kept = {"down": 100, "proc": 2 * 200 * 200, "up": 100}
        args = (cfg, kept, 2, 200)
    fwd, step = wk.model_work(*args, train=False), wk.model_work(*args, train=True)
    n_fwd, n_step = len(fwd["posatt"]), len(step["posatt"])
    n_ops = cfg["model"]["n_blocks"] + 2
    assert n_fwd == n_ops
    assert n_step == 3 * n_ops - (1 if family == "pit" else 0)
    assert 2 * fwd["flops"] < step["flops"] < 3 * fwd["flops"]
