"""The plain references against the port's plain CPU path at tiny widths:
the same kept sets, forwards and three training steps agree to float32
rounding, and the control (the reference in TF32) does not."""

import numpy as np
import pytest
import torch

from portbench import harness, weights
from portbench.inputs import cylinder as ic
from portbench.inputs import elasticity_tf as ie
from portbench.reference import common
from portbench.reference import pit as rp
from portbench.reference import pit_tf_pointcloud as rtf
from portbench.tests.conftest import SEED, TINY


def rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def cylinder(tmp_path_factory):
    from position_induced_transformer_torch.train import benchmarks

    cfg = harness.config("cylinder", TINY["cylinder"])
    m, ltt = ic.mesh(cfg, SEED, "cpu")
    path = ic.write_setup_files(cfg, SEED, m, ltt, str(tmp_path_factory.mktemp("cyl")))
    prob = benchmarks.setup(harness.program_config(cfg), path, ntrain=10, ntest=10, device="cpu")
    w = weights.make(rp.param_shapes(cfg), rp.init_rule, SEED, "cpu")
    prob.model.load_state_dict(w)
    x, y = ic.pairs(cfg, SEED, m, 12)
    return cfg, prob, w, rp.geometry(cfg, m, ltt), x, y


@pytest.fixture(scope="module")
def elasticity(tmp_path_factory):
    from position_induced_transformer_torch.train import benchmarks

    cfg = harness.config("elasticity_tf", TINY["elasticity_tf"])
    n = cfg["ntrain"] + cfg["ntest"]
    ext, r, y = ie.clouds(SEED, n, cfg["inputs"]["n_points"])
    path = ie.write_setup_files(ext, r, y, str(tmp_path_factory.mktemp("el")))
    prob = benchmarks.setup(harness.program_config(cfg), path, device="cpu")
    w = weights.make(rtf.param_shapes(cfg), rtf.init_rule, SEED, "cpu")
    prob.model.load_state_dict(w)
    return cfg, prob, w, torch.from_numpy(ie.model_input(ext, r)), torch.from_numpy(y)


def test_cylinder_mesh_distances_are_exact_and_kept_sets_equal(cylinder):
    cfg, prob, _, g, _, _ = cylinder
    for side in ("down", "up"):
        dist = getattr(prob.geom, f"dist_{side}")
        assert torch.equal(dist, g[f"dist_{side}"])
        assert torch.equal(dist <= getattr(prob.geom, f"thr_{side}"), g[f"keep_{side}"])


def test_cylinder_forward(cylinder):
    cfg, prob, w, g, x, _ = cylinder
    common.no_tf32()
    with torch.no_grad():
        got = prob.task.forward(prob.geom, {"x": x[:4]})
        want = rp.forward(cfg, w, g, x[:4], common.Precision())
        control = rp.forward(cfg, w, g, x[:4], common.Precision(tf32=True))
    assert rel(got, want) < 1e-6
    assert rel(control, want) > 30 * rel(got, want)


def _program_steps(prob, pcfg, data, perm, flavor, geom):
    from position_induced_transformer_torch.train import loop

    opt = loop.make_optimizer(prob.model.parameters(), pcfg.lr, flavor)
    st = loop.TrainState(prob.model, opt)
    te = loop.make_train_epoch(prob.task, loop.make_lr_schedule(pcfg.lr, 1000))
    st, l1 = te(st, geom, data, perm[:1])
    grads = {n: float(opt.state[p]["exp_avg"].double().norm()) / 0.1
             for n, p in prob.model.named_parameters()}
    st, l23 = te(st, geom, data, perm[1:])
    return [float(v) for v in torch.cat([l1, l23])], grads, dict(prob.model.named_parameters())


def test_cylinder_training_steps(cylinder):
    from portbench import checks

    cfg, prob, w, g, x, y = cylinder
    perm = torch.arange(12).reshape(3, 4)
    losses, grads, after = _program_steps(prob, harness.program_config(cfg), {"x": x, "y": y},
                                          perm, "adam", prob.geom)
    batches = [(x[r], y[r]) for r in perm]
    r_losses, r_grads, r_after = rp.train(cfg, w, g, batches, 1000, common.Precision())
    change = lambda a: {k: a[k].detach() - w[k] for k in w}
    nums, _ = checks.training(losses, r_losses, grads, r_grads, change(after), change(r_after))
    assert nums["loss_gap"] < 1e-6 and nums["grad_gap"] < 1e-5 and nums["change_gap"] < 1e-4
    c_losses, c_grads, c_after = rp.train(cfg, w, g, batches, 1000, common.Precision(tf32=True))
    ctrl, _ = checks.training(c_losses, r_losses, {k: float(v.norm()) for k, v in c_grads.items()},
                              r_grads, change(c_after), change(r_after))
    assert ctrl["loss_gap"] > 10 * nums["loss_gap"] or ctrl["grad_gap"] > 10 * nums["grad_gap"]


def test_elasticity_setup_thresholds_keep_what_the_reference_keeps(elasticity):
    cfg, prob, _, _, _ = elasticity
    td = prob.train_data
    xs = torch.from_numpy(td["x"])
    dist, keep = rtf.keeps(cfg, xs[..., :2], "setup")
    got = dist <= torch.from_numpy(td["thr_en"])
    assert torch.equal(got, keep[cfg["model"]["en_loc"]])


def test_elasticity_served_forward(elasticity):
    cfg, prob, w, x, _ = elasticity
    common.no_tf32()
    with torch.no_grad():
        got = prob.task.forward(None, {"x": x[:3]})
        want = rtf.predict(cfg, w, None, x[:3], common.Precision())
        control = rtf.predict(cfg, w, None, x[:3], common.Precision(tf32=True))
    assert rel(got, want) < 1e-5
    assert rel(control, want) > 30 * rel(got, want)


def test_elasticity_training_steps(elasticity):
    from portbench import checks

    cfg, prob, w, x, y = elasticity
    data = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in prob.train_data.items()}
    perm = torch.arange(12).reshape(3, 4)
    losses, grads, after = _program_steps(prob, harness.program_config(cfg), data, perm, "keras",
                                          None)
    r_losses, r_grads, r_after = rtf.train(cfg, w, None, [(x[r], y[r]) for r in perm], 1000,
                                           common.Precision())
    change = lambda a: {k: a[k].detach() - w[k] for k in w}
    nums, _ = checks.training(losses, r_losses, grads, r_grads, change(after), change(r_after))
    assert nums["loss_gap"] < 1e-6 and nums["grad_gap"] < 1e-4 and nums["change_gap"] < 1e-4


def test_round_tf32():
    t = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-12, 3.0])
    got = common.round_tf32(t)
    assert got.tolist() == [1.0, 1.0 + 4 * 2**-11, 1.0, 3.0]
