"""The vorticity slice of the port against the JAX package, on the CPU: the
generator and loader, the rollout metrics, the periodic 2-D geometry, the
rollout (window fed back, stepwise errors, both loss conventions), the
gradients of 3-step backpropagation through the rollout under each remat
mode, three training steps, the rollout eval epoch with a padded tail,
``evaluate``, and deployment with ``rollout_steps``.

The model runs narrow (hid 16, 2 blocks, in_dim = memory = 4; 2 heads,
instance norm and locality 0.02 as configured) on the 16^2 periodic grid
down to an 8^2 latent, 3 rollout steps, as the JAX package's own rollout
tests run it. The loaders take their grid from the data, so both sides
read a 16^2 ``.mat`` written here (the generator's fields at s = 16),
through the real-file branch. The JAX setup builds its geometry with
``build_geometry_host`` (the native builder); on these grids it agrees
with the port's bit for bit (test_geometry_matches_the_native_builder, 0
flips, also at the full 64^2 -> 16^2), and the model tests carry the JAX
geometry over all the same. Predictions hold at rtol 1e-4 / atol 1e-5,
training at losses rtol 2e-4 and weights rtol 5e-3 / atol 2e-5 (the
bounds of test_torch_train.py).
"""

import dataclasses
import io
import json
import os
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.io import savemat

from position_induced_transformer_torch import configs as t_configs
from position_induced_transformer_torch.data import loaders as t_loaders
from position_induced_transformer_torch.data import meshes as t_meshes
from position_induced_transformer_torch.data import synthetic as t_syn
from position_induced_transformer_torch.models import PiT as TPiT
from position_induced_transformer_torch.models import Geometry
from position_induced_transformer_torch.models import build_geometry as t_build
from position_induced_transformer_torch.ops import metrics as t_metrics
from position_induced_transformer_torch.train import benchmarks as t_bench
from position_induced_transformer_torch.train import checkpoint as t_ckpt
from position_induced_transformer_torch.train import evaluate as t_eval
from position_induced_transformer_torch.train import loop as t_loop
from position_induced_transformer_torch.train import runner as t_runner
from position_induced_transformer_torch.train.serve import make_server
from position_induced_transformer_torch.utils.torch_compat import (
    flax_params_to_state_dict,
)
from position_induced_transformer_tpu import configs as j_configs
from position_induced_transformer_tpu.data import loaders as j_loaders
from position_induced_transformer_tpu.data import meshes as j_meshes
from position_induced_transformer_tpu.data import synthetic as j_syn
from position_induced_transformer_tpu.models import PiT as JPiT
from position_induced_transformer_tpu.models import build_geometry as j_build
from position_induced_transformer_tpu.models.geometry import build_geometry_host
from position_induced_transformer_tpu.ops import metrics as j_metrics
from position_induced_transformer_tpu.train import benchmarks as j_bench
from position_induced_transformer_tpu.train import checkpoint as j_ckpt
from position_induced_transformer_tpu.train import evaluate as j_eval
from position_induced_transformer_tpu.train import loop as j_loop

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
LOSS_RTOL = 2e-4
PARAM_RTOL, PARAM_ATOL = 5e-3, 2e-5
# gradients of a 3-step rollout through 2 x 4 attention ops and the
# instance norms: float32 sums in another order on the two sides, held
# relative to each tensor's largest entry
GRAD_RTOL = 1e-4
MODES = ("full", "dots", "none")
# a rollout feeds each step's output back, and the instance norms scale
# the fields up (|y| up to 7.7 here): the absolute bound is ATOL per unit
# of the trajectory's largest entry. Measured: 1.1e-5 at step 1 (|y| <=
# 4.4), 3.7e-5 at step 3 (|y| <= 7.7), float32 rounding in other orders
rollout_close = lambda got, want: np.testing.assert_allclose(
    got, want, rtol=RTOL, atol=ATOL * float(np.abs(want).max()))


def _narrow(cfg):
    return dataclasses.replace(
        cfg, grid=(16, 16), latent_grid=(8, 8), rollout_steps=3, memory=4, batch_size=8,
        model=dataclasses.replace(cfg.model, hid_dim=16, n_blocks=2, in_dim=4))


T_CFG, J_CFG = _narrow(t_configs.VORTICITY), _narrow(j_configs.VORTICITY)


def _carried(jg) -> Geometry:
    """The JAX geometry as the port's: one threshold source on both sides."""
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))
    return Geometry(mesh_in=t(jg.mesh_in), dist_down=t(jg.dist_down), dist_proc=t(jg.dist_proc),
                    dist_up=t(jg.dist_up), thr_down=t(jg.thr_down), thr_up=t(jg.thr_up))


@pytest.mark.parametrize("n,s,frames,seed", [(3, 16, 7, 0), (2, 64, 4, 3), (4, 9, 30, 1)])
def test_synthetic_vorticity_is_bit_equal(n, s, frames, seed):
    """complex64 einsums in numpy on both sides: equal to the bit."""
    got, want = t_syn.vorticity(n, s, frames, seed), j_syn.vorticity(n, s, frames, seed)
    assert got.dtype == want.dtype == np.float32 and got.shape == (n, s, s, frames)
    np.testing.assert_array_equal(got, want)


def test_loader_reads_the_real_file(tmp_path):
    """The real-file branch on a small ``u`` (n, s, s, T) written here: the
    ``[:memory]`` / ``[memory:memory+steps]`` split of the head and tail
    samples, the frame-count ValueError, and the synthetic fallback."""
    rng = np.random.default_rng(0)
    savemat(tmp_path / "ns.mat", {"u": rng.random((9, 8, 8, 12))})
    path = str(tmp_path / "ns.mat")
    got = t_loaders.vorticity(path, ntrain=5, ntest=3, memory=4, steps=6)
    want = j_loaders.vorticity(path, ntrain=5, ntest=3, memory=4, steps=6)
    assert [a.shape for a in got] == [(5, 8, 8, 4), (5, 8, 8, 6), (3, 8, 8, 4), (3, 8, 8, 6)]
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    for mod in (t_loaders, j_loaders):
        with pytest.raises(ValueError, match="12 frames"):
            mod.vorticity(path, ntrain=5, ntest=3, memory=4, steps=9)
    with pytest.warns(UserWarning, match="SYNTHETIC"):
        got = t_loaders.vorticity(str(tmp_path / "missing.mat"), 3, 2, 4, 3)
    for a, b in zip(got, j_loaders.vorticity(None, 3, 2, 4, 3)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", [(4, 50, 3), (2, 6, 6, 1, 5), (1, 30, 1)])
def test_rollout_metrics_match_jax(shape):
    rng = np.random.default_rng(len(shape))
    true = rng.standard_normal(shape).astype(np.float32)
    pred = true + 0.1 * rng.standard_normal(shape).astype(np.float32)
    t, p = torch.from_numpy(true), torch.from_numpy(pred)
    got = t_metrics.rel_norm_step(t, p)
    assert got.shape == (shape[-1],)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_metrics.rel_norm_step(true, pred)), rtol=1e-6)
    np.testing.assert_allclose(float(t_metrics.rel_norm_traj(t, p)),
                               float(j_metrics.rel_norm_traj(true, pred)), rtol=1e-6)


@pytest.mark.parametrize("s,latent", [(16, 8), (64, 16)])
def test_geometry_matches_the_native_builder(s, latent):
    """The port's device builder ``build_geometry`` on the vorticity
    setup's periodic grids against the JAX setup's ``build_geometry_host``:
    distances and thresholds equal to the bit, so the kept sets are equal
    (0 flips; the Darcy grid's ties do not arise here)."""
    mesh = t_meshes.grid_2d(s, endpoint=False).reshape(-1, 2)
    ltt = t_meshes.grid_2d(latent, endpoint=False).reshape(-1, 2)
    np.testing.assert_array_equal(mesh, j_meshes.grid_2d(s, endpoint=False).reshape(-1, 2))
    tg = t_build(mesh, ltt, mesh, metric="periodic2d", en_loc=0.02, de_loc=0.02, device="cpu")
    jg = build_geometry_host(jnp.asarray(mesh), jnp.asarray(ltt), jnp.asarray(mesh),
                             metric="periodic2d", en_loc=0.02, de_loc=0.02)
    np.testing.assert_array_equal(tg.dist_proc.numpy(), np.asarray(jg.dist_proc))
    flips = {}
    for side in ("down", "up"):
        td, jd = getattr(tg, f"dist_{side}").numpy(), np.asarray(getattr(jg, f"dist_{side}"))
        tt, jt = getattr(tg, f"thr_{side}").numpy(), np.asarray(getattr(jg, f"thr_{side}"))
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tt, jt)
        flips[side] = int(((td <= tt) != (jd <= jt)).sum())
    assert flips == {"down": 0, "up": 0}


@pytest.fixture(scope="module")
def ns_file(tmp_path_factory):
    """A 16^2 trajectory file of 27 samples and 7 frames (memory 4 +
    3 steps), in the layout of the real one (variable ``u``)."""
    path = tmp_path_factory.mktemp("ns") / "ns_16.mat"
    savemat(path, {"u": t_syn.vorticity(n=27, s=16, frames=7, seed=2)})
    return str(path)


@pytest.fixture(scope="module")
def problems(ns_file):
    """The JAX and port problems at the narrow width (16 training and 11
    test samples), JAX-initialised weights in both, the JAX geometry
    carried over."""
    jp = j_bench.setup_vorticity(J_CFG, ns_file, ntrain=16, ntest=11)
    tp = t_bench.setup(T_CFG, ns_file, ntrain=16, ntest=11, device="cpu")
    params = jp.model.init(jax.random.PRNGKey(0), jp.geom, jnp.asarray(jp.train_data["x"][:1]))["params"]
    tp.model.load_state_dict(flax_params_to_state_dict(params))
    tp.geom = _carried(jp.geom)
    return jp, tp, params


def _batch(split, idx):
    return {k: torch.from_numpy(np.asarray(v)[idx]) for k, v in split.items()}


def test_setup_matches_jax(problems):
    jp, tp, _ = problems
    for split in ("train_data", "test_data"):
        jd, td = getattr(jp, split), getattr(tp, split)
        assert set(td) == set(jd) == {"x", "y"}
        for k in ("x", "y"):
            np.testing.assert_array_equal(td[k], np.asarray(jd[k]))
    assert tp.train_data["x"].shape == (16, 256, 4) and tp.train_data["y"].shape == (16, 256, 3)
    assert tp.extras == jp.extras == {"s": 16}
    task = tp.task
    assert (task.rollout_steps, task.swap_loss_args, task.trajectory_loss, task.remat_rollout) == (
        3, True, False, True)


def test_forward_and_rollout_preds_match_jax(problems):
    jp, tp, params = problems
    jb = {k: jnp.asarray(v[:5]) for k, v in jp.test_data.items()}
    tb = _batch(tp.test_data, slice(0, 5))
    with torch.inference_mode():
        one = tp.task.forward(tp.geom, tb)
        pred = tp.task.rollout_preds(tp.geom, tb)
    np.testing.assert_allclose(one.numpy(), np.asarray(jp.task.forward(params, jp.geom, jb)),
                               rtol=RTOL, atol=ATOL)
    want = np.asarray(jp.task.rollout_preds(params, jp.geom, jb))
    assert pred.shape == want.shape == (5, 256, 3)
    rollout_close(pred.numpy(), want)
    # the first step is the one-step forward; the second reads it back
    np.testing.assert_allclose(pred[..., 0].numpy(), one[..., 0].numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("p", [1, 2, 3])
def test_stepwise_rel_matches_jax(swap, p):
    rng = np.random.default_rng(p)
    y = rng.standard_normal((4, 30, 5)).astype(np.float32)
    pred = y + 0.2 * rng.standard_normal((4, 30, 5)).astype(np.float32)
    got = t_loop.Task(model=None, loss_p=p).stepwise_rel(torch.from_numpy(y), torch.from_numpy(pred), swap)
    want = j_loop.Task(model=None, loss_p=p).stepwise_rel(jnp.asarray(y), jnp.asarray(pred), swap)
    assert got.shape == (4, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("trajectory,batch_mean", [(False, False), (True, False), (False, True)])
def test_rollout_loss_conventions_match_jax(problems, trajectory, batch_mean):
    """The torch convention (per-step losses summed) and the trajectory
    mean, each with and without the batch mean."""
    jp, tp, params = problems
    kw = dict(trajectory_loss=trajectory, batch_mean_loss=batch_mean)
    jt = dataclasses.replace(jp.task, **kw)
    tt = dataclasses.replace(tp.task, **kw)
    jb = {k: jnp.asarray(v[:4]) for k, v in jp.train_data.items()}
    with torch.no_grad():
        got = tt.loss_fn(tp.geom, _batch(tp.train_data, slice(0, 4)))
    np.testing.assert_allclose(float(got), float(jt.loss_fn(params, jp.geom, jb)), rtol=RTOL)


def test_remat_modes_and_their_refusal(monkeypatch):
    modes = {True: "full", "full": "full", "dots": "dots", False: "none", "none": "none"}
    for value, mode in modes.items():
        assert t_loop.Task(model=None, remat_rollout=value).remat_mode() == mode
    monkeypatch.setenv("PIT_ROLLOUT_REMAT", "dots")
    assert t_loop.Task(model=None, remat_rollout=False).remat_mode() == "dots"
    monkeypatch.setenv("PIT_ROLLOUT_REMAT", "selective")
    with pytest.raises(ValueError, match="unrecognized PIT_ROLLOUT_REMAT"):
        t_loop.Task(model=None).remat_mode()


def _port_grads(task, geom, batch):
    task.model.zero_grad(set_to_none=True)
    loss = task.loss_fn(geom, batch)
    loss.backward()
    return loss.item(), {k: p.grad.clone() for k, p in task.model.named_parameters()}


def test_gradients_agree_across_remat_modes_and_with_jax(problems):
    """One backward through the 3-step rollout under each remat mode: the
    same gradients in the port (recomputation reruns the same float32
    operations), and against ``jax.grad`` of the JAX loss (full remat)."""
    jp, tp, params = problems
    tb = _batch(tp.train_data, slice(0, 8))
    got = {m: _port_grads(dataclasses.replace(tp.task, remat_rollout=m), tp.geom, tb) for m in MODES}
    for m in MODES[1:]:
        assert got[m][0] == got["full"][0]
        for k, g in got[m][1].items():
            np.testing.assert_allclose(g.numpy(), got["full"][1][k].numpy(), rtol=1e-6,
                                       atol=1e-6 * float(g.abs().max()), err_msg=f"{m} {k}")
    jb = {k: jnp.asarray(v[:8]) for k, v in jp.train_data.items()}
    loss, grads = jax.value_and_grad(jp.task.loss_fn)(params, jp.geom, jb)
    np.testing.assert_allclose(got["full"][0], float(loss), rtol=RTOL)
    want = flax_params_to_state_dict(grads)
    for k, g in got["full"][1].items():
        w = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL, atol=GRAD_RTOL * np.abs(w).max(),
                                   err_msg=k)


def test_three_training_steps_match_jax(problems):
    """Three Adam steps at batch 8 on a cosine schedule over 10, BPTT
    through 3 rollout steps under full remat on both sides."""
    jp, tp, params = problems
    lr, total = 1e-3, 10
    perm = np.array([[0, 1, 2, 3, 4, 5, 6, 7], [8, 9, 10, 11, 12, 13, 14, 15],
                     [3, 12, 5, 0, 9, 14, 7, 1]])
    optimizer = j_loop.make_optimizer(lr, total)
    opt_state = optimizer.init(params)

    @jax.jit
    def step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(jp.task.loss_fn)(params, jp.geom, batch)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    jlosses = []
    for idx in perm:
        params, opt_state, loss = step(params, opt_state, {k: v[idx] for k, v in jp.train_data.items()})
        jlosses.append(float(loss))
    model = TPiT(2, 4, 1, 16, 2, 2, 0.02, 0.02, use_instance_norm=True)
    model.load_state_dict(tp.model.state_dict())
    task = dataclasses.replace(tp.task, model=model)
    state = t_loop.TrainState(model, t_loop.make_optimizer(model.parameters(), lr))
    train_epoch = t_loop.make_train_epoch(task, t_loop.make_lr_schedule(lr, total))
    data = {k: torch.from_numpy(v) for k, v in tp.train_data.items()}
    state, losses = train_epoch(state, tp.geom, data, torch.from_numpy(perm))
    np.testing.assert_allclose(losses.numpy(), jlosses, rtol=LOSS_RTOL)
    want = flax_params_to_state_dict(params)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=k)


def test_rollout_eval_epoch_matches_jax_with_a_padded_tail(problems):
    """11 test samples in batches of 4 (the last batch padded with the
    last sample, masked): ``loss``, ``rel_l2_step`` and ``rel_l2_final``
    sums as JAX gives them, and as the per-sample stepwise errors give."""
    jp, tp, params = problems
    perm = t_loop.eval_permutation(11, 4)
    want = j_loop.make_eval_epoch(jp.task)(
        j_loop.TrainState(params, None, 0), jp.geom,
        {k: jnp.asarray(v) for k, v in jp.test_data.items()}, jnp.asarray(perm.numpy()), 11)
    data = {k: torch.from_numpy(v) for k, v in tp.test_data.items()}
    got = t_loop.make_eval_epoch(tp.task, metrics=t_runner.default_metrics(1))(tp.geom, data, perm, 11)
    assert set(got) == set(want) == {"loss", "rel_l2_step", "rel_l2_final"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL, err_msg=k)
    with torch.inference_mode():
        pred = tp.task.rollout_preds(tp.geom, data)
    rel = tp.task.stepwise_rel(data["y"], pred)
    np.testing.assert_allclose(float(got["rel_l2_step"]), float(rel.mean(-1).sum()), rtol=1e-5)
    np.testing.assert_allclose(float(got["rel_l2_final"]), float(rel[:, -1].sum()), rtol=1e-5)


@pytest.fixture(scope="module")
def trained(tmp_path_factory, ns_file):
    """The port trained two epochs on the CPU (16 / 11 samples), with its
    checkpoint."""
    path = str(tmp_path_factory.mktemp("vorticity") / "vorticity.pt")
    problem, state, history = t_runner.train(T_CFG, ns_file, epochs=2, ntrain=16, ntest=11,
                                             verbose=False, checkpoint_path=path, device="cpu")
    return problem, state, history, path


def test_history_reports_stepwise_metrics_per_step(trained):
    """A rollout run's rows carry ``rel_l2_step`` and ``rel_l2_final``; the
    losses are per rollout step (the summed per-step losses over 3)."""
    problem, state, history, _ = trained
    row = history[-1]
    assert set(row) == {"epoch", "seconds", "train_loss", "loss", "rel_l2_step", "rel_l2_final"}
    assert np.isfinite([row[k] for k in row]).all()
    data = {k: torch.from_numpy(v) for k, v in problem.test_data.items()}
    with torch.inference_mode():
        pred = problem.task.rollout_preds(problem.geom, data)
    rel = problem.task.stepwise_rel(data["y"], pred)
    swapped = problem.task.stepwise_rel(data["y"], pred, swap=True)
    np.testing.assert_allclose(row["rel_l2_step"], float(rel.mean(-1).sum()) / 11, rtol=1e-5)
    np.testing.assert_allclose(row["rel_l2_final"], float(rel[:, -1].sum()) / 11, rtol=1e-5)
    np.testing.assert_allclose(row["loss"], float(swapped.sum()) / 11 / 3, rtol=1e-5)


def test_grad_accum_composes_with_rollouts(ns_file):
    kw = dict(data_path=ns_file, epochs=1, ntrain=16, ntest=8, verbose=False, device="cpu")
    _, s1, h1 = t_runner.train(T_CFG, **kw)
    _, s2, h2 = t_runner.train(T_CFG, grad_accum=2, **kw)
    np.testing.assert_allclose(h2[0]["train_loss"], h1[0]["train_loss"], rtol=1e-5)
    w2 = s2.model.state_dict()
    for k, v in s1.model.state_dict().items():
        np.testing.assert_allclose(w2[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-6, err_msg=k)


def test_evaluate_matches_jax(problems, ns_file, tmp_path):
    """``evaluate`` on the same weights (a JAX checkpoint and a port one):
    the per-step errors, their mean and the trajectory error, and the
    saved predictions; a rollout benchmark refuses the shuffle ablation;
    ``plots_dir`` writes the figures (an ImportError without matplotlib)."""
    _, _, params = problems
    jpath = j_ckpt.save(str(tmp_path / "jax_ckpt"), {"params": params})
    tpath = t_ckpt.save(str(tmp_path / "v.pt"), flax_params_to_state_dict(params), "vorticity")
    kw = dict(data_path=ns_file, ntest=11)
    J, T = dataclasses.replace(J_CFG, ntrain=16), dataclasses.replace(T_CFG, ntrain=16)
    want = j_eval.evaluate(J, jpath, save_pred=str(tmp_path / "j.mat"), **kw)
    got = t_eval.evaluate(T, tpath, save_pred=str(tmp_path / "t.mat"), device="cpu", **kw)
    assert set(got) == set(want)
    assert (got["benchmark"], got["n_test"], got["rollout_steps"], got["zssr"]) == (
        "vorticity", 11, 3, False)
    np.testing.assert_allclose(got["rel_l2_step"], want["rel_l2_step"], rtol=RTOL)
    for k in ("rel_l2_traj", "rel_l2_mean_step"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
    from scipy.io import loadmat

    tm, jm = loadmat(str(tmp_path / "t.mat")), loadmat(str(tmp_path / "j.mat"))
    assert tm["pred"].shape == (11, 256, 1, 3)
    np.testing.assert_array_equal(tm["true"], jm["true"])
    rollout_close(tm["pred"], jm["pred"])
    with pytest.raises(ValueError, match="one-step operator map"):
        t_eval.evaluate(T, tpath, shuffle_ablation=True, device="cpu")
    plots = str(tmp_path / "plots")
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="matplotlib"):
            t_eval.evaluate(T, tpath, plots_dir=plots, device="cpu", **kw)
    else:  # the per-step error curve and the frames, as the JAX package writes them
        again = t_eval.evaluate(T, tpath, plots_dir=plots, device="cpu", **kw)
        assert again["rel_l2_step"] == got["rel_l2_step"]
        files = set(os.listdir(plots))
        assert {"rollout_error.png", "reference_1.pdf", "pred_3.pdf", "err_1.pdf"} <= files


def test_task_rollout_matches_jax(problems):
    """``Task.rollout``: the window fed back (vorticity), equal to the
    unrolled predictions, at a horizon other than the configured one."""
    jp, tp, params = problems
    x = tp.test_data["x"][:3]
    with torch.inference_mode():
        got = tp.task.rollout(tp.geom, torch.from_numpy(x), 5)
        unrolled = tp.task.rollout_preds(tp.geom, _batch(tp.test_data, slice(0, 3)))
    want = np.asarray(jp.task.rollout(params, jp.geom, jnp.asarray(x), 5))
    assert got.shape == want.shape == (3, 256, 1, 5)
    rollout_close(got.numpy(), want)
    np.testing.assert_array_equal(got[:, :, 0, :3].numpy(), unrolled.numpy())


def test_task_rollout_residual_branch_matches_jax():
    """A one-step residual model (as many outputs as inputs, rollout_steps
    0: cylinder's form) on a Burgers-width periodic mesh: the output
    replaces the window."""
    fields = dict(space_dim=1, in_dim=2, out_dim=2, hid_dim=16, n_head=2, n_blocks=2,
                  en_loc=0.1, de_loc=0.1, residual_output=True)
    mesh, ltt = j_meshes.grid_1d(48), j_meshes.grid_1d(12)
    jg = j_build(jnp.asarray(mesh), jnp.asarray(ltt), jnp.asarray(mesh), metric="periodic1d",
                 en_loc=0.1, de_loc=0.1)
    tg = t_build(mesh, ltt, mesh, metric="periodic1d", en_loc=0.1, de_loc=0.1, device="cpu")
    jmodel = JPiT(**fields)
    x = np.random.default_rng(0).standard_normal((3, 48, 2)).astype(np.float32)
    params = jmodel.init(jax.random.PRNGKey(1), jg, jnp.asarray(x[:1]))["params"]
    tmodel = TPiT(**fields)
    tmodel.load_state_dict(flax_params_to_state_dict(params))
    want = np.asarray(j_loop.Task(model=jmodel, out_dim=2).rollout(params, jg, jnp.asarray(x), 4))
    with torch.inference_mode():
        got = t_loop.Task(model=tmodel, out_dim=2).rollout(tg, torch.from_numpy(x), 4)
        second = tmodel(tg, tmodel(tg, torch.from_numpy(x)))
    assert got.shape == want.shape == (3, 48, 2, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[..., 1].numpy(), second.numpy())


def _post(url, body):
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=body, method="POST"),
                                    timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_predictor_infer_and_server_roll_out(trained, ns_file, tmp_path):
    """``Predictor.predict_array(rollout_steps=)``, ``infer`` from a
    ``.mat`` at the default horizon and at 5 steps, and the server's
    ``?rollout_steps=`` (5, 0: one step) and its 400 above the maximum."""
    problem, state, _, path = trained
    x = problem.test_data["x"][:5]
    with torch.inference_mode():
        want = problem.task.rollout(problem.geom, torch.from_numpy(x), 5).numpy()  # (5, 256, 1, 5)
    pred = t_eval.Predictor(T_CFG, path, data_path=ns_file, device="cpu")
    got = pred.predict_array({"x": x}, rollout_steps=5, batch_size=2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pred.predict_array({"x": x}, 3), want[..., :3], rtol=1e-6, atol=1e-7)
    one = pred.predict_array({"x": x})
    assert one.shape == (5, 256, 1)
    savemat(tmp_path / "in.mat", {"x": x.reshape(5, 16, 16, 4)})
    kw = dict(data_path=ns_file, device="cpu")
    res = t_eval.infer(T_CFG, path, str(tmp_path / "in.mat"), output_path=str(tmp_path / "p.npy"), **kw)
    assert res["rollout_steps"] == 3 and res["pred_shape"] == [5, 256, 1, 3]
    np.testing.assert_allclose(np.load(tmp_path / "p.npy"), want[..., :3], rtol=1e-6, atol=1e-7)
    res = t_eval.infer(T_CFG, path, str(tmp_path / "in.mat"), output_path=str(tmp_path / "p5.npy"),
                       rollout_steps=5, **kw)
    assert res["rollout_steps"] == 5
    np.testing.assert_allclose(np.load(tmp_path / "p5.npy"), want, rtol=1e-6, atol=1e-7)

    srv = make_server(T_CFG, path, port=0, verbose=False, **kw)
    assert srv.max_rollout_steps == 100
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        buf = io.BytesIO()
        np.save(buf, x[:2])
        with urllib.request.urlopen(base + "/info", timeout=30) as r:
            assert json.loads(r.read())["rollout_steps"] == 3
        for query, steps in (("", 3), ("?rollout_steps=5", 5), ("?rollout_steps=0", 0)):
            code, body = _post(base + "/predict" + query, buf.getvalue())
            assert code == 200, body
            reply = np.load(io.BytesIO(body))
            if steps:
                np.testing.assert_allclose(reply, want[:2, ..., :steps], rtol=1e-6, atol=1e-7)
            else:
                np.testing.assert_allclose(reply, one[:2], rtol=1e-6, atol=1e-7)
        for bad in ("101", "-1", "two"):
            code, body = _post(base + f"/predict?rollout_steps={bad}", buf.getvalue())
            assert code == 400 and (b"rollout_steps" in body or b"invalid literal" in body), body
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)


def test_server_coalesces_by_horizon():
    """Requests with other horizons never share a device batch."""
    from position_induced_transformer_torch.train.serve import _Request

    x = np.zeros((2, 256, 4), np.float32)
    assert _Request({"x": x}, 3, None).key() != _Request({"x": x}, 5, None).key()
    assert _Request({"x": x}, 3, None).key() == _Request({"x": x[:1]}, 3, None).key()
