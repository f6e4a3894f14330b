"""The cylinder slice of the port against the JAX package, on the CPU: the
generator and the loader, the geometry against the native builder, the
one-step forward and two training steps (the swapped loss arguments of
rel-L2), ``evaluate``'s one-step metrics and its closed-loop 10-step
rollout of the raw test trajectories, and ``Predictor``'s one-step and
10-step replies (the model's output fed back as its input).

The model runs narrow (hid 32, 2 blocks; 1 head, locality 0.01/0.01 and
the residual output as configured) on a 300-point synthetic cloud down to
a 64-point latent cloud, batch 10. Both setups build their geometry with
their package's ``build_geometry_host`` (the native builder, equal to the
bit: test_torch_host_geometry.py); the port's device builder's distances
differ from it by an ulp, and its kept sets are equal (0 flips here and at
the full 4390 -> 896). Predictions hold at rtol 1e-4 / atol 1e-5 (a rollout:
atol 1e-5 per unit of its largest entry), training at losses rtol 2e-4
and weights rtol 5e-3 / atol 2e-5, metrics at rtol 1e-4.
"""

import dataclasses
import io
import threading
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
from position_induced_transformer_torch.data import synthetic as t_syn
from position_induced_transformer_torch.models import Geometry
from position_induced_transformer_torch.models import build_geometry as t_build
from position_induced_transformer_torch.train import benchmarks as t_bench
from position_induced_transformer_torch.train import checkpoint as t_ckpt
from position_induced_transformer_torch.train import evaluate as t_eval
from position_induced_transformer_torch.train import loop as t_loop
from position_induced_transformer_torch.train import runner as t_runner
from position_induced_transformer_torch.train.serve import make_server
from position_induced_transformer_torch.utils.torch_compat import flax_params_to_state_dict
from position_induced_transformer_tpu import configs as j_configs
from position_induced_transformer_tpu.data import loaders as j_loaders
from position_induced_transformer_tpu.data import synthetic as j_syn
from position_induced_transformer_tpu.models.geometry import build_geometry_host
from position_induced_transformer_tpu.train import benchmarks as j_bench
from position_induced_transformer_tpu.train import checkpoint as j_ckpt
from position_induced_transformer_tpu.train import evaluate as j_eval
from position_induced_transformer_tpu.train import loop as j_loop
from position_induced_transformer_tpu.utils.torch_compat import torch_state_dict_to_flax

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
LOSS_RTOL = 2e-4
PARAM_RTOL, PARAM_ATOL = 5e-3, 2e-5
METRIC_RTOL = 1e-4
CLOUD = {"n_points": 300, "n_latent": 64}
NTRAIN, NTEST = 40, 25  # 4 and 3 trajectories; 30 test pairs cut to 25
rollout_close = lambda got, want: np.testing.assert_allclose(
    got, want, rtol=RTOL, atol=ATOL * float(np.abs(want).max()))


def _narrow(cfg):
    return dataclasses.replace(cfg, batch_size=10, ntrain=NTRAIN, ntest=NTEST,
                               model=dataclasses.replace(cfg.model, hid_dim=32, n_blocks=2))


T_CFG, J_CFG = _narrow(t_configs.CYLINDER), _narrow(j_configs.CYLINDER)


def _carried(jg) -> Geometry:
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))
    return Geometry(mesh_in=t(jg.mesh_in), dist_down=t(jg.dist_down), dist_proc=t(jg.dist_proc),
                    dist_up=t(jg.dist_up), thr_down=t(jg.thr_down), thr_up=t(jg.thr_up))


@pytest.mark.parametrize("n,L,small,steps,seed", [(3, 300, 64, 11, 0), (2, 4390, 896, 4, 1)])
def test_synthetic_cylinder_is_bit_equal(n, L, small, steps, seed):
    got = t_syn.cylinder(n, L, small, steps, seed)
    want = j_syn.cylinder(n, L, small, steps, seed)
    assert got[0].shape == (n, L, 3, steps) and got[2].shape == (small, 2)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_loader_reads_the_real_files(tmp_path):
    """The real-file branch on small files written here (``trajectories``
    in two ``.mat`` files, the two vertex CSVs, 1-based ``elements.csv``):
    10 one-step pairs a trajectory, the raw test trajectories, 0-based
    elements; the Delaunay stand-in without ``elements.csv``; the
    too-few-trajectories ValueError; the synthetic fallback."""
    rng = np.random.default_rng(2)
    savemat(tmp_path / "tr.mat", {"trajectories": rng.random((4, 50, 3, 11)).astype(np.float32)})
    savemat(tmp_path / "te.mat", {"trajectories": rng.random((2, 50, 3, 11)).astype(np.float32)})
    np.savetxt(tmp_path / "v.csv", rng.random((50, 2)), delimiter=",")
    np.savetxt(tmp_path / "vs.csv", rng.random((10, 2)), delimiter=",")
    np.savetxt(tmp_path / "e.csv", rng.integers(1, 51, (20, 3)), delimiter=",", fmt="%d")
    paths = [str(tmp_path / f) for f in ("tr.mat", "te.mat", "v.csv", "vs.csv")]
    for elements in (str(tmp_path / "e.csv"), None):
        got = t_loaders.cylinder(*paths, ntrain=4, ntest=2, elements_path=elements)
        want = j_loaders.cylinder(*paths, ntrain=4, ntest=2, elements_path=elements)
        assert [a.shape for a in got[:4]] == [(40, 50, 3)] * 2 + [(20, 50, 3)] * 2
        assert got[6].shape == (2, 50, 3, 11)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    elements = t_loaders.cylinder(*paths, ntrain=4, ntest=2, elements_path=str(tmp_path / "e.csv"))[7]
    np.testing.assert_array_equal(elements, np.loadtxt(tmp_path / "e.csv", delimiter=",") - 1)
    x_tr, y_tr = got[0], got[1]
    traj = t_loaders.load_mat(paths[0])["trajectories"]
    np.testing.assert_array_equal(x_tr[12], traj[1, :, :, 2])
    np.testing.assert_array_equal(y_tr[12], traj[1, :, :, 3])
    with pytest.raises(ValueError, match="requested 5/2"):
        t_loaders.cylinder(*paths, ntrain=5, ntest=2)
    with pytest.warns(UserWarning, match="SYNTHETIC"):
        got = t_loaders.cylinder(str(tmp_path / "missing.mat"), None, None, None, 2, 1, 80, 16)
    for a, b in zip(got, j_loaders.cylinder(None, None, None, None, 2, 1, 80, 16)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("L,small", [(300, 64), (4390, 896)])
def test_geometry_keeps_the_native_builders_sets(L, small):
    """The port's device builder ``build_geometry`` on the cylinder
    setup's clouds (Euclidean, locality 0.01) against the JAX package's
    ``build_geometry_host``: distances
    within an ulp, thresholds within 1e-8, the kept sets equal."""
    _, mesh, ltt = t_syn.cylinder(1, L, small)
    tg = t_build(mesh, ltt, mesh, metric="euclidean", en_loc=0.01, de_loc=0.01, device="cpu")
    jg = build_geometry_host(jnp.asarray(mesh), jnp.asarray(ltt), jnp.asarray(mesh),
                             metric="euclidean", en_loc=0.01, de_loc=0.01)
    np.testing.assert_allclose(tg.dist_proc.numpy(), np.asarray(jg.dist_proc), rtol=0, atol=1e-6)
    flips = {}
    for side in ("down", "up"):
        td, jd = getattr(tg, f"dist_{side}").numpy(), np.asarray(getattr(jg, f"dist_{side}"))
        tt, jt = getattr(tg, f"thr_{side}").numpy(), np.asarray(getattr(jg, f"thr_{side}"))
        np.testing.assert_allclose(td, jd, rtol=0, atol=1e-6)
        np.testing.assert_allclose(tt, jt, rtol=0, atol=1e-8)
        flips[side] = int(((td <= tt) != (jd <= jt)).sum())
    assert flips == {"down": 0, "up": 0}


@pytest.fixture(scope="module")
def problems():
    """The JAX and port problems on the narrow cloud, JAX-initialised
    weights in both, the JAX geometry carried over."""
    jp = j_bench.setup_cylinder(J_CFG, None, ntrain=NTRAIN, ntest=NTEST, **CLOUD)
    tp = t_bench.setup(T_CFG, ntrain=NTRAIN, ntest=NTEST, device="cpu", **CLOUD)
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
    assert (tp.n_train, tp.n_test) == (jp.n_train, jp.n_test) == (NTRAIN, NTEST)
    assert tp.train_data["x"].shape == (NTRAIN, 300, 3)
    assert set(tp.extras) == set(jp.extras) == {"test_trajectories", "elements"}
    assert tp.extras["test_trajectories"].shape == (3, 300, 3, 11)
    for k in tp.extras:
        np.testing.assert_array_equal(tp.extras[k], np.asarray(jp.extras[k]))
    task = tp.task
    assert (task.loss_p, task.out_dim, task.swap_loss_args, task.rollout_steps) == (2, 3, True, 0)
    assert tp.model.residual_output


def test_forward_matches_jax(problems):
    jp, tp, params = problems
    jb = {k: jnp.asarray(v[:7]) for k, v in jp.test_data.items()}
    with torch.inference_mode():
        got = tp.task.forward(tp.geom, _batch(tp.test_data, slice(0, 7)))
    want = np.asarray(jp.task.forward(params, jp.geom, jb))
    assert got.shape == want.shape == (7, 300, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_two_training_steps_match_jax(problems):
    """Two Adam steps at batch 10 on a cosine schedule over 8; the loss is
    rel-L2 with swapped arguments (normalised by the prediction)."""
    jp, tp, params = problems
    lr, total = 1e-3, 8
    perm = np.array([[3, 17, 0, 25, 9, 31, 12, 38, 5, 22], [1, 2, 4, 6, 7, 8, 10, 11, 13, 14]])
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
    model = t_bench._make_model(T_CFG)
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


def _checkpoints(params, tmp_path):
    jpath = j_ckpt.save(str(tmp_path / "jax_ckpt"), {"params": params})
    tpath = t_ckpt.save(str(tmp_path / "c.pt"), flax_params_to_state_dict(params), "cylinder")
    return jpath, tpath


def test_evaluate_matches_jax(problems, tmp_path):
    """``evaluate`` on the same weights, each side on its own geometry:
    the one-step metrics and quartiles, and the closed-loop rollout of the
    3 raw test trajectories over 10 steps (``rollout_rel_l2_step``, its
    mean); the saved predictions."""
    _, _, params = problems
    jpath, tpath = _checkpoints(params, tmp_path)
    kw = dict(ntest=NTEST, setup_kwargs=CLOUD)
    want = j_eval.evaluate(J_CFG, jpath, save_pred=str(tmp_path / "j.mat"), **kw)
    got = t_eval.evaluate(T_CFG, tpath, save_pred=str(tmp_path / "t.mat"), device="cpu", **kw)
    assert set(got) == set(want)
    assert (got["benchmark"], got["n_test"], got["zssr"], got["rollout_steps"]) == (
        "cylinder", NTEST, False, 10)
    assert len(got["rollout_rel_l2_step"]) == 10
    for k in ("rel_l1", "rel_l2", "rel_max", "rollout_rel_l2_mean"):
        np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL, err_msg=k)
    for k in ("rel_l1_quartiles", "rollout_rel_l2_step"):
        np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL, err_msg=k)
    from scipy.io import loadmat

    tm, jm = loadmat(str(tmp_path / "t.mat")), loadmat(str(tmp_path / "j.mat"))
    np.testing.assert_array_equal(tm["true"], jm["true"])
    np.testing.assert_allclose(tm["pred"], jm["pred"], rtol=RTOL, atol=ATOL)


def test_predictor_one_step_and_rollout_match_jax(problems, tmp_path):
    """``Predictor`` and ``infer``: one-step replies, and 10-step rollouts
    (the model's output fed back: (n, L, 3, 10)) against the JAX
    Predictor; the served ``?rollout_steps=10`` reply equal to ``infer``'s
    bits."""
    jp, _, params = problems
    jpath, tpath = _checkpoints(params, tmp_path)
    x = np.asarray(jp.test_data["x"][:13])
    jpred = j_eval.Predictor(J_CFG, jpath, setup_kwargs=CLOUD)
    tpred = t_eval.Predictor(T_CFG, tpath, setup_kwargs=CLOUD, device="cpu")
    for steps in (0, 10):
        got = tpred.predict_array({"x": x}, steps)
        want = jpred.predict_array({"x": jnp.asarray(x)}, steps)
        assert got.shape == want.shape == ((13, 300, 3, 10) if steps else (13, 300, 3))
        rollout_close(got, np.asarray(want))
    inp, out = str(tmp_path / "x.npy"), str(tmp_path / "y.npy")
    np.save(inp, x[:3])
    res = t_eval.infer(T_CFG, tpath, inp, output_path=out, rollout_steps=10, setup_kwargs=CLOUD,
                       device="cpu")
    assert res["pred_shape"] == [3, 300, 3, 10] and res["rollout_steps"] == 10
    by_infer = np.load(out)
    srv = make_server(T_CFG, tpath, port=0, verbose=False, setup_kwargs=CLOUD, device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        buf = io.BytesIO()
        np.save(buf, x[:3])
        url = f"http://127.0.0.1:{srv.server_address[1]}/predict"
        replies = []
        for query in ("", "?rollout_steps=10"):
            req = urllib.request.Request(url + query, data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                replies.append(np.load(io.BytesIO(r.read())))
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    assert replies[0].shape == (3, 300, 3)
    np.testing.assert_array_equal(replies[1], by_infer)
    np.testing.assert_array_equal(replies[0], by_infer[..., 0])


def test_runner_trains_cylinder_and_evaluate_agrees_with_jax(tmp_path):
    """``runner.train("cylinder", device="cpu")`` end to end on the narrow
    cloud (2 epochs of 4 steps; finite rows with the one-step metrics), and
    ``evaluate`` of its checkpoint against the JAX ``evaluate`` of the same
    weights."""
    path = str(tmp_path / "trained.pt")
    problem, state, history = t_runner.train(
        T_CFG, epochs=2, verbose=False, checkpoint_path=path, setup_kwargs=CLOUD, device="cpu")
    assert state.step == 8 and len(history) == 2
    assert set(history[-1]) == {"epoch", "seconds", "train_loss", "rel_l1", "rel_l2", "rel_max"}
    assert np.isfinite([v for row in history for v in row.values()]).all()
    sd = {k: v.numpy() for k, v in t_ckpt.restore(path)["state_dict"].items()}
    jpath = j_ckpt.save(str(tmp_path / "jax_ckpt"), {"params": torch_state_dict_to_flax(sd)})
    want = j_eval.evaluate(J_CFG, jpath, ntest=NTEST, setup_kwargs=CLOUD)
    got = t_eval.evaluate(T_CFG, path, ntest=NTEST, setup_kwargs=CLOUD, device="cpu")
    for k in ("rel_l1", "rel_l2", "rel_max", "rollout_rel_l2_mean"):
        np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL, err_msg=k)
    np.testing.assert_allclose(got["rollout_rel_l2_step"], want["rollout_rel_l2_step"],
                               rtol=METRIC_RTOL)
