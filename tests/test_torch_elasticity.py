"""The elasticity slice of the port against the JAX package, on the CPU:
data, setup, model, three training steps, and deployment with per-sample
clouds.

The model runs at the configuration's width in points (972-point clouds,
in_dim 44, 2 heads, locality 0.02) with a narrow hidden width (16) and two
processor blocks. The JAX side runs its CPU path (materialized distances
and the oracle attention, which needs no band), the port its plain
versions (with the band). Predictions hold at rtol 1e-4 / atol 1e-5 (the
model-level bound of test_torch_model.py); training at losses rtol 2e-4
and weights rtol 5e-3 / atol 2e-5 (test_torch_train.py's bounds: Adam
divides each gradient by its running magnitude).
"""

import dataclasses
import io
import json
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
from position_induced_transformer_tpu.train import benchmarks as j_bench
from position_induced_transformer_tpu.train import loop as j_loop

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
LOSS_RTOL = 2e-4
PARAM_RTOL, PARAM_ATOL = 5e-3, 2e-5
NARROW = ["model.hid_dim=16", "model.n_blocks=2"]


@pytest.mark.parametrize("n,L,seed", [(3, 972, 0), (4, 100, 5)])
def test_synthetic_elasticity_is_bit_equal(n, L, seed):
    for got, want in zip(t_syn.elasticity(n, L, seed), j_syn.elasticity(n, L, seed)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    X, ext, _ = t_syn.elasticity(n, L, seed)
    np.testing.assert_array_equal(t_meshes.angular_sort_perm(ext), j_meshes.angular_sort_perm(ext))


def test_loader_reads_the_real_files(tmp_path):
    """The real-file branch, on files in the reference layout written here:
    rr (42, N), XY (L, 2, N), sigma (L, N)."""
    rng = np.random.default_rng(0)
    N, L = 7, 30
    np.save(tmp_path / "Random_UnitCell_rr_10.npy", rng.random((42, N)))
    np.save(tmp_path / "Random_UnitCell_XY_10.npy", rng.random((L, 2, N)))
    np.save(tmp_path / "Random_UnitCell_sigma_10.npy", rng.random((L, N)))
    got = t_loaders.elasticity(str(tmp_path), ntrain=4, ntest=3, n_points=L)
    want = j_loaders.elasticity(str(tmp_path), ntrain=4, ntest=3, n_points=L)
    assert [a.shape for a in got] == [(4, L, 44), (4, L, 2), (4, L, 1), (3, L, 44), (3, L, 2), (3, L, 1)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.warns(UserWarning, match="SYNTHETIC"):
        t_loaders.elasticity(str(tmp_path / "missing"), ntrain=2, ntest=1, n_points=16)
    with pytest.raises(ValueError, match="ntrain"):
        t_loaders.elasticity(str(tmp_path), ntrain=6, ntest=3, n_points=L)


@pytest.fixture(scope="module")
def problems():
    """The JAX and port elasticity problems at the narrow width, 8 training
    and 4 test samples."""
    j_cfg = j_configs.apply_overrides(j_configs.ELASTICITY, NARROW)
    t_cfg = t_configs.apply_overrides(t_configs.ELASTICITY, NARROW)
    jp = j_bench.setup_elasticity(j_cfg, ntrain=8, ntest=4)
    tp = t_bench.setup(t_cfg, ntrain=8, ntest=4, device="cpu")
    return jp, tp


def test_setup_matches_jax(problems):
    """The same angular sort, thresholds, band starts, width and wrap."""
    jp, tp = problems
    for split in ("train_data", "test_data"):
        jd, td = getattr(jp, split), getattr(tp, split)
        assert set(jd) == set(td) == {"x", "mesh", "y", "thr", "band"}
        for k in ("x", "mesh", "y", "band"):
            np.testing.assert_array_equal(td[k], np.asarray(jd[k]), err_msg=k)
        # XLA's distances may differ by an ulp; the kept sets may not
        np.testing.assert_allclose(td["thr"], np.asarray(jd["thr"]), rtol=1e-6, atol=0)
        m = torch.from_numpy(td["mesh"])
        dist = ((m[:, :, None] - m[:, None]) ** 2).sum(-1)
        assert torch.equal(dist <= torch.from_numpy(td["thr"]),
                           dist <= torch.from_numpy(np.array(jd["thr"])))
        assert (td["thr"] < np.inf).all()
    jb = {k: v[:4] for k, v in jp.train_data.items()}
    tb = {k: torch.from_numpy(v[:4]) for k, v in tp.train_data.items()}
    jg, tg = jp.task.geom_fn(jb), tp.task.geom_fn(tb)
    assert (tg.band_down.width, tg.band_down.wrap) == (jg.band_down.width, jg.band_down.wrap) == (384, 384)
    assert tg.band_up is tg.band_down and tg.dist_proc is None
    assert tg.mesh_ltt is tg.mesh_out is tg.mesh_in
    assert tp.task.geometry_required_keys == ("mesh",)


def test_required_keys_are_declared_or_probed(problems):
    """Predictor's required batch variables: the Task's declaration, or a
    probe of geom_fn, which reads the coordinates as batch["mesh"] and the
    optional thresholds and band starts with .get."""
    _, tp = problems
    assert t_eval._required_geometry_keys(tp) == {"mesh"}
    probed = dataclasses.replace(tp, task=dataclasses.replace(tp.task, geometry_required_keys=None))
    assert t_eval._required_geometry_keys(probed) == {"mesh"}
    fixed = t_bench.setup(t_configs.BURGERS, ntrain=2, ntest=2, device="cpu")
    assert t_eval._required_geometry_keys(fixed) == set()


def _jax_params(jp):
    batch = {k: v[:1] for k, v in jp.train_data.items()}
    return jp.model.init(jax.random.PRNGKey(0), jp.task.geom_fn(batch), batch["x"])["params"]


def test_state_dict_carries_the_elasticity_tree():
    """flax_params_to_state_dict on the full-width elasticity params: the
    encoder MLP takes H * in_dim = 88 features (no mesh concat)."""
    jcfg = j_configs.ELASTICITY
    jp = j_bench.setup_elasticity(jcfg, ntrain=2, ntest=1)
    sd = flax_params_to_state_dict(_jax_params(jp))
    model = t_bench._make_model(t_configs.ELASTICITY)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert sd["en_layer.mlp1.weight"].shape == (256, 88)
    model.load_state_dict(sd)


def test_forward_matches_jax(problems):
    jp, tp = problems
    params = _jax_params(jp)
    tp.model.load_state_dict(flax_params_to_state_dict(params))
    jb = {k: v[:4] for k, v in jp.train_data.items()}
    want = np.asarray(jp.task.forward(params, None, jb))
    with torch.inference_mode():
        got = tp.task.forward(None, {k: torch.from_numpy(v[:4]) for k, v in tp.train_data.items()})
    assert got.shape == want.shape == (4, 972, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # without thresholds and bands the ops compute their own: the same output
    with torch.inference_mode():
        bare = tp.task.forward(None, {k: torch.from_numpy(tp.train_data[k][:4]) for k in ("x", "mesh")})
    np.testing.assert_allclose(bare.numpy(), want, rtol=RTOL, atol=ATOL)


def test_three_training_steps_match_jax(problems):
    """Three Adam steps at batch 4 on a cosine schedule over 10: JAX
    value_and_grad + optax against the port's train epoch (its autograd
    Functions run the plain versions of kernels #7 and #8)."""
    jp, tp = problems
    params = _jax_params(jp)
    tp.model.load_state_dict(flax_params_to_state_dict(params))
    lr, total, B = 1e-3, 10, 4
    perm = np.array([[0, 1, 2, 3], [4, 5, 6, 7], [2, 5, 0, 7]])
    optimizer = j_loop.make_optimizer(lr, total)
    opt_state = optimizer.init(params)

    @jax.jit
    def step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(jp.task.loss_fn)(params, None, batch)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    jlosses = []
    for idx in perm:
        params, opt_state, loss = step(params, opt_state, {k: v[idx] for k, v in jp.train_data.items()})
        jlosses.append(float(loss))

    state = t_loop.TrainState(tp.model, t_loop.make_optimizer(tp.model.parameters(), lr))
    train_epoch = t_loop.make_train_epoch(tp.task, t_loop.make_lr_schedule(lr, total))
    data = {k: torch.from_numpy(v) for k, v in tp.train_data.items()}
    state, losses = train_epoch(state, None, data, torch.from_numpy(perm))
    np.testing.assert_allclose(losses.numpy(), jlosses, rtol=LOSS_RTOL)
    want = flax_params_to_state_dict(params)
    for k, v in tp.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=k)


def test_runner_trains_and_predicts_on_the_cpu(tmp_path):
    cfg = t_configs.apply_overrides(t_configs.ELASTICITY, NARROW + ["batch_size=4"])
    problem, state, history = t_runner.train(
        cfg, epochs=1, ntrain=8, ntest=3, verbose=False, device="cpu",
        checkpoint_path=str(tmp_path / "el.pt"))
    assert state.step == 2 and len(history) == 1
    assert all(np.isfinite(v) for v in history[0].values())
    pred = t_runner.predict(problem)
    assert pred.shape == (3, 972, 1)
    p = t_eval.Predictor(cfg, str(tmp_path / "el.pt"), device="cpu")
    np.testing.assert_allclose(p.predict_array(problem.test_data), pred, rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def served(problems, tmp_path_factory):
    """A narrow elasticity checkpoint behind a Predictor and a server on
    the CPU, and the JAX forward over 5 unsorted synthetic clouds."""
    jp, _ = problems
    params = _jax_params(jp)
    path = str(tmp_path_factory.mktemp("ckpt") / "el.pt")
    t_ckpt.save(path, flax_params_to_state_dict(params), "elasticity")
    X, ext, _ = t_syn.elasticity(n=5, L=972, seed=3)
    perm = np.random.default_rng(0).permutation(972)  # the cloud in any order
    X, ext = X[:, perm], ext[:, perm]
    want = np.asarray(jp.task.forward(params, None, {"x": jnp.asarray(X), "mesh": jnp.asarray(ext)}))
    cfg = t_configs.apply_overrides(t_configs.ELASTICITY, NARROW)
    srv = make_server(cfg, path, port=0, verbose=False, device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield srv, f"http://127.0.0.1:{srv.server_address[1]}", X, ext, want
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _mat(**arrays):
    buf = io.BytesIO()
    savemat(buf, arrays)
    return buf.getvalue()


def test_predictor_takes_mat_with_x_and_mesh(served, tmp_path):
    srv, _, X, ext, want = served
    p = srv.predictor
    assert p.required_keys == {"mesh"}
    for n in (1, 5):
        savemat(tmp_path / "in.mat", {"x": X[:n], "mesh": ext[:n]})
        np.testing.assert_allclose(p.predict_file(str(tmp_path / "in.mat")), want[:n],
                                   rtol=RTOL, atol=ATOL)
    savemat(tmp_path / "nomesh.mat", {"x": X[:2]})
    with pytest.raises(ValueError, match="missing the required variable 'mesh'"):
        p.prepare_file(str(tmp_path / "nomesh.mat"))
    np.save(tmp_path / "x.npy", X[:2])
    with pytest.raises(ValueError, match="bare .npy"):
        p.prepare_file(str(tmp_path / "x.npy"))
    savemat(tmp_path / "bad.mat", {"x": X[:2], "mesh": ext[:2, :100]})
    with pytest.raises(ValueError, match="'mesh' has shape"):
        p.prepare_file(str(tmp_path / "bad.mat"))


def test_server_answers_mat_and_refuses_npy(served):
    srv, base, X, ext, want = served
    code, body = _post(base + "/predict", _mat(x=X[:3], mesh=ext[:3]))
    assert code == 200, body
    np.testing.assert_allclose(np.load(io.BytesIO(body)), want[:3], rtol=RTOL, atol=ATOL)
    buf = io.BytesIO()
    np.save(buf, X[:2])
    code, body = _post(base + "/predict", buf.getvalue())
    assert code == 400 and "mesh" in json.loads(body)["error"]
