"""The NACA slice of the port against the JAX package, on the CPU: the
generator and loader, ``setup_naca`` (the latent slice of each C-grid, the
setup-time thresholds, the plain decoder band), the forward, three
training steps, the input-shuffle ablation of ``evaluate``, and
deployment from ``.mat`` inputs holding the three meshes.

The model runs narrow (hid 16, 2 blocks; 1 head, in_dim 2, out_dim 4 and
locality 0.02 as configured) on a 21 x 11 C-grid with a 5 x 3 latent, as
the JAX package's own NACA tests run it; the setup is also held at the
full 221 x 51 grid and 56 x 13 latent, where the decoder's band saves
work. The setup-time thresholds (``robust_topk_threshold``: the midpoint
of the nearest gap of at least 1e-5 relative) agree with JAX's bit for bit
but on one decoder row in each training split, where two latent points
lie 1.000e-5 apart relative, on the rule's margin, and the distances the
JAX side's compiled code rounds differently fall on its other side: there
JAX keeps one point and the port two (test_setup_at_the_full_grid_...,
the flip counts pinned). The model tests carry the JAX thresholds over.
Predictions hold at rtol 1e-4 / atol 1e-5, training at losses rtol 2e-4
and weights rtol 5e-3 / atol 2e-5 (the bounds of test_torch_train.py).
"""

import dataclasses
import io
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
from position_induced_transformer_torch.data import synthetic as t_syn
from position_induced_transformer_torch.kernels.posatt_batched import band_tile_rows
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
from position_induced_transformer_tpu.data import synthetic as j_syn
from position_induced_transformer_tpu.train import benchmarks as j_bench
from position_induced_transformer_tpu.train import checkpoint as j_ckpt
from position_induced_transformer_tpu.train import evaluate as j_eval
from position_induced_transformer_tpu.train import loop as j_loop

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
LOSS_RTOL = 2e-4
PARAM_RTOL, PARAM_ATOL = 5e-3, 2e-5
MESHES = ("mesh_in", "mesh_ltt", "mesh_out")


def _narrow(cfg):
    return dataclasses.replace(
        cfg, grid=(21, 11), latent_grid=(5, 3), batch_size=4, ntrain=16,
        model=dataclasses.replace(cfg.model, hid_dim=16, n_blocks=2))


T_CFG, J_CFG = _narrow(t_configs.NACA), _narrow(j_configs.NACA)


def _kept_flips(td, jd) -> dict:
    """Per threshold, the (sample, row, column) entries kept on one side
    only; each must sit on the wide-gap rule's margin (its gap to the next
    smaller distance of the row within 1.1e-5 relative)."""
    flips = {}
    for thr, q, k in (("thr_down", "mesh_ltt", "mesh_in"), ("thr_up", "mesh_out", "mesh_ltt")):
        d = ((td[q][:, :, None] - td[k][:, None]) ** 2).sum(-1)
        diff = np.argwhere((d <= td[thr]) != (d <= np.asarray(jd[thr])))
        for b, i, j in diff:
            row = np.sort(d[b, i])
            at = int(np.searchsorted(row, d[b, i, j]))
            assert at > 0 and row[at] - row[at - 1] <= 1.1e-5 * row[at], (thr, b, i, j)
        same = np.ones(td[thr].shape, bool)
        same[tuple(diff[:, :2].T)] = False
        np.testing.assert_allclose(td[thr][same], np.asarray(jd[thr])[same], rtol=1e-6, err_msg=thr)
        flips[thr] = len(diff)
    return flips


@pytest.mark.parametrize("n,n_shape,nx,ny,seed", [(3, 120, 21, 11, 0), (2, 30, 221, 51, 4)])
def test_synthetic_naca_is_bit_equal(n, n_shape, nx, ny, seed):
    got, want = t_syn.naca(n, n_shape, nx, ny, seed), j_syn.naca(n, n_shape, nx, ny, seed)
    shapes = [(n, n_shape, 2), (n, nx, ny, 2), (n, nx, ny, 4)]
    for a, b, shape in zip(got, want, shapes):
        assert a.dtype == b.dtype == np.float32 and a.shape == shape
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(-1, 2, (5, 7)), rng.uniform(-0.6, 0.6, (5, 7))
    params = [rng.uniform(-0.1, 0.2, (5, 1)) for _ in range(4)]
    np.testing.assert_array_equal(t_syn._naca_field(x, y, *params), j_syn._naca_field(x, y, *params))


def test_loader_reads_the_real_files(tmp_path):
    """The real-file branch on the four ``.npy`` files written here in the
    reference layout (X and Y (N, nx, ny), Q (N, 5, nx, ny)): targets are
    Q's channels 0-3, channels last; a missing file falls back to the
    synthetic data with a warning."""
    rng = np.random.default_rng(0)
    N, nx, ny = 7, 9, 5
    np.save(tmp_path / "shape_coords.npy", rng.random((N, 12, 2)))
    np.save(tmp_path / "NACA_Cylinder_X.npy", rng.random((N, nx, ny)))
    np.save(tmp_path / "NACA_Cylinder_Y.npy", rng.random((N, nx, ny)))
    np.save(tmp_path / "NACA_Cylinder_Q.npy", rng.random((N, 5, nx, ny)))
    got = t_loaders.naca(str(tmp_path), ntrain=4, ntest=3, nx=nx, ny=ny)
    want = j_loaders.naca(str(tmp_path), ntrain=4, ntest=3, nx=nx, ny=ny)
    assert [a.shape for a in got] == [(4, 12, 2), (4, nx, ny, 2), (4, nx, ny, 4),
                                      (3, 12, 2), (3, nx, ny, 2), (3, nx, ny, 4)]
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    (tmp_path / "NACA_Cylinder_Q.npy").unlink()
    with pytest.warns(UserWarning, match="SYNTHETIC"):
        got = t_loaders.naca(str(tmp_path), ntrain=3, ntest=2, nx=21, ny=11)
    for a, b in zip(got, j_loaders.naca(None, ntrain=3, ntest=2, nx=21, ny=11)):
        np.testing.assert_array_equal(a, b)


def test_setup_at_the_full_grid_matches_jax():
    """221 x 51 C-grids (11,271 points), 56 x 13 latent slices (728), 2 + 2
    samples: the same meshes bit for bit, ``x`` the same array as
    ``mesh_in``, thresholds within rounding and equal kept sets but for one
    decoder entry of the training split on the wide-gap margin, and the
    same decoder band (starts and width, one width for both splits, tiles
    of ``band_tile_rows(11271)`` = 256 rows; no encoder band)."""
    cfg_t = dataclasses.replace(t_configs.NACA, ntrain=2, ntest=2)
    cfg_j = dataclasses.replace(j_configs.NACA, ntrain=2, ntest=2)
    tp, jp = t_bench.setup(cfg_t, device="cpu"), j_bench.setup_naca(cfg_j)
    assert band_tile_rows(11271) == 256
    for split in ("train_data", "test_data"):
        td, jd = getattr(tp, split), getattr(jp, split)
        assert set(td) == set(jd) == {"x", *MESHES, "y", "thr_down", "thr_up", "band_up"}
        assert td["x"] is td["mesh_in"]
        assert td["mesh_ltt"].shape == (2, 728, 2) and td["mesh_out"].shape == (2, 11271, 2)
        for k in ("x", *MESHES, "y"):
            np.testing.assert_array_equal(td[k], np.asarray(jd[k]), err_msg=k)
        X = td["mesh_out"].reshape(2, 221, 51, 2)
        np.testing.assert_array_equal(td["mesh_ltt"],
                                      X[:, ::4, ::4][:, :56, :13].reshape(2, -1, 2))
        flips = _kept_flips(td, jd)
        assert flips == {"thr_down": 0, "thr_up": int(split == "train_data")}, flips
        np.testing.assert_array_equal(td["band_up"], np.asarray(jd["band_up"]))
        assert td["band_up"].shape == (2, 45)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in tp.train_data.items()}
    tg = tp.task.geom_fn(batch)
    jg = jp.task.geom_fn({k: jnp.asarray(v) for k, v in jp.train_data.items()})
    assert tg.band_down is None and jg.band_down is None
    assert tg.band_up.width == jg.band_up.width and tg.band_up.wrap == 0
    assert tg.band_up.width < 728
    torch.testing.assert_close(tg.thr_up, batch["thr_up"], rtol=0, atol=0)
    assert tp.task.geometry_required_keys == jp.task.geometry_required_keys == MESHES


@pytest.fixture(scope="module")
def problems():
    """The JAX and port problems at the narrow width (16 training and 8 test
    samples), with JAX-initialised weights in both and the JAX thresholds
    carried over."""
    jp = j_bench.setup_naca(J_CFG, ntrain=16, ntest=8)
    tp = t_bench.setup(T_CFG, ntrain=16, ntest=8, device="cpu")
    for split in ("train_data", "test_data"):
        td, jd = getattr(tp, split), getattr(jp, split)
        assert _kept_flips(td, jd) == {"thr_down": 0, "thr_up": int(split == "train_data")}
        for k in ("thr_down", "thr_up"):
            td[k] = np.array(jd[k])
    jb = {k: jnp.asarray(v[:1]) for k, v in jp.train_data.items()}
    params = jp.model.init(jax.random.PRNGKey(0), jp.task.geom_fn(jb), jb["x"])["params"]
    tp.model.load_state_dict(flax_params_to_state_dict(params))
    return jp, tp, params


def test_setup_matches_jax(problems):
    jp, tp, _ = problems
    for split in ("train_data", "test_data"):
        jd, td = getattr(jp, split), getattr(tp, split)
        assert set(td) == set(jd)
        for k in ("x", *MESHES, "y"):
            np.testing.assert_array_equal(td[k], np.asarray(jd[k]), err_msg=k)
    assert tp.train_data["mesh_ltt"].shape == (16, 15, 2)
    assert tp.train_data["mesh_out"].shape == (16, 231, 2)
    g = tp.task.geom_fn({k: torch.from_numpy(np.asarray(v[:4])) for k, v in tp.train_data.items()})
    assert g.dist_down is None and g.mesh_ltt.shape[1] == 15 and g.mesh_out.shape[1] == 231


def test_forward_matches_jax(problems):
    jp, tp, params = problems
    jb = {k: jnp.asarray(v) for k, v in jp.test_data.items()}
    want = np.asarray(jp.task.forward(params, None, jb))
    with torch.inference_mode():
        got = tp.task.forward(None, {k: torch.from_numpy(np.asarray(v)) for k, v in tp.test_data.items()})
    assert got.shape == want.shape == (8, 231, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # a deployment batch (no thresholds): computed per step, the same kept sets
    with torch.inference_mode():
        bare = tp.task.forward(None, {k: torch.from_numpy(np.asarray(tp.test_data[k]))
                                      for k in ("x", *MESHES)})
    np.testing.assert_allclose(bare.numpy(), want, rtol=RTOL, atol=ATOL)


def test_three_training_steps_match_jax(problems):
    """Three Adam steps at batch 4 on a cosine schedule over 10."""
    jp, tp, params = problems
    lr, total = 1e-3, 10
    perm = np.array([[0, 1, 2, 3], [4, 5, 6, 7], [9, 2, 14, 11]])
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
    model = t_bench._make_model(T_CFG)
    model.load_state_dict(tp.model.state_dict())
    task = dataclasses.replace(tp.task, model=model)
    state = t_loop.TrainState(model, t_loop.make_optimizer(model.parameters(), lr))
    train_epoch = t_loop.make_train_epoch(task, t_loop.make_lr_schedule(lr, total))
    data = {k: torch.from_numpy(np.asarray(v)) for k, v in tp.train_data.items()}
    state, losses = train_epoch(state, None, data, torch.from_numpy(perm))
    np.testing.assert_allclose(losses.numpy(), jlosses, rtol=LOSS_RTOL)
    want = flax_params_to_state_dict(params)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=k)


def test_shuffle_perm_matches_jax():
    for n in (2, 5, 8, 31):
        perm = t_eval._shuffle_perm(n)
        np.testing.assert_array_equal(perm, j_eval._shuffle_perm(n))
        assert (perm != np.arange(n)).all() and sorted(perm) == list(range(n))
    with pytest.raises(ValueError, match=">= 2 test samples"):
        t_eval._shuffle_perm(1)


def test_evaluate_with_shuffle_ablation_matches_jax(problems, tmp_path):
    """``evaluate(shuffle_ablation=True)`` on the same weights (a JAX and a
    port checkpoint): the metrics, and the rel-L2 with true and with
    shuffled inputs (the shapes move with their inputs, the encoder
    thresholds are recomputed for the new pairing)."""
    _, _, params = problems
    jpath = j_ckpt.save(str(tmp_path / "jax_ckpt"), {"params": params})
    tpath = t_ckpt.save(str(tmp_path / "n.pt"), flax_params_to_state_dict(params), "naca")
    want = j_eval.evaluate(J_CFG, jpath, ntest=8, shuffle_ablation=True)
    got = t_eval.evaluate(T_CFG, tpath, ntest=8, shuffle_ablation=True, device="cpu")
    assert set(got) == set(want) - {"rel_l1_quartiles"} | {"rel_l1_quartiles"}
    for k in ("rel_l1", "rel_l2", "rel_max"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
    abl, jabl = got["shuffle_ablation"], want["shuffle_ablation"]
    assert set(abl) == set(jabl) == {"true_relL2", "shuffled_inputs_relL2"}
    for k in abl:  # both sides round these to 6 decimals
        np.testing.assert_allclose(abl[k], jabl[k], rtol=RTOL, atol=2e-6, err_msg=k)
    np.testing.assert_allclose(abl["true_relL2"], got["rel_l2"], rtol=1e-3)
    assert abl["shuffled_inputs_relL2"] != abl["true_relL2"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("naca") / "naca.pt")
    problem, state, history = t_runner.train(T_CFG, epochs=1, ntrain=16, ntest=8, verbose=False,
                                             checkpoint_path=path, device="cpu")
    return problem, path


def test_predictor_infer_and_server_take_mat_with_the_meshes(trained, tmp_path):
    """A ``.mat`` holding ``x`` and the three meshes (no thresholds: they
    are computed per call) through ``Predictor``, ``infer`` and the server
    gives ``runner.predict`` on the test split; a bare ``.npy`` or a
    ``.mat`` without ``mesh_out`` gets 400."""
    problem, path = trained
    want = t_runner.predict(problem)
    d = problem.test_data
    savemat(tmp_path / "in.mat", {k: d[k] for k in ("x", *MESHES)})
    pred = t_eval.Predictor(T_CFG, path, device="cpu")
    assert pred.required_keys == frozenset(MESHES)
    np.testing.assert_allclose(pred.predict_file(str(tmp_path / "in.mat")), want, rtol=RTOL, atol=ATOL)
    res = t_eval.infer(T_CFG, path, str(tmp_path / "in.mat"), output_path=str(tmp_path / "p.npy"),
                       device="cpu")
    assert res["pred_shape"] == [8, 231, 4] and res["rollout_steps"] == 0
    np.testing.assert_allclose(np.load(tmp_path / "p.npy"), want, rtol=RTOL, atol=ATOL)
    srv = make_server(T_CFG, path, port=0, verbose=False, device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/predict"

    def post(body):
        try:
            with urllib.request.urlopen(urllib.request.Request(url, data=body, method="POST"),
                                        timeout=60) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    try:
        buf = io.BytesIO()
        savemat(buf, {k: d[k][2:7] for k in ("x", *MESHES)})
        code, body = post(buf.getvalue())
        assert code == 200, body
        np.testing.assert_allclose(np.load(io.BytesIO(body)), want[2:7], rtol=RTOL, atol=ATOL)
        npy = io.BytesIO()
        np.save(npy, d["x"][:2])
        code, body = post(npy.getvalue())
        assert code == 400 and b"mesh_in" in body
        buf = io.BytesIO()
        savemat(buf, {k: d[k][:2] for k in ("x", "mesh_in", "mesh_ltt")})
        code, body = post(buf.getvalue())
        assert code == 400 and b"mesh_out" in body
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
