"""The Darcy slice of the port against the JAX package, on the CPU: the
2-D grid, the generator and loader, the per-pixel normalizer and its
resize, the quartile metric, the geometry, the forward, three training
steps, evaluation with zero-shot super-resolution (ZSSR), checkpoints that
carry the normalizer statistics, and deployment at the ZSSR resolution.

The model runs narrow (hid 16, 2 blocks; 2 heads and the 16^2 latent grid
as configured) on the 11^2 grid (``downsampling=40``); ZSSR evaluates on
the 22^2 grid (``downsampling=20``). Both setups build their geometry
with their package's ``build_geometry_host`` (one C++ builder, compiled
alike), so the distances and thresholds are equal to the bit and the kept
sets equal at every resolution (test_geometry_kept_sets_against_jax), and
each side runs on its own geometry. Predictions hold at rtol 1e-4 / atol
1e-5 (test_torch_model.py's bound), training at losses rtol 2e-4 and
weights rtol 5e-3 / atol 2e-5 (test_torch_train.py's).
"""

import dataclasses
import io
import threading
import time
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
from position_induced_transformer_torch.ops.metrics import rel_l1_quartiles as t_quartiles
from position_induced_transformer_torch.ops.normalization import PixelWiseNormalizer as TNorm
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
from position_induced_transformer_tpu.data import native as j_native
from position_induced_transformer_tpu.data import synthetic as j_syn
from position_induced_transformer_tpu.ops.metrics import rel_l1_quartiles as j_quartiles
from position_induced_transformer_tpu.ops.normalization import PixelWiseNormalizer as JNorm
from position_induced_transformer_tpu.train import benchmarks as j_bench
from position_induced_transformer_tpu.train import checkpoint as j_ckpt
from position_induced_transformer_tpu.train import evaluate as j_eval
from position_induced_transformer_tpu.train import loop as j_loop

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
LOSS_RTOL = 2e-4
PARAM_RTOL, PARAM_ATOL = 5e-3, 2e-5
NORM_RTOL, NORM_ATOL = 1e-6, 1e-6
TRAIN_DS, ZSSR_DS = 40, 20  # 11^2 and 22^2


def _narrow(cfg):
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, hid_dim=16, n_blocks=2))


T_CFG, J_CFG = _narrow(t_configs.DARCY), _narrow(j_configs.DARCY)


@pytest.fixture(scope="module", autouse=True)
def _jax_native_library():
    """The JAX package builds its native library with make at first use, and
    test processes started together can race on that build: wait until the
    library loads in this process."""
    for _ in range(60):
        if j_native.load() is not None:
            return
        j_native._lib = False  # not built yet: try again
        time.sleep(1)
    pytest.fail("the JAX package's native geometry library did not build")


@pytest.mark.parametrize("s,endpoint", [(11, True), (16, True), (43, True), (8, False)])
def test_grid_2d_is_bit_equal(s, endpoint):
    got, want = t_meshes.grid_2d(s, endpoint), j_meshes.grid_2d(s, endpoint)
    assert got.dtype == want.dtype and got.shape == (s, s, 2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,s,seed", [(3, 43, 0), (5, 11, 7), (2, 22, 1)])
def test_synthetic_darcy_is_bit_equal(n, s, seed):
    for got, want in zip(t_syn.darcy(n, s, seed), j_syn.darcy(n, s, seed)):
        assert got.dtype == want.dtype and got.shape == (n, s, s, 1)
        np.testing.assert_array_equal(got, want)
    rng_t, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
    np.testing.assert_array_equal(t_syn._grf_modes(rng_t, n), j_syn._grf_modes(rng_j, n))
    amp = j_syn._grf_modes(np.random.default_rng(seed), n)
    np.testing.assert_array_equal(t_syn._eval_modes(amp, s, extra_damp=1.0),
                                  j_syn._eval_modes(amp, s, extra_damp=1.0))


def test_synthetic_darcy_is_one_field_at_every_resolution():
    """The property ZSSR rests on: the 43^2 grid is every 10th point of the
    421^2 one."""
    x43, y43 = t_syn.darcy(n=2, s=43)
    x421, y421 = t_syn.darcy(n=2, s=421)
    np.testing.assert_allclose(x43, x421[:, ::10, ::10], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(y43, y421[:, ::10, ::10], rtol=1e-5, atol=1e-6)


def test_loader_reads_the_two_real_files(tmp_path):
    """The real-file branch on a pair of small 421^2 files written here:
    every ``downsampling``-th point, training split from the head of the
    first file, test split from the head of the second."""
    rng = np.random.default_rng(0)
    for name, n in (("train.mat", 5), ("test.mat", 4)):
        savemat(tmp_path / name, {"coeff": rng.random((n, 421, 421)), "sol": rng.random((n, 421, 421))})
    tr, te = str(tmp_path / "train.mat"), str(tmp_path / "test.mat")
    for ds in (TRAIN_DS, 84):
        got = t_loaders.darcy(tr, te, ds, ntrain=3, ntest=2)
        want = j_loaders.darcy(tr, te, ds, ntrain=3, ntest=2)
        s = 420 // ds + 1
        assert [a.shape for a in got] == [(3, s, s, 1), (3, s, s, 1), (2, s, s, 1), (2, s, s, 1)]
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="requested 6"):
        t_loaders.darcy(tr, te, TRAIN_DS, ntrain=6, ntest=2)
    with pytest.warns(UserWarning, match="SYNTHETIC"):
        got = t_loaders.darcy(str(tmp_path / "missing.mat"), te, TRAIN_DS, ntrain=3, ntest=2)
    for a, b in zip(got, j_loaders.darcy(None, None, TRAIN_DS, ntrain=3, ntest=2)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("target", [(1, 22, 22, 1), (1, 21, 21, 1), (1, 43, 43, 1), (1, 5, 5, 1),
                                    (1, 7, 13, 1)])
def test_pixelwise_normalizer_matches_jax(target):
    """fit (mean, std with ddof 1), normalize and denormalize, at the
    statistics' grid and at grids it grows to or shrinks to (antialiased)."""
    rng = np.random.default_rng(3)
    x = (4 + 8 * rng.random((9, 11, 11, 1))).astype(np.float32)
    tn, jn = TNorm.fit(torch.from_numpy(x)), JNorm.fit(jnp.asarray(x))
    close = lambda got, want: np.testing.assert_allclose(
        got.numpy(), np.asarray(want), rtol=NORM_RTOL, atol=NORM_ATOL)
    close(tn.mean, jn.mean)
    close(tn.std, jn.std)
    for shape in ((3, 11, 11, 1), (3,) + target[1:]):
        z = (4 + 8 * rng.random(shape)).astype(np.float32)
        close(tn.normalize(torch.from_numpy(z)), jn.normalize(jnp.asarray(z)))
        close(tn.denormalize(torch.from_numpy(z)), jn.denormalize(jnp.asarray(z)))
        close(tn._stats_for(torch.from_numpy(z))[1], jn._stats_for(jnp.asarray(z))[1])
    # the resize itself, on a field of unit-size values
    m = rng.random((1, 11, 11, 1)).astype(np.float32)
    from position_induced_transformer_torch.ops.normalization import linear_resize

    close(linear_resize(torch.from_numpy(m), target),
          jax.image.resize(jnp.asarray(m), target, method="linear"))


def test_pixelwise_resize_at_the_zssr_grid_matches_jax():
    """43^2 statistics grown to the 421^2 grid, as ZSSR serving resizes them."""
    x = t_syn.darcy(n=6, s=43)[0]
    tn, jn = TNorm.fit(torch.from_numpy(x)), JNorm.fit(jnp.asarray(x))
    z = np.zeros((1, 421, 421, 1), np.float32)
    for got, want in zip(tn._stats_for(torch.from_numpy(z)), jn._stats_for(jnp.asarray(z))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=NORM_RTOL, atol=NORM_ATOL)


@pytest.mark.parametrize("n", [1, 4, 7])
def test_rel_l1_quartiles_match_jax(n):
    rng = np.random.default_rng(n)
    true = rng.random((n, 50, 2)).astype(np.float32) + 0.5
    pred = true + 0.1 * rng.standard_normal((n, 50, 2)).astype(np.float32)
    got = t_quartiles(torch.from_numpy(true), torch.from_numpy(pred))
    want = j_quartiles(jnp.asarray(true), jnp.asarray(pred))
    np.testing.assert_allclose([float(g) for g in got], [float(w) for w in want], rtol=1e-6)


@pytest.mark.parametrize("s,flips_down,flips_up", [(11, 0, 0), (22, 0, 0), (43, 0, 0),
                                                    (421, 0, 0)])
def test_geometry_kept_sets_against_jax(s, flips_down, flips_up):
    """The port's ``darcy_geometry`` against the JAX one, both from the host
    builder: the meshes, distances and thresholds equal to the bit, so no
    entry is kept on one side only, also where the grid's exact ties put a
    distance within one ulp of its row's threshold (the device builder's
    quantile, interpolated in another order, kept 6 + 2 such entries at
    11^2 and 26 + 226 at 421^2 on one side only)."""
    tg = t_bench.darcy_geometry(T_CFG, s, device="cpu")
    jg = j_bench.darcy_geometry(J_CFG, s)
    np.testing.assert_array_equal(tg.mesh_in.numpy(), np.asarray(jg.mesh_in))
    np.testing.assert_array_equal(tg.dist_proc.numpy(), np.asarray(jg.dist_proc))
    for side, flips in (("down", flips_down), ("up", flips_up)):
        td, jd = getattr(tg, f"dist_{side}").numpy(), np.asarray(getattr(jg, f"dist_{side}"))
        tt, jt = getattr(tg, f"thr_{side}").numpy(), np.asarray(getattr(jg, f"thr_{side}"))
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tt, jt)
        assert int(((td <= tt) != (jd <= jt)).sum()) == flips, side


@pytest.fixture(scope="module")
def problems():
    """The JAX and port Darcy problems at the narrow width on the 11^2 grid
    (8 training and 4 test samples), with JAX-initialised weights in both,
    each on its own geometry."""
    jp = j_bench.setup_darcy(J_CFG, ntrain=8, ntest=4, downsampling=TRAIN_DS)
    tp = t_bench.setup(T_CFG, ntrain=8, ntest=4, downsampling=TRAIN_DS, device="cpu")
    params = jp.model.init(jax.random.PRNGKey(0), jp.geom, jnp.asarray(jp.train_data["x"][:1]))["params"]
    tp.model.load_state_dict(flax_params_to_state_dict(params))
    return jp, tp, params


def test_setup_matches_jax(problems):
    """The same raw targets, normalized inputs within rounding, flattened
    to (n, s*s, 1); statistics, extras and the postprocess's grid."""
    jp, tp, _ = problems
    for split in ("train_data", "test_data"):
        jd, td = getattr(jp, split), getattr(tp, split)
        assert set(td) == set(jd) == {"x", "y"}
        assert td["x"].shape == (td["y"].shape[0], 121, 1) and td["y"].shape[1:] == (11, 11, 1)
        np.testing.assert_array_equal(td["y"], np.asarray(jd["y"]))
        np.testing.assert_allclose(td["x"], np.asarray(jd["x"]), rtol=1e-5, atol=1e-5)
    for name in ("x_normalizer", "y_normalizer"):
        tn, jn = getattr(tp, name), getattr(jp, name)
        np.testing.assert_allclose(tn.mean.numpy(), np.asarray(jn.mean), rtol=NORM_RTOL, atol=NORM_ATOL)
        np.testing.assert_allclose(tn.std.numpy(), np.asarray(jn.std), rtol=NORM_RTOL, atol=NORM_ATOL)
    assert tp.extras == jp.extras == {"s": 11, "downsampling": TRAIN_DS}
    out = torch.zeros(2, 121, 1)
    np.testing.assert_allclose(tp.task.postprocess(out).numpy(),
                               np.asarray(jp.task.postprocess(jnp.zeros((2, 121, 1)))),
                               rtol=NORM_RTOL, atol=NORM_ATOL)


def test_forward_matches_jax(problems):
    jp, tp, params = problems
    x = jp.test_data["x"]
    want = np.asarray(jp.task.forward(params, jp.geom, {"x": x}))
    with torch.inference_mode():
        got = tp.task.forward(tp.geom, {"x": torch.from_numpy(tp.test_data["x"])})
    assert got.shape == want.shape == (4, 11, 11, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_three_training_steps_match_jax(problems):
    """Three Adam steps at batch 4 on a cosine schedule over 10: JAX
    value_and_grad + optax against the port's train epoch, on the rel-L2
    loss of the denormalized grid against the raw target."""
    jp, tp, params = problems
    lr, total = 1e-3, 10
    perm = np.array([[0, 1, 2, 3], [4, 5, 6, 7], [2, 5, 0, 7]])
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
    state = t_loop.TrainState(tp.model, t_loop.make_optimizer(tp.model.parameters(), lr))
    train_epoch = t_loop.make_train_epoch(tp.task, t_loop.make_lr_schedule(lr, total))
    data = {k: torch.from_numpy(v) for k, v in tp.train_data.items()}
    state, losses = train_epoch(state, tp.geom, data, torch.from_numpy(perm))
    np.testing.assert_allclose(losses.numpy(), jlosses, rtol=LOSS_RTOL)
    want = flax_params_to_state_dict(params)
    for k, v in tp.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=k)


def test_evaluate_zssr_matches_jax(problems, tmp_path):
    """``evaluate(..., zssr=True)`` at 22^2 on the same weights and the same
    11^2 statistics (a JAX checkpoint and a port checkpoint), each on its
    own geometry: the same metrics and predictions."""
    jp, _, params = problems
    stats = {k: {"mean": getattr(jp, k).mean, "std": getattr(jp, k).std}
             for k in ("x_normalizer", "y_normalizer")}
    jpath = j_ckpt.save(str(tmp_path / "jax_ckpt"), {"params": params, **stats})
    tpath = t_ckpt.save(
        str(tmp_path / "darcy.pt"), flax_params_to_state_dict(params), "darcy",
        **{k: {"mean": torch.from_numpy(np.array(v["mean"])), "std": torch.from_numpy(np.array(v["std"])),
               "eps": torch.tensor(1e-5, dtype=torch.float64)} for k, v in stats.items()})
    kw = dict(ntest=4, zssr=True, zssr_downsampling=ZSSR_DS)
    want = j_eval.evaluate(J_CFG, jpath, save_pred=str(tmp_path / "j.mat"), **kw)
    got = t_eval.evaluate(T_CFG, tpath, save_pred=str(tmp_path / "t.mat"), device="cpu", **kw)
    assert got["n_test"] == want["n_test"] == 4 and got["zssr"] and got["benchmark"] == "darcy"
    for k in ("rel_l1", "rel_l2", "rel_max"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(got["rel_l1_quartiles"], want["rel_l1_quartiles"], rtol=RTOL)
    from scipy.io import loadmat

    tm, jm = loadmat(str(tmp_path / "t.mat")), loadmat(str(tmp_path / "j.mat"))
    assert tm["pred"].shape == (4, 22, 22, 1)
    np.testing.assert_array_equal(tm["true"], jm["true"])
    np.testing.assert_allclose(tm["pred"], jm["pred"], rtol=RTOL, atol=ATOL)


def test_evaluate_refusals(tmp_path):
    """ZSSR on a setup without ``downsampling`` is a ValueError, as in JAX,
    and so is the shuffle ablation of a rollout benchmark; ``mesh``'s model
    and stage axes are ported, and in a world of one ``model=2`` and
    ``stage=2`` raise JAX's ValueError about devices. ``model_variant`` is ported:
    on the torch family it raises with the JAX package's words, and a
    TF-family variant refuses a checkpoint of another model."""
    cfg = t_configs.apply_overrides(t_configs.BURGERS, ["grid=64", "latent_grid=16",
                                                        "model.hid_dim=8", "model.n_blocks=1"])
    path = t_ckpt.save(str(tmp_path / "b.pt"), t_bench._make_model(cfg).state_dict(), "burgers")
    with pytest.raises(ValueError, match="downsampling"):
        t_eval.evaluate(cfg, path, zssr=True, device="cpu")
    for spec in ("model=2", "stage=2"):
        with pytest.raises(ValueError, match="needs 2 devices but only 1"):
            t_eval.evaluate(cfg, path, device="cpu", mesh=spec)
    with pytest.raises(ValueError, match="exists for the TF-family benchmarks only"):
        t_eval.evaluate(cfg, path, device="cpu", model_variant="x")
    with pytest.raises(ValueError, match="one-step operator map"):
        t_eval.evaluate(t_configs.VORTICITY, path, shuffle_ablation=True, device="cpu")
    burgers_tf = t_ckpt.save(str(tmp_path / "btf.pt"), t_bench._make_model(cfg).state_dict(),
                             "burgers_tf")
    lite = dataclasses.replace(t_configs.apply_overrides(t_configs.BURGERS_TF, [
        "grid=64", "latent_grid=32", "model.hid_dim=8", "model.n_blocks=1", "ntrain=10"]),
        model_variant="lite")
    with pytest.raises(RuntimeError, match="state_dict"):  # a PiT's weights
        t_eval.evaluate(lite, burgers_tf, ntest=2, device="cpu")
    result = t_eval.evaluate(cfg, path, ntest=3, device="cpu")
    assert result["n_test"] == 3 and not result["zssr"] and len(result["rel_l1_quartiles"]) == 3


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The port trained one epoch at 11^2 on the CPU, with its checkpoint."""
    path = str(tmp_path_factory.mktemp("darcy") / "darcy.pt")
    problem, state, history = t_runner.train(
        T_CFG, epochs=1, ntrain=8, ntest=4, verbose=False, checkpoint_path=path,
        setup_kwargs={"downsampling": TRAIN_DS}, device="cpu")
    return problem, state, history, path


def test_checkpoint_round_trip_carries_the_normalizers(trained, tmp_path):
    problem, state, history, path = trained
    assert np.isfinite(history[0]["train_loss"]) and np.isfinite(history[0]["rel_l2"])
    restored = t_ckpt.restore(path)
    assert set(restored) == {"config", "state_dict", "optimizer", "step", "x_normalizer", "y_normalizer"}
    for k in ("x_normalizer", "y_normalizer"):
        norm = getattr(problem, k)
        assert torch.equal(restored[k]["mean"], norm.mean) and torch.equal(restored[k]["std"], norm.std)
        assert float(restored[k]["eps"]) == norm.eps == 1e-5
        back = TNorm(**restored[k])
        z = torch.rand(2, 22, 22, 1)
        assert torch.equal(back.normalize(z), norm.normalize(z))
    kw = t_eval._checkpoint_normalizers(T_CFG, restored, {})
    assert set(kw) == {"normalizers"}
    # a burgers setup declares no normalizers: nothing is passed
    assert t_eval._checkpoint_normalizers(t_configs.BURGERS, restored, {}) == {}
    assert t_eval._setup_accepts(T_CFG, "downsampling")
    assert not t_eval._setup_accepts(t_configs.SOD, "downsampling")
    y_only = {k: v for k, v in restored.items() if k != "x_normalizer"}
    with pytest.raises(ValueError, match="y_normalizer but no x_normalizer"):
        t_eval._checkpoint_normalizers(T_CFG, y_only, {})
    torch.save(y_only, tmp_path / "y_only.pt")
    with pytest.raises(ValueError, match="no x_normalizer"):
        t_eval.Predictor(T_CFG, str(tmp_path / "y_only.pt"), device="cpu")
    torch.save({**restored, "other": 1}, tmp_path / "other.pt")
    with pytest.raises(ValueError, match="not a checkpoint"):
        t_ckpt.restore(str(tmp_path / "other.pt"))
    torch.save({**restored, "x_normalizer": {"mean": torch.zeros(1)}}, tmp_path / "partial.pt")
    with pytest.raises(ValueError, match="not a checkpoint"):
        t_ckpt.restore(str(tmp_path / "partial.pt"))


def test_predictor_infer_and_server_at_the_zssr_resolution(trained, tmp_path):
    """Raw 22^2 grids through ``infer`` and a server built with
    ``setup_kwargs={"downsampling": 20}``: normalized with the
    checkpoint's 11^2 statistics resized to 22^2, they give
    ``runner.predict`` on the ZSSR problem."""
    problem, state, _, path = trained
    zssr = t_bench.setup(T_CFG, ntrain=4, ntest=4, downsampling=ZSSR_DS, device="cpu",
                         normalizers=(problem.x_normalizer, problem.y_normalizer))
    zssr.model.load_state_dict(state.model.state_dict())
    want = t_runner.predict(zssr)
    s2 = zssr.extras["s"]
    assert s2 == 22 and want.shape == (4, s2, s2, 1)
    raw = problem.x_normalizer.denormalize(
        torch.from_numpy(zssr.test_data["x"]).reshape(-1, s2, s2, 1)).numpy()
    np.save(tmp_path / "raw.npy", raw)
    res = t_eval.infer(T_CFG, path, str(tmp_path / "raw.npy"), output_path=str(tmp_path / "pred.npy"),
                       setup_kwargs={"downsampling": ZSSR_DS}, device="cpu")
    assert res["pred_shape"] == [4, s2, s2, 1]
    np.testing.assert_allclose(np.load(tmp_path / "pred.npy"), want, rtol=RTOL, atol=ATOL)
    srv = make_server(T_CFG, path, port=0, verbose=False, setup_kwargs={"downsampling": ZSSR_DS},
                      device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        buf = io.BytesIO()
        np.save(buf, raw[:3])
        url = f"http://127.0.0.1:{srv.server_address[1]}/predict"
        with urllib.request.urlopen(urllib.request.Request(url, data=buf.getvalue(), method="POST"),
                                    timeout=60) as r:
            assert r.status == 200
            got = np.load(io.BytesIO(r.read()))
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    np.testing.assert_allclose(got, want[:3], rtol=RTOL, atol=ATOL)
    # at the training resolution a flattened raw batch is reshaped to the
    # statistics' grid first
    pred = t_eval.Predictor(T_CFG, path, setup_kwargs={"downsampling": TRAIN_DS}, device="cpu")
    raw11 = problem.x_normalizer.denormalize(
        torch.from_numpy(problem.test_data["x"]).reshape(-1, 11, 11, 1)).numpy()
    flat = pred.predict_array({"x": t_eval._prepare_inputs(pred.problem, raw11.reshape(4, -1))})
    np.testing.assert_allclose(flat, t_runner.predict(problem), rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="incompatible"):
        t_eval._prepare_inputs(pred.problem, np.zeros((2, 50), np.float32))


def test_predictor_without_stored_normalizers_refits_the_full_split(trained, tmp_path):
    """A checkpoint holding weights only: the Predictor refits the
    statistics on the full training split (``cfg.ntrain``), as training
    fitted them, not on its minimal split."""
    _, state, _, _ = trained
    cfg = dataclasses.replace(T_CFG, ntrain=12, ntest=4)
    path = t_ckpt.save(str(tmp_path / "weights.pt"), state.model.state_dict(), "darcy")
    pred = t_eval.Predictor(cfg, path, setup_kwargs={"downsampling": TRAIN_DS}, device="cpu")
    # the Predictor's minimal test split holds 8 samples (as the JAX one's)
    x_tr = t_loaders.darcy(None, None, TRAIN_DS, ntrain=12, ntest=8)[0]
    want = TNorm.fit(torch.from_numpy(x_tr))
    assert torch.equal(pred.problem.x_normalizer.mean, want.mean)
    assert torch.equal(pred.problem.x_normalizer.std, want.std)
