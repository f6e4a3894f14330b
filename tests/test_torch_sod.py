"""The sod slice of the port against the JAX package, on the CPU: the exact
Riemann solver and the shock-tube generator, the loader with its
conservative -> primitive transform, the setup and its geometry, the
forward, three training steps, and training, inference and serving
through the runner, ``Predictor``, ``infer`` and the HTTP server.

The model runs at the configuration's mesh (1024 points on [-5, 5) to a
256-point latent mesh, one head, 2 blocks, in/out 3) with a narrow hidden
width (16). The port's geometry keeps the entries the JAX one (the native
builder) keeps; the parity tests still carry the JAX geometry over, so
that both sides run one threshold source. Predictions hold at rtol 1e-4 /
atol 1e-5 (test_torch_model.py's bound), training at losses rtol 2e-4 and
weights rtol 5e-3 / atol 2e-5 (test_torch_train.py's).
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
from position_induced_transformer_torch.train import benchmarks as t_bench
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
from position_induced_transformer_tpu.train import loop as j_loop

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
LOSS_RTOL = 2e-4
PARAM_RTOL, PARAM_ATOL = 5e-3, 2e-5


def _narrow(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, hid_dim=16, n_blocks=2))


T_CFG, J_CFG = _narrow(t_configs.SOD), _narrow(j_configs.SOD)


@pytest.mark.parametrize("n,L,seed", [(4, 1024, 0), (7, 100, 3), (3, 2048, 11)])
def test_synthetic_sod_is_bit_equal(n, L, seed):
    for got, want in zip(t_syn.sod(n, L, seed), j_syn.sod(n, L, seed)):
        assert got.dtype == want.dtype and got.shape == (n, L, 3)
        np.testing.assert_array_equal(got, want)


def test_riemann_solver_is_bit_equal():
    """The star state (60 Newton steps) and the sampled solution, over a
    spread of left and right states beyond those sod() draws, both waves'
    branches (shock and rarefaction) included."""
    rng = np.random.default_rng(5)
    n = 64
    rl, rr = rng.uniform(0.1, 2.0, (n, 1)), rng.uniform(0.05, 2.0, (n, 1))
    pl, pr = rng.uniform(0.05, 2.0, (n, 1)), rng.uniform(0.05, 2.0, (n, 1))
    ul, ur = rng.uniform(-0.5, 0.5, (n, 1)), rng.uniform(-0.5, 0.5, (n, 1))
    star_t = t_syn._riemann_star(rl, ul, pl, rr, ur, pr)
    star_j = j_syn._riemann_star(rl, ul, pl, rr, ur, pr)
    for a, b in zip(star_t, star_j):
        np.testing.assert_array_equal(a, b)
    assert (star_t[0] > pl).any() and (star_t[0] < pl).any()  # shocks and fans
    xi = np.linspace(-3, 3, 257)[None, :]
    # the dense branches take powers of negative sound speeds where no fan
    # is sampled; both sides select around them
    with np.errstate(invalid="ignore"):
        got = t_syn._riemann_sample(rl, ul, pl, rr, ur, pr, *star_t, xi)
        want = j_syn._riemann_sample(rl, ul, pl, rr, ur, pr, *star_j, xi)
    for a, b in zip(got, want):
        assert np.isfinite(a).all()
        np.testing.assert_array_equal(a, b)


def test_loader_converts_real_files_to_primitive_variables(tmp_path):
    """A small ``.mat`` in conservative variables (rho, m, E): p = (E -
    m^2 / (2 rho)) (gamma - 1) first, then u = m / rho, bit for bit."""
    rng = np.random.default_rng(0)
    n, L = 6, 40
    rho = rng.uniform(0.1, 1.2, (n, L))
    m = rng.uniform(-0.3, 0.3, (n, L))
    E = rng.uniform(1.0, 3.0, (n, L))
    cons = np.stack([rho, m, E], -1)
    savemat(tmp_path / "sod.mat", {"x": cons, "y": cons[:, ::-1] * 1.1})
    path = str(tmp_path / "sod.mat")
    got = t_loaders.sod(path, ntrain=4, ntest=2, L=L)
    want = j_loaders.sod(path, ntrain=4, ntest=2, L=L)
    assert [a.shape for a in got] == [(4, L, 3), (4, L, 3), (2, L, 3), (2, L, 3)]
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    x = cons.astype(np.float32)
    p = (x[..., 2] - 0.5 * x[..., 1] ** 2 / x[..., 0]) * (1.4 - 1)
    np.testing.assert_array_equal(got[0][..., 2], p[:4])
    np.testing.assert_array_equal(got[0][..., 1], (x[..., 1] / x[..., 0])[:4])
    with pytest.raises(ValueError, match="ntrain"):
        t_loaders.sod(path, ntrain=5, ntest=2, L=L)
    with pytest.warns(UserWarning, match="SYNTHETIC"):
        got = t_loaders.sod(str(tmp_path / "missing.mat"), ntrain=3, ntest=2, L=64)
    for a, b in zip(got, j_loaders.sod(None, ntrain=3, ntest=2, L=64)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def problems():
    """The JAX and port sod problems at the narrow width (8 training and 4
    test samples), with JAX-initialised weights in both."""
    jp = j_bench.setup_sod(J_CFG, ntrain=8, ntest=4)
    tp = t_bench.setup(T_CFG, ntrain=8, ntest=4, device="cpu")
    params = jp.model.init(jax.random.PRNGKey(0), jp.geom, jnp.asarray(jp.train_data["x"][:1]))["params"]
    tp.model.load_state_dict(flax_params_to_state_dict(params))
    return jp, tp, params


def _carried(jg) -> Geometry:
    t = lambda a: torch.from_numpy(np.array(a))
    return Geometry(mesh_in=t(jg.mesh_in), dist_down=t(jg.dist_down), dist_proc=t(jg.dist_proc),
                    dist_up=t(jg.dist_up), thr_down=t(jg.thr_down), thr_up=t(jg.thr_up))


def test_setup_matches_jax(problems):
    """The same data and meshes bit for bit; distances bit for bit and
    thresholds within an ulp, so the kept sets are equal: 21 a latent row,
    6 or 7 an output row (7 where the cut falls inside a tie)."""
    jp, tp, _ = problems
    for split in ("train_data", "test_data"):
        jd, td = getattr(jp, split), getattr(tp, split)
        assert set(td) == set(jd) == {"x", "y"}
        for k in ("x", "y"):
            np.testing.assert_array_equal(td[k], np.asarray(jd[k]), err_msg=k)
    jg, tg = jp.geom, tp.geom
    np.testing.assert_array_equal(tg.mesh_in.numpy(), np.asarray(jg.mesh_in))
    assert tg.mesh_in[0, 0] == -5.0 and tg.mesh_in.shape == (1024, 1)
    for side, kept in (("down", {21}), ("up", {6, 7})):
        td, jd = getattr(tg, f"dist_{side}").numpy(), np.asarray(getattr(jg, f"dist_{side}"))
        tt, jt = getattr(tg, f"thr_{side}").numpy(), np.asarray(getattr(jg, f"thr_{side}"))
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_allclose(tt, jt, rtol=float(np.finfo(np.float32).eps), atol=0)
        np.testing.assert_array_equal(td <= tt, jd <= jt)
        assert set((td <= tt).sum(1).tolist()) == kept
    np.testing.assert_array_equal(tg.dist_proc.numpy(), np.asarray(jg.dist_proc))
    assert tp.x_normalizer is None and tp.extras == {}


def test_forward_matches_jax(problems):
    jp, tp, params = problems
    want = np.asarray(jp.task.forward(params, jp.geom, {"x": jp.test_data["x"]}))
    with torch.inference_mode():
        for geom in (_carried(jp.geom), tp.geom):  # its own kept sets are the JAX ones
            got = tp.task.forward(geom, {"x": torch.from_numpy(tp.test_data["x"])})
            assert got.shape == want.shape == (4, 1024, 3)
            np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_three_training_steps_match_jax(problems):
    """Three Adam steps at batch 4 on a cosine schedule over 10 (rel-L1
    loss): JAX value_and_grad + optax against the port's train epoch."""
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
    state, losses = train_epoch(state, _carried(jp.geom), data, torch.from_numpy(perm))
    np.testing.assert_allclose(losses.numpy(), jlosses, rtol=LOSS_RTOL)
    want = flax_params_to_state_dict(params)
    for k, v in tp.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=k)


def test_runner_trains_serves_and_evaluates_on_the_cpu(tmp_path):
    """``runner.train("sod")`` one epoch; its checkpoint through
    ``Predictor``, ``infer``, the HTTP server and ``evaluate``, each giving
    ``runner.predict``'s predictions or metrics."""
    path = str(tmp_path / "sod.pt")
    problem, state, history = t_runner.train(
        T_CFG, epochs=1, ntrain=8, ntest=4, verbose=False, checkpoint_path=path, device="cpu")
    assert state.step == 1 and np.isfinite(history[0]["train_loss"])
    want = t_runner.predict(problem)
    pred = t_eval.Predictor(T_CFG, path, device="cpu")
    np.testing.assert_allclose(pred.predict_array({"x": problem.test_data["x"]}), want,
                               rtol=RTOL, atol=ATOL)
    np.save(tmp_path / "x.npy", problem.test_data["x"][:3])
    res = t_eval.infer(T_CFG, path, str(tmp_path / "x.npy"), output_path=str(tmp_path / "p.npy"),
                       device="cpu")
    assert res["pred_shape"] == [3, 1024, 3]
    np.testing.assert_allclose(np.load(tmp_path / "p.npy"), want[:3], rtol=RTOL, atol=ATOL)
    srv = make_server(T_CFG, path, port=0, verbose=False, device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        buf = io.BytesIO()
        np.save(buf, problem.test_data["x"][1:4])
        url = f"http://127.0.0.1:{srv.server_address[1]}/predict"
        with urllib.request.urlopen(urllib.request.Request(url, data=buf.getvalue(), method="POST"),
                                    timeout=60) as r:
            assert r.status == 200
            got = np.load(io.BytesIO(r.read()))
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    np.testing.assert_allclose(got, want[1:4], rtol=RTOL, atol=ATOL)
    # the generator's draws depend on the sample count: the same split sizes
    # give the training run's test split
    result = t_eval.evaluate(dataclasses.replace(T_CFG, ntrain=8, ntest=4), path, device="cpu")
    assert result["n_test"] == 4
    np.testing.assert_allclose(result["rel_l1"], history[0]["rel_l1"], rtol=RTOL)
    with pytest.raises(ValueError, match="downsampling"):
        t_eval.evaluate(T_CFG, path, zssr=True, device="cpu")
