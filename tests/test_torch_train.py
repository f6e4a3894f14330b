"""The port's training loop against the JAX package's, on the CPU.

Both sides start from the same JAX-initialised weights and see the same
batches; the port's step (its autograd Function runs the plain versions of
the four fixed-mesh kernels on the CPU) is held against JAX's
``value_and_grad`` + optax step. Losses agree at rtol 2e-4 and parameters
at rtol 5e-3 / atol 2e-5, the tolerances of tests/test_training_parity.py:
Adam divides each gradient by its own running magnitude, so a rounding
difference in a near-zero gradient moves its parameter by up to lr.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from position_induced_transformer_torch import configs as t_configs
from position_induced_transformer_torch.kernels import posatt_pallas as t_k
from position_induced_transformer_torch.models import PiT as TPiT
from position_induced_transformer_torch.models import build_geometry as t_build
from position_induced_transformer_torch.ops import metrics as t_metrics
from position_induced_transformer_torch.train import benchmarks as t_bench
from position_induced_transformer_torch.train import checkpoint as t_ckpt
from position_induced_transformer_torch.train import loop as t_loop
from position_induced_transformer_torch.train import runner as t_runner
from position_induced_transformer_torch.train.evaluate import Predictor
from position_induced_transformer_torch.utils.torch_compat import (
    flax_params_to_state_dict,
)
from position_induced_transformer_tpu.data import meshes as j_meshes
from position_induced_transformer_tpu.models import PiT as JPiT
from position_induced_transformer_tpu.models import build_geometry as j_build
from position_induced_transformer_tpu.ops import metrics as j_metrics
from position_induced_transformer_tpu.train import loop as j_loop
from position_induced_transformer_tpu.train.runner import (
    default_metrics as j_default_metrics,
)

torch.set_num_threads(1)

LOSS_RTOL = 2e-4
PARAM_RTOL, PARAM_ATOL = 5e-3, 2e-5


@pytest.mark.parametrize("warmup", [0, 3])
def test_lr_schedule_matches_optax(warmup):
    lr, total, eta_min = 1e-3, 20, 1e-5
    want = j_loop.make_lr_schedule(lr, total, eta_min, warmup)
    got = t_loop.make_lr_schedule(lr, total, eta_min, warmup)
    steps = range(total + 3)  # past the end: the step is clamped
    # optax evaluates in float32, the port in float64
    np.testing.assert_allclose(
        [got(s) for s in steps], [float(want(s)) for s in steps], rtol=1e-6, atol=0
    )
    assert got(total + 2) == pytest.approx(eta_min if not warmup else got(total))


def test_optimizer_flavors():
    params = [torch.nn.Parameter(torch.zeros(2))]
    opt = t_loop.make_optimizer(params, 1e-3)
    assert isinstance(opt, torch.optim.Adam)
    assert opt.param_groups[0]["eps"] == 1e-8
    assert opt.param_groups[0]["betas"] == (0.9, 0.999)
    keras = t_loop.make_optimizer(params, 1e-3, flavor="keras")
    assert isinstance(keras, t_loop.KerasAdam)
    assert keras.param_groups[0]["eps"] == 1e-7
    with pytest.raises(ValueError, match="flavor"):
        t_loop.make_optimizer(params, 1e-3, flavor="sgd")


@pytest.mark.parametrize("p", [1, 2, 3])
@pytest.mark.parametrize("weighted", [False, True])
def test_metrics_match_jax(p, weighted):
    rng = np.random.default_rng(p)
    true = rng.standard_normal((4, 30, 2)).astype(np.float32)
    pred = rng.standard_normal((4, 30, 2)).astype(np.float32)
    w = np.array([1, 1, 0, 1], np.float32) if weighted else None
    tw = None if w is None else torch.from_numpy(w)
    jw = None if w is None else jnp.asarray(w)
    t, q = torch.from_numpy(true), torch.from_numpy(pred)
    got = t_metrics.rel_lp_norm(t, q, 2, p=p, weights=tw)
    want = j_metrics.rel_lp_norm(jnp.asarray(true), jnp.asarray(pred), 2, p=p, weights=jw)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    got = t_metrics.rel_max_norm(t, q, 2, weights=tw)
    want = j_metrics.rel_max_norm(jnp.asarray(true), jnp.asarray(pred), 2, weights=jw)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("batch_mean", [False, True])
def test_task_loss_conventions_match_jax(swap, batch_mean):
    rng = np.random.default_rng(0)
    true = rng.standard_normal((3, 16, 1)).astype(np.float32)
    pred = rng.standard_normal((3, 16, 1)).astype(np.float32)
    w = np.array([1, 1, 0], np.float32)
    kw = dict(loss_p=1, out_dim=1, swap_loss_args=swap, batch_mean_loss=batch_mean)
    jt, tt = j_loop.Task(model=None, **kw), t_loop.Task(model=None, **kw)
    for weights in (None, w):
        got = tt._loss(torch.from_numpy(true), torch.from_numpy(pred),
                       None if weights is None else torch.from_numpy(weights))
        want = jt._loss(jnp.asarray(true), jnp.asarray(pred),
                        None if weights is None else jnp.asarray(weights))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # an unknown remat mode of a rollout task raises the JAX ValueError
    with pytest.raises(ValueError, match="unrecognized PIT_ROLLOUT_REMAT/remat_rollout"):
        t_loop.Task(model=None, rollout_steps=2, remat_rollout="all").loss_fn(None, {"x": None})


def _models(cfg_model, L, Lt, seed=0):
    """The JAX and port PiT with the same JAX-initialised weights, and the
    two geometries of a periodic 1-D mesh L -> Lt -> L."""
    m = cfg_model
    fields = dict(
        space_dim=m.space_dim, in_dim=m.in_dim, out_dim=m.out_dim,
        hid_dim=m.hid_dim, n_head=m.n_head, n_blocks=m.n_blocks,
        en_loc=m.en_loc, de_loc=m.de_loc,
    )
    mesh, ltt = j_meshes.grid_1d(L), j_meshes.grid_1d(Lt)
    jg = j_build(jnp.asarray(mesh), jnp.asarray(ltt), jnp.asarray(mesh),
                 metric="periodic1d", en_loc=m.en_loc, de_loc=m.de_loc)
    tg = t_build(mesh, ltt, mesh, metric="periodic1d", en_loc=m.en_loc,
                 de_loc=m.de_loc, device="cpu")
    jmodel = JPiT(**fields)
    params = jmodel.init(jax.random.PRNGKey(seed), jg, jnp.ones((1, L, m.in_dim)))["params"]
    tmodel = TPiT(**fields)
    tmodel.load_state_dict(flax_params_to_state_dict(params))
    return jmodel, params, jg, tmodel, tg


def _jax_steps(jmodel, params, geom, xs, ys, lr, total):
    optimizer = j_loop.make_optimizer(lr, total)
    task = j_loop.Task(model=jmodel, loss_p=1, out_dim=1)
    opt_state = optimizer.init(params)

    @jax.jit
    def step(params, opt_state, x, y):
        loss, grads = jax.value_and_grad(task.loss_fn)(params, geom, {"x": x, "y": y})
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    losses = []
    for x, y in zip(xs, ys):
        params, opt_state, loss = step(params, opt_state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    return params, losses


def _port_steps(tmodel, geom, xs, ys, lr, total):
    steps, B = xs.shape[:2]
    task = t_loop.Task(model=tmodel, loss_p=1, out_dim=1)
    state = t_loop.TrainState(tmodel, t_loop.make_optimizer(tmodel.parameters(), lr))
    train_epoch = t_loop.make_train_epoch(task, t_loop.make_lr_schedule(lr, total))
    data = {"x": torch.from_numpy(xs.reshape(steps * B, *xs.shape[2:])),
            "y": torch.from_numpy(ys.reshape(steps * B, *ys.shape[2:]))}
    losses = []
    for t in range(steps):
        state, loss = train_epoch(state, geom, data, torch.arange(t * B, (t + 1) * B)[None])
        assert loss.shape == (1,)
        losses.append(float(loss[0]))
    assert state.step == steps
    return losses


def _assert_trajectories_agree(jparams, jlosses, tmodel, tlosses):
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL)
    want = flax_params_to_state_dict(jparams)
    got = tmodel.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)


def test_training_steps_match_jax():
    """hid 16, 2 heads, 2 blocks, L 48 -> 12, batch 4: five Adam steps on a
    cosine schedule over 20."""
    m = dataclasses.replace(t_configs.BURGERS.model, hid_dim=16, n_blocks=2,
                            en_loc=0.3, de_loc=0.3)
    jmodel, params, jg, tmodel, tg = _models(m, 48, 12)
    rng = np.random.default_rng(0)
    xs = rng.random((5, 4, 48, 1)).astype(np.float32)
    ys = rng.random((5, 4, 48, 1)).astype(np.float32)
    jparams, jlosses = _jax_steps(jmodel, params, jg, xs, ys, 1e-3, 20)
    tlosses = _port_steps(tmodel, tg, xs, ys, 1e-3, 20)
    _assert_trajectories_agree(jparams, jlosses, tmodel, tlosses)


def test_full_burgers_two_steps_match_jax():
    """The Burgers configuration at full width and depth (hid 64, 2 heads,
    5 blocks, 1024 -> 256 -> 1024, locality 0.02, batch 8) on its own
    synthetic data: two steps."""
    cfg = t_configs.BURGERS
    jmodel, params, jg, tmodel, tg = _models(cfg.model, 1024, 256)
    problem = t_bench.setup_burgers(cfg, ntrain=16, ntest=2, device="cpu")
    xs = problem.train_data["x"].reshape(2, 8, 1024, 1)
    ys = problem.train_data["y"].reshape(2, 8, 1024, 1)
    jparams, jlosses = _jax_steps(jmodel, params, jg, xs, ys, cfg.lr, 100)
    tlosses = _port_steps(tmodel, tg, xs, ys, cfg.lr, 100)
    _assert_trajectories_agree(jparams, jlosses, tmodel, tlosses)


def test_eval_epoch_matches_jax_with_padded_tail():
    m = dataclasses.replace(t_configs.BURGERS.model, hid_dim=16, n_blocks=2,
                            en_loc=0.3, de_loc=0.3)
    jmodel, params, jg, tmodel, tg = _models(m, 48, 12, seed=3)
    rng = np.random.default_rng(1)
    x = rng.random((5, 48, 1)).astype(np.float32)
    y = rng.random((5, 48, 1)).astype(np.float32)
    perm = t_loop.eval_permutation(5, 4)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(j_loop.eval_permutation(5, 4)))
    jtask = j_loop.Task(model=jmodel, loss_p=1, out_dim=1)
    ttask = t_loop.Task(model=tmodel, loss_p=1, out_dim=1)
    for metrics in (None, "default"):
        jm = None if metrics is None else j_default_metrics(1)
        tm = None if metrics is None else t_runner.default_metrics(1)
        want = j_loop.make_eval_epoch(jtask, jm)(
            j_loop.TrainState(params, None, 0), jg,
            {"x": jnp.asarray(x), "y": jnp.asarray(y)}, jnp.asarray(perm.numpy()), 5,
        )
        got = t_loop.make_eval_epoch(ttask, tm)(
            tg, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}, perm, 5
        )
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, err_msg=k)


def _small_cfg():
    cfg = t_configs.BURGERS
    return dataclasses.replace(
        cfg, grid=(64,), latent_grid=(16,), batch_size=4,
        model=dataclasses.replace(cfg.model, hid_dim=8, n_blocks=1, en_loc=0.1, de_loc=0.1),
    )


def test_resume_equals_straight_run(tmp_path):
    cfg = _small_cfg()
    kw = dict(ntrain=8, ntest=6, seed=2, verbose=False, device="cpu")
    _, straight, hist = t_runner.train(cfg, epochs=2, **kw)
    ck = str(tmp_path / "half.pt")
    t_runner.train(cfg, epochs=1, schedule_epochs=2, checkpoint_path=ck, **kw)
    _, resumed, hist2 = t_runner.train(cfg, epochs=2, resume_from=ck, **kw)
    assert resumed.step == straight.step == 4
    assert [r["epoch"] for r in hist2] == [1]
    assert hist2[0]["train_loss"] == hist[1]["train_loss"]
    for k, v in straight.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    for a, b in zip(straight.optimizer.state.values(), resumed.optimizer.state.values()):
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])


def test_train_writes_log_history_and_a_checkpoint_predictor_reads(tmp_path):
    cfg = _small_cfg()
    log, csv, ck = (str(tmp_path / n) for n in ("log.jsonl", "h.csv", "c.pt"))
    problem, state, hist = t_runner.train(
        cfg, epochs=3, ntrain=8, ntest=6, verbose=False, device="cpu", log_path=log,
        history_csv=csv, checkpoint_path=ck, checkpoint_every=2, sync_every=2,
    )
    rows = [json.loads(line) for line in open(log)]
    assert [r["epoch"] for r in rows] == [0, 1, 2] == [r["epoch"] for r in hist]
    assert set(rows[0]) == {"epoch", "seconds", "train_loss", "rel_l1", "rel_l2", "rel_max"}
    assert all(np.isfinite(r["train_loss"]) for r in rows)
    assert open(csv).readline().strip() == "epoch,seconds,train_loss,rel_l1,rel_l2,rel_max"
    restored = t_ckpt.restore(ck)
    assert restored["step"] == state.step == 6
    pred = Predictor(cfg, ck, device="cpu")
    x = problem.test_data["x"]
    np.testing.assert_allclose(
        pred.predict_array({"x": x}), t_runner.predict(problem), rtol=1e-6, atol=1e-7
    )


def test_grad_accum_matches_whole_batches():
    cfg = _small_cfg()
    kw = dict(epochs=1, ntrain=8, ntest=4, verbose=False, device="cpu")
    _, one, _ = t_runner.train(cfg, **kw)
    _, two, _ = t_runner.train(cfg, grad_accum=2, **kw)
    for k, v in one.model.state_dict().items():
        torch.testing.assert_close(two.model.state_dict()[k], v, rtol=1e-4, atol=1e-6)
    with pytest.raises(ValueError, match="microbatches"):
        t_runner.train(cfg, grad_accum=3, **kw)


@pytest.mark.parametrize("option", ["mesh", "model_variant"])
def test_unported_runner_options_raise(option):
    """``mesh`` is not ported; ``model_variant`` is, and reaches the model:
    an unknown one raises, and on the torch family any raises with the JAX
    package's words."""
    if option == "mesh":
        with pytest.raises(NotImplementedError, match="not ported"):
            t_runner.train("burgers", device="cpu", **{option: "x"})
        return
    with pytest.raises(ValueError, match="exists for the TF-family benchmarks only"):
        t_runner.train(_small_cfg(), device="cpu", ntrain=4, ntest=2, model_variant="x")
    with pytest.raises(ValueError, match="unknown model variant 'x'"):
        t_runner.train(dataclasses.replace(t_configs.BURGERS_TF, grid=(64,), latent_grid=(32,)),
                       device="cpu", ntrain=5, ntest=2, model_variant="x")


def test_permutations():
    a = t_loop.epoch_permutation(0, 3, 21, 4)
    assert a.shape == (5, 4) and len(set(a.flatten().tolist())) == 20
    assert torch.equal(a, t_loop.epoch_permutation(0, 3, 21, 4))
    assert not torch.equal(a, t_loop.epoch_permutation(0, 4, 21, 4))
    assert not torch.equal(a, t_loop.epoch_permutation(1, 3, 21, 4))
    np.testing.assert_array_equal(
        t_loop.eval_permutation(13, 8).numpy(), np.asarray(j_loop.eval_permutation(13, 8))
    )


def test_training_forward_runs_the_function_and_eval_does_not():
    """On the CPU no kernel launches; the training forward records the
    autograd Function and the eval forward records nothing."""
    cfg = _small_cfg()
    problem = t_bench.setup(cfg, ntrain=4, ntest=4, device="cpu")
    x = torch.from_numpy(problem.train_data["x"])
    out = problem.model(problem.geom, x)
    seen, stack = set(), [out.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is not None and fn not in seen:
            seen.add(fn)
            stack.extend(f for f, _ in fn.next_functions)
    names = {type(fn).__name__ for fn in seen}
    assert "PosAttFixedBackward" in names
    with torch.inference_mode():
        assert problem.model(problem.geom, x).grad_fn is None
    assert t_k.posatt_stats_cuda.launches == 0
