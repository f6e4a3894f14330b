"""The port's model (head) axis (``parallel.tensor_parallel``,
``runner.train(mesh="...model=M")``) on the CPU under gloo, each rank a
process of its own (tests/torch_ranks.py), against the single-process port
at the JAX package's tests/test_parallel.py tolerances (weights rtol 2e-4 /
atol 2e-5, losses and metrics rtol 1e-4; bf16 2e-2 / 2e-3 and 1e-2), and
one tensor-parallel step against the JAX package's ``make_train_epoch`` on
a ``shard_state``-placed state on its fake CPU devices.
"""

import dataclasses
import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from position_induced_transformer_torch import configs as t_configs
from position_induced_transformer_torch.parallel import make_mesh, param_shardings, shard_state
from position_induced_transformer_torch.train import benchmarks as t_bench
from position_induced_transformer_torch.train import checkpoint as t_ckpt
from position_induced_transformer_torch.train import evaluate as t_eval
from position_induced_transformer_torch.train import runner as t_runner
from position_induced_transformer_tpu import configs as j_configs
from position_induced_transformer_tpu.parallel import make_mesh as j_make_mesh
from position_induced_transformer_tpu.parallel import replicate_tree as j_replicate
from position_induced_transformer_tpu.parallel import shard_state as j_shard_state
from position_induced_transformer_tpu.train import benchmarks as j_bench
from position_induced_transformer_tpu.train import make_optimizer as j_make_optimizer
from position_induced_transformer_tpu.train import make_train_epoch as j_make_train_epoch
from position_induced_transformer_tpu.train import runner as j_runner
from tests.torch_ranks import run_ranks

BURGERS = ["grid=64", "latent_grid=16", "batch_size=8", "model.hid_dim=16", "model.n_blocks=2"]
ELASTICITY = ["batch_size=8", "model.hid_dim=16", "model.n_blocks=2"]
TRAIN = dict(epochs=2, ntrain=32, ntest=13)

# label -> (name, overrides, runner.train's arguments); MODEL2 in two ranks
# at model=2, MESH4 in four ranks, each under its mesh
VORTICITY = ["grid=16,16", "latent_grid=8,8", "rollout_steps=3", "memory=4", "batch_size=8",
             "model.in_dim=4", "ntrain=16", "model.hid_dim=16", "model.n_blocks=2"]
MODEL2 = {
    "burgers": ("burgers", BURGERS, TRAIN, "model=2"),
    "vorticity": ("vorticity", VORTICITY, dict(epochs=1, ntrain=16, ntest=8), "model=2"),
    "heads3": ("burgers", BURGERS + ["model.n_head=3"], dict(epochs=1, ntrain=16, ntest=8),
               "model=2"),
    "elasticity": ("elasticity", ELASTICITY,
                   dict(epochs=2, ntrain=16, ntest=9, setup_kwargs={"n_points": 48}), "model=2"),
}
MESH4 = {
    "data=2,model=2": ("burgers", BURGERS, TRAIN, "data=2,model=2"),
    "dcn=2,data=1,model=2": ("burgers", BURGERS, TRAIN, "dcn=2,data=1,model=2"),
    "bf16": ("burgers", BURGERS + ["model.compute_dtype=bfloat16"],
             dict(epochs=2, ntrain=16, ntest=8), "data=2,model=2"),
}


def _cfg(name, overrides):
    return t_configs.apply_overrides(t_configs.get(name), overrides)


def _train_ranks(tmp_path, runs, world, extra=""):
    """``runner.train`` of each of ``runs`` in ``world`` ranks (rank 0
    writing ``<label>.pt`` checkpoints under ``tmp``), then ``extra``:
    label -> every rank's weights and history, and the ranks' directory."""
    tmp = run_ranks(tmp_path, textwrap.dedent(f"""
        from position_induced_transformer_torch import configs
        from position_induced_transformer_torch.train import runner
        out = {{}}
        for label, (name, overrides, kw, mesh) in {runs!r}.items():
            cfg = configs.apply_overrides(configs.get(name), overrides)
            _, state, hist = runner.train(cfg, verbose=False, device="cpu", mesh=mesh,
                                          checkpoint_path=os.path.join(tmp, label + ".pt"), **kw)
            out[label] = {{"weights": state.model.state_dict(), "history": hist,
                           "moments": state.optimizer.state_dict()["state"]}}
        torch.save(out, os.path.join(tmp, f"rank{{rank}}.pt"))
    """) + textwrap.dedent(extra), world=world)
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(world)]
    return {label: [r[label] for r in ranks] for label in runs}, tmp


# each rank's part: one step of a burgers state at model=2, the shapes of its
# parameters and of their Adam moments; evaluate and infer with the whole
# weights of the trained checkpoint
PARTS = """
    import dataclasses
    from position_induced_transformer_torch.parallel import parse_mesh_spec, shard_state
    from position_induced_transformer_torch.train import benchmarks, evaluate, loop
    mesh = parse_mesh_spec("model=2")
    cfg = configs.apply_overrides(configs.get("burgers"), {burgers!r})
    problem = benchmarks.setup(cfg, ntrain=16, ntest=8, device="cpu")
    state = shard_state(mesh, runner.init_state(problem, 0))
    task = dataclasses.replace(problem.task, model=state.model)
    data = {{k: torch.from_numpy(v) for k, v in problem.train_data.items()}}
    loop.make_train_epoch(task, lambda step: cfg.lr, mesh=mesh)(
        state, problem.geom, data, torch.arange(8).reshape(1, 8))
    params = dict(state.model.named_parameters())
    moments = {{n: {{k: tuple(v.shape) for k, v in state.optimizer.state[p].items()
                    if k != "step"}} for n, p in params.items()}}
    ck = os.path.join(tmp, "burgers.pt")
    x = np.load({x_path!r})
    np.save(os.path.join(tmp, f"in_rank{{rank}}.npy"), x)
    evaluate.infer(cfg, ck, os.path.join(tmp, f"in_rank{{rank}}.npy"),
                   output_path=os.path.join(tmp, f"infer_rank{{rank}}.npy"), device="cpu",
                   mesh=mesh)
    torch.save({{"shapes": {{n: tuple(p.shape) for n, p in params.items()}}, "moments": moments,
                 "evaluate": evaluate.evaluate(cfg, ck, ntest=13, device="cpu", mesh=mesh)}},
               os.path.join(tmp, f"parts{{rank}}.pt"))
"""


@pytest.fixture(scope="module")
def model2(tmp_path_factory):
    """Every run of MODEL2 at model=2 in one pair of ranks, then PARTS."""
    tmp = tmp_path_factory.mktemp("model2")
    x = np.asarray(t_bench.setup(_cfg("burgers", BURGERS), ntrain=8, ntest=5,
                                 device="cpu").test_data["x"])
    np.save(tmp / "x.npy", x)
    extra = PARTS.format(burgers=BURGERS, x_path=str(tmp / "x.npy"))
    runs, out = _train_ranks(tmp, MODEL2, 2, extra)
    return runs, out, x


@pytest.fixture(scope="module")
def mesh4(tmp_path_factory):
    """Every run of MESH4 in one world of four ranks."""
    return _train_ranks(tmp_path_factory.mktemp("mesh4"), MESH4, 4)[0]


def _single(name, overrides, kw):
    kw = {k: v for k, v in kw.items()}
    return t_runner.train(_cfg(name, overrides), verbose=False, device="cpu", **kw)


def _assert_same_training(ranks, state, hist, w_tol=(2e-4, 2e-5), loss_rtol=1e-4):
    ref = state.model.state_dict()
    for got in ranks:
        assert set(got["weights"]) == set(ref)
        for k, v in ref.items():
            assert got["weights"][k].shape == v.shape, k  # the one-process layout
            np.testing.assert_allclose(got["weights"][k].numpy(), v.numpy(),
                                       rtol=w_tol[0], atol=w_tol[1], err_msg=k)
        assert len(got["history"]) == len(hist)
        for r1, r2 in zip(hist, got["history"]):
            for k in r1:  # the loss and every metric
                if k not in ("epoch", "seconds"):
                    np.testing.assert_allclose(r2[k], r1[k], rtol=loss_rtol, err_msg=k)
    timeless = lambda h: [{k: v for k, v in row.items() if k != "seconds"} for row in h]
    for got in ranks[1:]:
        assert timeless(got["history"]) == timeless(ranks[0]["history"])
        for k, v in got["weights"].items():
            torch.testing.assert_close(v, ranks[0]["weights"][k], rtol=0, atol=0)


@pytest.fixture
def fake_world():
    def make(world, rank=0):
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)

    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


def test_mesh_axes_and_rank_order_match_jax(fake_world):
    """tests/test_parallel.py:43: ``make_mesh(n_data=4, n_model=2)`` has
    JAX's axes, and rank r sits where JAX's mesh puts device r (the model
    index fastest): its batch index and model index are device r's place
    in JAX's (data, model) array; also for (dcn, data, model)."""
    for kw, axes in ((dict(n_data=4, n_model=2), ("data", "model")),
                     (dict(n_data=2, n_model=2, n_dcn=2), ("dcn", "data", "model"))):
        j = j_make_mesh(**kw)
        assert j.axis_names == axes
        where = {d.id: idx for idx, d in np.ndenumerate(np.asarray(j.devices))}
        for r in range(8):
            fake_world(8, rank=r)
            t = make_mesh(**kw)
            assert dict(j.shape) == {k: getattr(t, k) for k in axes}
            *outer, m = where[r]
            batch = outer[0] * j.shape["data"] + outer[1] if len(outer) == 2 else outer[0]
            assert (t.batch_rank, t.model_rank, t.rank) == (batch, m, r)
            dist.destroy_process_group()


@pytest.mark.parametrize("label", ["model=2", "data=2,model=2", "dcn=2,data=1,model=2"])
def test_runner_train_model_mesh_matches_single_process(model2, mesh4, label):
    """tests/test_parallel.py:493 (and :464's dcn mesh) on the port: the
    MLPs and heads split over the model ranks, the batch over the data (x
    dcn) ranks, the padded eval tail (ntest 13) shared out; every rank
    returns the whole weights of the one-process run's trajectory."""
    ranks = model2[0]["burgers"] if label == "model=2" else mesh4[label]
    _, state, hist = _single("burgers", BURGERS, TRAIN)
    _assert_same_training(ranks, state, hist)


def test_model_mesh_with_replicated_heads_matches_single_process(model2):
    """Three heads at model=2: the bandwidths stay whole on both ranks
    (JAX's rule shards them only where the axis divides the heads), every
    rank computes every head, and the MLPs still split."""
    _, _, kw, _ = MODEL2["heads3"]
    _assert_same_training(model2[0]["heads3"], *_single("burgers", MODEL2["heads3"][1], kw)[1:])


def test_model_mesh_bptt_matches_single_process(model2):
    """Vorticity's BPTT under model=2 (3 rollout steps at a CPU size,
    instance norm): each step's forward checkpointed and recomputed, its
    collectives with it, in the backward."""
    _, overrides, kw, _ = MODEL2["vorticity"]
    _assert_same_training(model2[0]["vorticity"], *_single("vorticity", overrides, kw)[1:])


def test_model_mesh_per_sample_geometry_matches_single_process(model2):
    """Elasticity's per-sample clouds under model=2: the batched kernels
    (#7/#8 on a card) run on one head a rank; ntest 9 pads the eval tail."""
    _, overrides, kw, _ = MODEL2["elasticity"]
    _assert_same_training(model2[0]["elasticity"], *_single("elasticity", overrides, kw)[1:])


def test_bf16_composes_with_data_model_mesh(mesh4):
    """tests/test_parallel.py:965: bf16 activations at data=2,model=2
    against the single-process bf16 run at the JAX test's bounds."""
    _, overrides, kw, _ = MESH4["bf16"]
    _assert_same_training(mesh4["bf16"], *_single("burgers", overrides, kw)[1:],
                          w_tol=(2e-2, 2e-3), loss_rtol=1e-2)


def test_each_rank_holds_its_part(model2):
    """Under model=2 each rank holds half of every MLP hidden width (mlp1's
    rows and bias, mlp2's columns) and of its Adam moments, one of the two
    heads' bandwidths, and mlp2's whole bias."""
    whole = t_bench._make_model(_cfg("burgers", BURGERS)).state_dict()
    for r in range(2):
        parts = torch.load(os.path.join(model2[1], f"parts{r}.pt"))
        for name, shape in parts["shapes"].items():
            full = tuple(whole[name].shape)
            if name.endswith("mlp1.weight") or name.endswith("mlp1.bias") or name.endswith("lmda"):
                want = (full[0] // 2,) + full[1:]
            elif name.endswith("mlp2.weight"):
                want = (full[0], full[1] // 2)
            else:
                want = full
            assert shape == want, name
            assert parts["moments"][name] == {"exp_avg": want, "exp_avg_sq": want}, name


def test_gathered_checkpoint_loads_in_one_process(model2):
    """Rank 0 writes the gathered training checkpoint: it loads into one
    process's model and optimizer, its weights are the ones every rank
    returned, and its moments have the whole shapes."""
    ck = t_ckpt.restore(os.path.join(model2[1], "burgers.pt"))
    cfg = _cfg("burgers", BURGERS)
    problem = t_bench.setup(cfg, ntrain=16, ntest=8, device="cpu")
    state = t_runner.init_state(problem, 0)
    state.model.load_state_dict(ck["state_dict"])
    state.optimizer.load_state_dict(ck["optimizer"])
    for k, v in model2[0]["burgers"][0]["weights"].items():
        torch.testing.assert_close(ck["state_dict"][k], v, rtol=0, atol=0)
    for p, st in zip(state.model.parameters(), ck["optimizer"]["state"].values()):
        assert st["exp_avg"].shape == st["exp_avg_sq"].shape == p.shape
    assert ck["step"] == 8


def test_evaluate_and_infer_under_model_mesh_replicate_weights(model2):
    """``evaluate`` and ``infer`` at model=2 (the whole weights on both
    ranks, as the JAX package replicates them) against one process:
    metrics rtol 1e-5 on both ranks, predictions rtol 1e-5 / atol 1e-6."""
    runs, tmp, x = model2
    ck = os.path.join(tmp, "burgers.pt")
    cfg = _cfg("burgers", BURGERS)
    want = t_eval.evaluate(cfg, ck, ntest=13, device="cpu")
    pred = t_eval.Predictor(cfg, ck, device="cpu").predict_array({"x": x})
    for r in range(2):
        got = torch.load(os.path.join(tmp, f"parts{r}.pt"))["evaluate"]
        for k in ("rel_l1", "rel_l2", "rel_max"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    # only rank 0 writes the output
    assert not os.path.exists(os.path.join(tmp, "infer_rank1.npy"))
    np.testing.assert_allclose(np.load(os.path.join(tmp, "infer_rank0.npy")), pred,
                               rtol=1e-5, atol=1e-6)


def test_model_axis_rejects_indivisible_width(fake_world):
    """tests/test_parallel.py:444: hid 16 at model=3 raises the JAX
    package's ValueError, naming the parameter, from ``shard_state`` and
    from ``runner.train``; nothing falls back to a replicated MLP."""
    jcfg, jproblem = _jax_problem()
    jstate = j_runner.init_state(jproblem, j_make_optimizer(jcfg.lr, 4), seed=0)
    with pytest.raises(ValueError, match="not divisible by the 'model'"):
        j_shard_state(j_make_mesh(n_data=2, n_model=3), jstate)
    fake_world(6)
    mesh = make_mesh(n_data=2, n_model=3)
    cfg = _cfg("burgers", BURGERS)
    problem = t_bench.setup(cfg, ntrain=16, ntest=8, device="cpu")
    with pytest.raises(ValueError, match=r"not divisible by the 'model' axis size 3.*"):
        shard_state(mesh, t_runner.init_state(problem, 0))
    with pytest.raises(ValueError, match="en_layer.mlp1.weight is not divisible by the 'model'"):
        param_shardings(mesh, problem.model)
    with pytest.raises(ValueError, match="not divisible by the 'model'"):
        t_runner.train(cfg, verbose=False, device="cpu", ntrain=16, ntest=8,
                       mesh="data=2,model=3")


def _jax_problem():
    jcfg = dataclasses.replace(
        j_configs.BURGERS, grid=(64,), latent_grid=(16,), batch_size=8,
        model=dataclasses.replace(j_configs.BURGERS.model, hid_dim=16, n_blocks=2))
    return jcfg, j_bench.setup(jcfg, ntrain=16, ntest=8)


def test_tensor_parallel_step_matches_jax(tmp_path):
    """One step at data=2,model=2 of the port's ``make_train_epoch`` on a
    ``shard_state`` part against the JAX package's ``make_train_epoch`` on
    a ``shard_state``-placed state over four of its fake devices
    (tests/test_parallel.py:48), both from the JAX weights (carried over by
    ``flax_params_to_state_dict``) on one batch of 8: the loss rtol 1e-4,
    the gathered weights rtol 2e-4 / atol 2e-5."""
    from position_induced_transformer_torch.utils.torch_compat import flax_params_to_state_dict

    jcfg, problem = _jax_problem()
    optimizer = j_make_optimizer(jcfg.lr, 16)
    state = j_runner.init_state(problem, optimizer, seed=0)
    weights = {k: v.numpy() for k, v in flax_params_to_state_dict(state.params).items()}
    batch = jax.tree_util.tree_map(lambda a: np.asarray(a[:8]), problem.train_data)
    np.savez(tmp_path / "inputs.npz", **{f"w.{k}": v for k, v in weights.items()},
             x=batch["x"], y=batch["y"])
    mesh = j_make_mesh(n_data=2, n_model=2)
    epoch = j_make_train_epoch(problem.task, optimizer, mesh=mesh)
    jstate, jloss = epoch(j_shard_state(mesh, state), j_replicate(mesh, problem.geom),
                          j_replicate(mesh, problem.train_data), jnp.arange(8).reshape(1, 8))

    tmp = run_ranks(tmp_path, f"""
        import dataclasses
        from position_induced_transformer_torch import configs
        from position_induced_transformer_torch.parallel import parse_mesh_spec, shard_state
        from position_induced_transformer_torch.parallel.tensor_parallel import gather_state_dict
        from position_induced_transformer_torch.train import benchmarks, loop, runner
        cfg = configs.apply_overrides(configs.get("burgers"), {BURGERS!r})
        problem = benchmarks.setup(cfg, ntrain=16, ntest=8, device="cpu")
        state = runner.init_state(problem, 0)
        inp = np.load({str(tmp_path / "inputs.npz")!r})
        state.model.load_state_dict({{k[2:]: torch.from_numpy(inp[k]) for k in inp.files
                                      if k.startswith("w.")}})
        mesh = parse_mesh_spec("data=2,model=2")
        state = shard_state(mesh, state)
        task = dataclasses.replace(problem.task, model=state.model)
        data = {{k: torch.from_numpy(inp[k]) for k in ("x", "y")}}
        state, losses = loop.make_train_epoch(task, lambda step: cfg.lr, mesh=mesh)(
            state, problem.geom, data, torch.arange(8).reshape(1, 8))
        torch.save({{"loss": losses[0], "weights": gather_state_dict(mesh, state.model)}},
                   os.path.join(tmp, f"rank{{rank}}.pt"))
    """, world=4)
    want = {k: np.asarray(v) for k, v in flax_params_to_state_dict(jstate.params).items()}
    for r in range(4):
        got = torch.load(os.path.join(tmp, f"rank{r}.pt"))
        np.testing.assert_allclose(float(got["loss"]), float(jloss), rtol=1e-4)
        for k, v in want.items():
            np.testing.assert_allclose(got["weights"][k].numpy(), v, rtol=2e-4, atol=2e-5,
                                       err_msg=k)
