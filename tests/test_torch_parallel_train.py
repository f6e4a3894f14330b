"""The port's data-parallel training (``runner.train(mesh=...)``, the
explicit-collective step ``parallel.shard_map_step``) on the CPU under
gloo, each rank a process of its own (tests/torch_ranks.py), against the
single-process port: the cases of the JAX package's tests/test_parallel.py
at its tolerances (weights rtol 2e-4 / atol 2e-5, losses and metrics rtol
1e-4), and one shard-map step against the JAX package's on its fake CPU
devices.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from position_induced_transformer_torch import configs as t_configs
from position_induced_transformer_torch.parallel import parse_mesh_spec
from position_induced_transformer_torch.train import runner as t_runner
from position_induced_transformer_tpu import configs as j_configs
from position_induced_transformer_tpu.parallel import make_mesh as j_make_mesh
from position_induced_transformer_tpu.parallel import replicate_tree as j_replicate
from position_induced_transformer_tpu.parallel.shard_map_step import (
    make_shard_map_train_step as j_make_step,
    shard_batch_arrays as j_shard_batch,
)
from position_induced_transformer_tpu.train import benchmarks as j_bench
from position_induced_transformer_tpu.train import runner as j_runner
from position_induced_transformer_tpu.train.loop import make_optimizer as j_make_optimizer
from tests.torch_ranks import run_ranks

BURGERS = ["grid=64", "latent_grid=16", "batch_size=8", "model.hid_dim=16", "model.n_blocks=2"]
ELASTICITY = ["batch_size=8", "model.hid_dim=16", "model.n_blocks=2"]


def _cfg(name, overrides):
    return t_configs.apply_overrides(t_configs.get(name), overrides)


# name, overrides, runner.train's arguments: each run at data=2, one after
# another in the same two ranks
RUNS = {
    "burgers": ("burgers", BURGERS, dict(epochs=2, ntrain=32, ntest=13)),
    "elasticity": ("elasticity", ELASTICITY,
                   dict(epochs=2, ntrain=16, ntest=9, setup_kwargs={"n_points": 48})),
    "grad_accum": ("burgers", BURGERS, dict(epochs=2, ntrain=16, ntest=8, grad_accum=2)),
    "bf16": ("burgers", BURGERS + ["model.compute_dtype=bfloat16"],
             dict(epochs=2, ntrain=16, ntest=8)),
}


def _train_ranks(tmp_path, runs, world, mesh):
    """``runner.train`` of each of ``runs`` in ``world`` ranks: label ->
    every rank's weights and history."""
    tmp = run_ranks(tmp_path, f"""
        from position_induced_transformer_torch import configs
        from position_induced_transformer_torch.train import runner
        out = {{}}
        for label, (name, overrides, kw) in {runs!r}.items():
            cfg = configs.apply_overrides(configs.get(name), overrides)
            _, state, hist = runner.train(cfg, verbose=False, device="cpu", mesh={mesh!r}, **kw)
            out[label] = {{"weights": state.model.state_dict(), "history": hist}}
        torch.save(out, os.path.join(tmp, f"rank{{rank}}.pt"))
    """, world=world)
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(world)]
    return {label: [r[label] for r in ranks] for label in runs}


@pytest.fixture(scope="module")
def data2(tmp_path_factory):
    """Every run of RUNS at data=2, in one pair of ranks."""
    return _train_ranks(tmp_path_factory.mktemp("data2"), RUNS, 2, "data=2")


def _single(label):
    name, overrides, kw = RUNS[label]
    kw = dict(kw)
    if label == "grad_accum":  # held against the unsplit batch
        kw.pop("grad_accum")
    _, state, hist = t_runner.train(_cfg(name, overrides), verbose=False, device="cpu", **kw)
    return state, hist


def _assert_same_training(ranks, state, hist, w_tol=(2e-4, 2e-5), loss_rtol=1e-4):
    ref = state.model.state_dict()
    for got in ranks:
        for k, v in ref.items():
            np.testing.assert_allclose(got["weights"][k].numpy(), v.numpy(),
                                       rtol=w_tol[0], atol=w_tol[1], err_msg=k)
        assert len(got["history"]) == len(hist)
        for r1, r2 in zip(hist, got["history"]):
            np.testing.assert_allclose(r2["train_loss"], r1["train_loss"], rtol=loss_rtol)
            for k in ("rel_l2", "rel_l1", "rel_max"):
                if k in r1:
                    np.testing.assert_allclose(r2[k], r1[k], rtol=loss_rtol)
    # every rank returns the same weights and history (its own clock apart)
    timeless = lambda h: [{k: v for k, v in row.items() if k != "seconds"} for row in h]
    for got in ranks[1:]:
        assert timeless(got["history"]) == timeless(ranks[0]["history"])
        for k, v in got["weights"].items():
            torch.testing.assert_close(v, ranks[0]["weights"][k], rtol=0, atol=0)


@pytest.mark.parametrize("mesh,world", [("data=2", 2), ("dcn=2,data=2", 4)])
def test_runner_train_mesh_matches_single_process(tmp_path, data2, mesh, world):
    """tests/test_parallel.py:464/:493 on the port: the batch sharded over
    the ranks (``dcn=2,data=2``: the gradient sum within each slice, then
    across slices), the padded eval tail (ntest 13) shared out; the same
    trajectory as one process."""
    if world == 2:
        ranks = data2["burgers"]
    else:
        ranks = _train_ranks(tmp_path, {"burgers": RUNS["burgers"]}, world, mesh)["burgers"]
    _assert_same_training(ranks, *_single("burgers"))


def test_runner_train_mesh_per_sample_geometry_matches_single_process(data2):
    """tests/test_parallel.py:522: elasticity's per-sample clouds ride in
    the batch, so each rank's shard carries its own coordinates (kernels
    #7/#8 on a card); ntest 9 pads the eval tail."""
    _assert_same_training(data2["elasticity"], *_single("elasticity"))


def test_grad_accum_composes_with_data_mesh(data2):
    """tests/test_parallel.py:881: two microbatches a step, each shared out
    over the ranks, the gradients reduced once a step, against the
    unsplit single-process run."""
    _assert_same_training(data2["grad_accum"], *_single("grad_accum"))


def test_bf16_composes_with_data_mesh(data2):
    """The data half of tests/test_parallel.py:965: bf16 activations
    (``model.compute_dtype``) at data=2 against the single-process bf16
    run at the JAX test's bf16 bounds (weights 2e-2 / 2e-3, losses 1e-2)."""
    _assert_same_training(data2["bf16"], *_single("bf16"), w_tol=(2e-2, 2e-3), loss_rtol=1e-2)


@pytest.fixture
def fake_world():
    """A default process group of ``world`` ranks in this one process (the
    ``fake`` backend, which runs no collective): for checks that raise
    before any collective. Destroyed when the test ends."""

    def make(world, rank=0):
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)

    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


def test_runner_train_mesh_rejects_indivisible_batches(fake_world):
    """tests/test_parallel.py:621 and :881's error: a batch, or a grad-accum
    microbatch, that does not divide over the data (x dcn) ranks raises
    before the first step."""
    fake_world(2)
    kw = dict(epochs=1, ntrain=24, ntest=8, verbose=False, device="cpu", mesh="data=2")
    with pytest.raises(ValueError, match="not divisible"):
        t_runner.train(_cfg("burgers", BURGERS + ["batch_size=5"]), **kw)
    with pytest.raises(ValueError, match="data"):
        t_runner.train(_cfg("burgers", BURGERS), grad_accum=8, **kw)


def test_shard_map_step_matches_jax(tmp_path):
    """One step of ``make_shard_map_train_step`` at data=2 against the JAX
    package's on two of its fake CPU devices: the Burgers weights carried
    over with ``flax_params_to_state_dict``, both sides given one batch of
    8; loss and weights at tests/test_torch_train.py's trajectory bounds."""
    from position_induced_transformer_torch.utils.torch_compat import flax_params_to_state_dict

    jcfg = dataclasses.replace(
        j_configs.BURGERS, grid=(64,), latent_grid=(16,), batch_size=8,
        model=dataclasses.replace(j_configs.BURGERS.model, hid_dim=16, n_blocks=2))
    problem = j_bench.setup(jcfg, ntrain=16, ntest=8)
    optimizer = j_make_optimizer(jcfg.lr, 16)
    state = j_runner.init_state(problem, optimizer, seed=0)
    batch = jax.tree_util.tree_map(lambda a: a[:8], problem.train_data)
    weights = {k: v.numpy() for k, v in flax_params_to_state_dict(state.params).items()}
    np.savez(tmp_path / "inputs.npz", **{f"w.{k}": v for k, v in weights.items()},
             x=np.asarray(batch["x"]), y=np.asarray(batch["y"]))

    mesh = j_make_mesh(n_data=2)
    step = j_make_step(problem.task, optimizer, mesh)
    jstate, jloss = step(state, j_replicate(mesh, problem.geom), j_shard_batch(mesh, batch))

    tmp = run_ranks(tmp_path, f"""
        from position_induced_transformer_torch import configs
        from position_induced_transformer_torch.parallel import parse_mesh_spec
        from position_induced_transformer_torch.parallel.shard_map_step import (
            make_shard_map_train_step, shard_batch_arrays)
        from position_induced_transformer_torch.train import benchmarks, runner
        cfg = configs.apply_overrides(configs.get("burgers"), {BURGERS!r})
        problem = benchmarks.setup(cfg, ntrain=16, ntest=8, device="cpu")
        state = runner.init_state(problem, 0)
        inp = np.load({str(tmp_path / "inputs.npz")!r})
        state.model.load_state_dict({{k[2:]: torch.from_numpy(inp[k]) for k in inp.files
                                      if k.startswith("w.")}})
        for g in state.optimizer.param_groups:
            g["lr"] = cfg.lr  # the JAX schedule's value at step 0
        mesh = parse_mesh_spec("data=2")
        step = make_shard_map_train_step(problem.task, state.optimizer, mesh)
        batch = shard_batch_arrays(mesh, {{k: torch.from_numpy(inp[k]) for k in ("x", "y")}})
        state, loss = step(state, problem.geom, batch)
        torch.save({{"loss": loss, "weights": state.model.state_dict()}},
                   os.path.join(tmp, f"rank{{rank}}.pt"))
    """)
    want = {k: np.asarray(v) for k, v in flax_params_to_state_dict(jstate.params).items()}
    for r in range(2):
        got = torch.load(os.path.join(tmp, f"rank{r}.pt"))
        np.testing.assert_allclose(float(got["loss"]), float(jloss), rtol=1e-4)
        for k, v in want.items():
            np.testing.assert_allclose(got["weights"][k].numpy(), v, rtol=2e-4, atol=2e-5,
                                       err_msg=k)


def test_parse_mesh_spec_matches_jax(fake_world):
    """``parse_mesh_spec`` in a world of 8 ranks (the fake backend) against
    the JAX package's on its 8 fake devices: the same specs accepted, with
    the same axis sizes (the model axis too, and the device order: the
    model index varies fastest), and refused, with the same exception type
    and message fragment. A spec naming fewer devices than there are is
    accepted by JAX (it takes a subset) and refused by the port (a rank
    cannot sit out), so the list holds whole-world specs; ``stage=2`` is
    compared in a world of two."""
    from position_induced_transformer_tpu.parallel import parse_mesh_spec as j_parse

    assert len(jax.devices()) == 8
    fake_world(8)
    accepted = [None, "", "none", "1", "auto", "data=8", "dcn=2,data=4", "DCN=4, data=2",
                "data=4,model=2", "dcn=2,data=2,model=2"]
    for spec in accepted:
        j, t = j_parse(spec), parse_mesh_spec(spec)
        assert (j is None) == (t is None), spec
        if j is not None:
            assert (j.shape.get("dcn", 1), j.shape["data"], j.shape["model"]) == (
                t.dcn, t.data, t.model), spec
            # rank r holds the device at position r of JAX's (dcn, data, model) array
            ids = [d.id for d in np.asarray(j.devices).reshape(-1)]
            assert ids == list(range(8)), spec
    refused = [("data=x", "bad mesh spec"), ("data=0", "bad mesh spec"), ("data", "bad mesh spec"),
               ("data=2,data=8", "duplicate mesh axis"), ("rows=2", "unknown mesh axis"),
               ("data=2,stage=2", "cannot be combined"), ("dcn=2,stage=2", "cannot be combined"),
               ("data=16", "devices"), ("dcn=8,data=2", "devices"), ("stage=16", "devices"),
               ("data=4,model=4", "devices")]
    for spec, fragment in refused:
        for parse in (j_parse, parse_mesh_spec):
            with pytest.raises(ValueError, match=fragment):
                parse(spec)
    dist.destroy_process_group()
    fake_world(2)
    j, t = j_parse("stage=2"), parse_mesh_spec("stage=2")
    assert dict(j.shape) == {"stage": t.stage} == {"stage": 2}
