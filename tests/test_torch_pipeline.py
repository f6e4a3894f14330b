"""The port's pipeline (stage) axis (``parallel.pipeline``: the GPipe
stage split of the processor, ``mesh="stage=K"``) on the CPU under gloo,
each rank a process of its own (tests/torch_ranks.py), against the
single-process port and the JAX package's ``make_pipelined_apply`` on its
fake CPU devices, at the tolerances of the JAX package's
tests/test_parallel.py: forwards rtol 2e-5 / atol 1e-5, gradients 5e-4 /
5e-5, training weights 2e-4 / 2e-5 and losses 1e-4, metrics 1e-5.
"""

import dataclasses
import os
import textwrap
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from position_induced_transformer_torch import configs as t_configs
from position_induced_transformer_torch.parallel import pipeline as t_pipeline
from position_induced_transformer_torch.train import benchmarks as t_bench
from position_induced_transformer_torch.train import evaluate as t_eval
from position_induced_transformer_torch.train import runner as t_runner
from position_induced_transformer_torch.utils.torch_compat import flax_params_to_state_dict
from position_induced_transformer_tpu import configs as j_configs
from position_induced_transformer_tpu.models import PiT as JPiT
from position_induced_transformer_tpu.models import build_geometry as j_build_geometry
from position_induced_transformer_tpu.parallel import pipeline as j_pipeline
from position_induced_transformer_tpu.train import benchmarks as j_bench
from position_induced_transformer_tpu.train import make_optimizer as j_make_optimizer
from position_induced_transformer_tpu.train import runner as j_runner
from tests.torch_ranks import run_ranks

BURGERS = ["grid=64", "latent_grid=16", "batch_size=8", "model.hid_dim=16", "model.n_blocks=2"]
DEEP = BURGERS[:-1] + ["model.n_blocks=4"]
FWD_TOL, GRAD_TOL, W_TOL = (2e-5, 1e-5), (5e-4, 5e-5), (2e-4, 2e-5)


def _cfg(overrides):
    return t_configs.apply_overrides(t_configs.BURGERS, overrides)


def _jax_cfg(n_blocks):
    return dataclasses.replace(
        j_configs.BURGERS, grid=(64,), latent_grid=(16,), batch_size=8,
        model=dataclasses.replace(j_configs.BURGERS.model, hid_dim=16, n_blocks=n_blocks))


def _jax_case(n_blocks, n_stages, n_micro, grads=False):
    """The JAX package's pipelined forward (and its gradients of the summed
    squared error) on 8 test inputs of the narrow Burgers model, beside
    the inputs and weights in the port's layout."""
    cfg = _jax_cfg(n_blocks)
    problem = j_bench.setup(cfg, ntrain=16, ntest=8)
    model = problem.task.model
    params = j_runner.init_state(problem, j_make_optimizer(cfg.lr, 10), seed=0).params
    x = jnp.asarray(np.asarray(problem.test_data["x"][:8]))
    y = jnp.asarray(np.asarray(problem.test_data["y"][:8]))
    pp = j_pipeline.make_pipelined_apply(model, j_pipeline.make_stage_mesh(n_stages), n_micro)
    case = {"x": np.asarray(x), "y": np.asarray(y),
            "out": np.asarray(jax.jit(pp)(params, problem.geom, x)),
            **{f"w.{k}": v.numpy() for k, v in flax_params_to_state_dict(params).items()}}
    if grads:
        g = jax.jit(jax.grad(lambda p: jnp.sum((pp(p, problem.geom, x) - y) ** 2)))(params)
        case.update({f"g.{k}": v.numpy() for k, v in flax_params_to_state_dict(g).items()})
    return case


def _jax_norm_cases():
    """tests/test_parallel.py:314's two models (instance norm; residual
    output), their pipelined outputs at 2 stages x 2 micro-batches."""
    m = jnp.linspace(0, 1, 33)[:-1].reshape(-1, 1)
    ltt = jnp.linspace(0, 1, 9)[:-1].reshape(-1, 1)
    geom = j_build_geometry(m, ltt, m, metric="euclidean", en_loc=0.1, de_loc=0.1)
    out = {}
    for label in ("use_instance_norm", "residual_output"):
        model = JPiT(space_dim=1, in_dim=1, out_dim=1, hid_dim=8, n_head=2, n_blocks=2,
                     en_loc=0.1, de_loc=0.1, **{label: True})
        x = jax.random.uniform(jax.random.PRNGKey(2), (4, 32, 1))
        params = model.init(jax.random.PRNGKey(0), geom, x)["params"]
        pp = j_pipeline.make_pipelined_apply(model, j_pipeline.make_stage_mesh(2), n_micro=2)
        out[label] = {"x": np.asarray(x), "out": np.asarray(jax.jit(pp)(params, geom, x)),
                      **{f"w.{k}": v.numpy() for k, v in flax_params_to_state_dict(params).items()}}
    return out


# the ranks' forwards: a case's weights loaded into the narrow Burgers
# model, its 8 inputs through the pipelined apply; with grads, the
# gradients of the summed squared error of this rank's parameters that
# have one; and the two norm models of tests/test_parallel.py:314
FORWARDS = """
    from position_induced_transformer_torch import configs
    from position_induced_transformer_torch.models import PiT, build_geometry
    from position_induced_transformer_torch.parallel import parse_mesh_spec, pipeline
    from position_induced_transformer_torch.train import benchmarks
    mesh = parse_mesh_spec("stage={stages}")
    case = dict(np.load({case!r}))
    cfg = configs.apply_overrides(configs.BURGERS, {overrides!r})
    problem = benchmarks.setup(cfg, ntrain=16, ntest=8, device="cpu")
    model = problem.model
    model.load_state_dict({{k[2:]: torch.from_numpy(v) for k, v in case.items()
                           if k.startswith("w.")}})
    apply = pipeline.make_pipelined_apply(model, mesh, {n_micro})
    x, y = torch.from_numpy(case["x"]), torch.from_numpy(case["y"])
    out = apply(model, problem.geom, x)
    ((out - y) ** 2).sum().backward()
    res = {{"out": out.detach(),
            "grads": {{k: p.grad for k, p in model.named_parameters() if p.grad is not None}}}}
    if {norms!r}:
        norms = dict(np.load({norms!r}, allow_pickle=True))
        m = torch.linspace(0, 1, 33, dtype=torch.float64)[:-1].float().reshape(-1, 1)
        ltt = torch.linspace(0, 1, 9, dtype=torch.float64)[:-1].float().reshape(-1, 1)
        geom = build_geometry(m, ltt, m, metric="euclidean", en_loc=0.1, de_loc=0.1,
                              device="cpu")
        for label in ("use_instance_norm", "residual_output"):
            c = norms[label].item()
            pit = PiT(space_dim=1, in_dim=1, out_dim=1, hid_dim=8, n_head=2, n_blocks=2,
                      en_loc=0.1, de_loc=0.1, **{{label: True}})
            pit.load_state_dict({{k[2:]: torch.from_numpy(v) for k, v in c.items()
                                 if k.startswith("w.")}})
            xx = torch.from_numpy(c["x"])
            with torch.no_grad():
                res[label] = (pipeline.make_pipelined_apply(pit, mesh, 2)(pit, geom, xx),
                              pit(geom, xx))
    torch.save(res, os.path.join(tmp, f"fwd_rank{{rank}}.pt"))
"""

# vorticity at a CPU size: 20-step BPTT cut to 3, each step's forward
# checkpointed (remat "full"), instance norm on
VORTICITY = ["grid=16,16", "latent_grid=8,8", "rollout_steps=3", "memory=4", "batch_size=8",
             "model.in_dim=4", "ntrain=16", "model.hid_dim=16", "model.n_blocks=2"]

# label -> (benchmark, overrides, runner.train's arguments): run under the stage mesh
STAGE2_RUNS = {
    "train": ("burgers", BURGERS, dict(epochs=2, ntrain=32, ntest=13)),
    "predict7": ("burgers", BURGERS, dict(epochs=1, ntrain=16, ntest=7)),
    "grad_accum": ("burgers", BURGERS, dict(epochs=2, ntrain=16, ntest=8, grad_accum=2)),
    "vorticity": ("vorticity", VORTICITY, dict(epochs=1, ntrain=16, ntest=8)),
}
STAGE4_RUNS = {"grad_accum4": ("burgers", DEEP,
                               dict(epochs=2, ntrain=16, ntest=8, grad_accum=4))}

TRAINS = """
    from position_induced_transformer_torch.train import evaluate, runner
    from position_induced_transformer_torch.train.serve import make_server
    out = {{}}
    for label, (name, overrides, kw) in {runs!r}.items():
        cfg = configs.apply_overrides(configs.get(name), overrides)
        problem, state, hist = runner.train(cfg, verbose=False, device="cpu", mesh=mesh, **kw)
        out[label] = {{"weights": state.model.state_dict(), "history": hist,
                       "pp_micro": problem.task.pp_micro}}
        if label == "predict7":
            out[label]["pred"] = runner.predict(problem, mesh=mesh)
    if {ckpt!r}:
        cfg = configs.apply_overrides(configs.BURGERS, {overrides!r})
        out["evaluate"] = evaluate.evaluate(cfg, {ckpt!r}, ntest=8, device="cpu", mesh=mesh)
        x = np.load({x_path!r})
        np.save(os.path.join(tmp, f"in{{rank}}.npy"), x)
        evaluate.infer(cfg, {ckpt!r}, os.path.join(tmp, f"in{{rank}}.npy"),
                       output_path=os.path.join(tmp, "infer.npy"), device="cpu", mesh=mesh)
        server = make_server(cfg, {ckpt!r}, port=0, verbose=False, device="cpu", mesh=mesh)
        if rank == 0:
            import io, threading, urllib.request
            threading.Thread(target=server.serve_forever, daemon=True).start()
            buf = io.BytesIO()
            np.save(buf, x)
            req = urllib.request.Request(
                f"http://127.0.0.1:{{server.server_address[1]}}/predict", data=buf.getvalue(),
                headers={{"Content-Type": "application/octet-stream"}})
            with urllib.request.urlopen(req, timeout=120) as r:
                out["served"] = np.load(io.BytesIO(r.read()))
            server.shutdown()
        else:
            server.serve_forever()  # until rank 0 closes
        server.server_close()
    torch.save(out, os.path.join(tmp, f"train_rank{{rank}}.pt"))
"""


def _ranks(tmp, world, body):
    run_ranks(tmp, body, world=world, name="ranks", timeout=300)
    return os.path.join(str(tmp), "ranks")


@pytest.fixture(scope="module")
def stage2(tmp_path_factory):
    """Two ranks at stage=2: the forward and gradients at 4 micro-batches
    and the norm models against JAX; STAGE2_RUNS; then evaluate, infer and
    a served batch of a single-process checkpoint."""
    tmp = tmp_path_factory.mktemp("stage2")
    case = _jax_case(2, 2, 4, grads=True)
    np.savez(tmp / "case.npz", **case)
    norms = _jax_norm_cases()
    np.savez(tmp / "norms.npz", **{k: np.array(v, dtype=object) for k, v in norms.items()})
    ckpt = str(tmp / "single.pt")
    t_runner.train(_cfg(BURGERS), verbose=False, device="cpu", epochs=1, ntrain=16, ntest=8,
                   checkpoint_path=ckpt)
    x = np.asarray(t_bench.setup(_cfg(BURGERS), ntrain=8, ntest=5, device="cpu").test_data["x"])
    np.save(tmp / "x.npy", x)
    body = textwrap.dedent(FORWARDS.format(
        stages=2, case=str(tmp / "case.npz"), overrides=BURGERS, n_micro=4,
        norms=str(tmp / "norms.npz"))) + textwrap.dedent(TRAINS.format(
            runs=STAGE2_RUNS, ckpt=ckpt, overrides=BURGERS, x_path=str(tmp / "x.npy")))
    out = _ranks(tmp, 2, body)
    return out, case, norms, ckpt, x


@pytest.fixture(scope="module")
def stage4(tmp_path_factory):
    """Four ranks at stage=4: the forward of a 4-block processor at 2
    micro-batches against JAX, and STAGE4_RUNS."""
    tmp = tmp_path_factory.mktemp("stage4")
    case = _jax_case(4, 4, 2)
    np.savez(tmp / "case.npz", **case)
    body = textwrap.dedent(FORWARDS.format(
        stages=4, case=str(tmp / "case.npz"), overrides=DEEP, n_micro=2, norms="")) + \
        textwrap.dedent(TRAINS.format(runs=STAGE4_RUNS, ckpt="", overrides=DEEP, x_path=""))
    return _ranks(tmp, 4, body), case


def _single_forward(overrides, case):
    """The one-process port's forward (and gradients) of a case."""
    problem = t_bench.setup(_cfg(overrides), ntrain=16, ntest=8, device="cpu")
    model = problem.model
    model.load_state_dict({k[2:]: torch.from_numpy(v) for k, v in case.items()
                           if k.startswith("w.")})
    x, y = torch.tensor(case["x"]), torch.tensor(case["y"])
    out = model(problem.geom, x)
    ((out - y) ** 2).sum().backward()
    return out.detach(), {k: p.grad for k, p in model.named_parameters()}


@pytest.mark.parametrize("stages", [2, 4])
def test_pipelined_forward_matches_single_process_and_jax(stage2, stage4, stages):
    """tests/test_parallel.py:194 (2 stages x 4 micro-batches) and :217 (4
    stages x 2, a 4-block processor): every rank's pipelined output
    against one process and against the JAX package's pipelined apply on
    the same weights."""
    out, case = (stage2[0], stage2[1]) if stages == 2 else stage4
    want, _ = _single_forward(BURGERS if stages == 2 else DEEP, case)
    for r in range(stages):
        got = torch.load(os.path.join(out, f"fwd_rank{r}.pt"))["out"]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=FWD_TOL[0], atol=FWD_TOL[1])
        np.testing.assert_allclose(got.numpy(), case["out"], rtol=FWD_TOL[0], atol=FWD_TOL[1])


def test_pipeline_gradients_match_single_process_and_jax(stage2):
    """tests/test_parallel.py:246: gradients flow through the schedule.
    Each rank holds the gradients of the replicated encoder and decoder
    (equal on both ranks to the bit) and of its own stage's blocks; joined,
    they are one process's and JAX's (``jax.grad`` of its pipelined
    apply)."""
    out, case = stage2[0], stage2[1]
    _, want = _single_forward(BURGERS, case)
    ranks = [torch.load(os.path.join(out, f"fwd_rank{r}.pt"))["grads"] for r in range(2)]
    owner = lambda k: int(k.split(".")[1]) if k.startswith(("conv.", "mlp.")) else None  # a block a stage
    for k, g in want.items():
        o = owner(k)
        if o is None:
            torch.testing.assert_close(ranks[0][k], ranks[1][k], rtol=0, atol=0)
            got = ranks[0][k]
        else:
            assert k not in ranks[1 - o], k  # another stage's block keeps no gradient
            got = ranks[o][k]
        np.testing.assert_allclose(got.numpy(), g.numpy(), rtol=GRAD_TOL[0], atol=GRAD_TOL[1],
                                   err_msg=k)
        np.testing.assert_allclose(got.numpy(), case[f"g.{k}"], rtol=GRAD_TOL[0],
                                   atol=GRAD_TOL[1], err_msg=k)


@pytest.mark.parametrize("label", ["use_instance_norm", "residual_output"])
def test_pipeline_with_instance_norm_and_residual(stage2, label):
    """tests/test_parallel.py:314: the pipelined apply mirrors
    ``PiT.forward`` with instance norm and with a residual output, against
    one process and JAX's pipelined apply."""
    out, norms = stage2[0], stage2[2]
    for r in range(2):
        got, single = torch.load(os.path.join(out, f"fwd_rank{r}.pt"))[label]
        np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=FWD_TOL[0], atol=FWD_TOL[1])
        np.testing.assert_allclose(got.numpy(), norms[label]["out"], rtol=FWD_TOL[0],
                                   atol=FWD_TOL[1])


def _train_ranks(out, world):
    return [torch.load(os.path.join(out, f"train_rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _assert_same_training(ranks, label, name, overrides, kw):
    kw = {k: v for k, v in kw.items() if k != "grad_accum"}  # against the unsplit batch
    cfg = t_configs.apply_overrides(t_configs.get(name), overrides)
    _, state, hist = t_runner.train(cfg, verbose=False, device="cpu", **kw)
    for got in ranks:
        got = got[label]
        for k, v in state.model.state_dict().items():
            np.testing.assert_allclose(got["weights"][k].numpy(), v.numpy(), rtol=W_TOL[0],
                                       atol=W_TOL[1], err_msg=k)
        for r1, r2 in zip(hist, got["history"], strict=True):
            for k in r1:
                if k not in ("epoch", "seconds"):
                    np.testing.assert_allclose(r2[k], r1[k], rtol=1e-4, err_msg=k)
    for got in ranks[1:]:  # every rank returns the whole model, equal to the bit
        for k, v in got[label]["weights"].items():
            torch.testing.assert_close(v, ranks[0][label]["weights"][k], rtol=0, atol=0)


@pytest.mark.parametrize("label", ["train", "grad_accum", "grad_accum4", "vorticity"])
def test_runner_train_pipeline_mesh_matches_single_process(stage2, stage4, label):
    """tests/test_parallel.py:556 (ntest 13: the padded eval tail through
    the micro-batched schedule), :910 (``grad_accum=2`` at stage=2) and
    :936 (stage=4 with ``grad_accum=4`` on batch 8: the schedule picked
    from the 2-sample forward, 2 micro-batches), and vorticity's BPTT
    (instance norm; each rollout step's forward checkpointed and
    recomputed, its sends with it, in the backward): every rank returns
    the one-process trajectory's whole weights."""
    if label == "grad_accum4":
        ranks, run = _train_ranks(stage4[0], 4), STAGE4_RUNS[label]
    else:
        ranks, run = _train_ranks(stage2[0], 2), STAGE2_RUNS[label]
    assert all(r[label]["pp_micro"] == 2 for r in ranks)
    _assert_same_training(ranks, label, *run)


def test_predict_after_pipeline_train_rounds_microbatches(stage2):
    """tests/test_parallel.py:584: with ntest 7 the prediction batch (7) is
    rounded to the schedule's 2 micro-batches, and the prediction is one
    process's."""
    ranks = _train_ranks(stage2[0], 2)
    p1, s1, _ = t_runner.train(_cfg(BURGERS), verbose=False, device="cpu",
                               **STAGE2_RUNS["predict7"][2])
    want = t_runner.predict(p1)
    for r in ranks:
        assert r["predict7"]["pred"].shape == want.shape == (7, 64, 1)
        np.testing.assert_allclose(r["predict7"]["pred"], want, rtol=W_TOL[0], atol=W_TOL[1])


def test_evaluate_infer_and_serve_under_stage_mesh(stage2):
    """tests/test_parallel.py:752: ``evaluate(mesh="stage=2")`` of a
    single-process checkpoint against one process (rtol 1e-5); ``infer``
    and a server under stage=2 (every rank in every forward through the
    broadcast calls) reply alike to the bit and within rtol 1e-5 / atol
    1e-6 of one process."""
    out, _, _, ckpt, x = stage2
    cfg = _cfg(BURGERS)
    want = t_eval.evaluate(cfg, ckpt, ntest=8, device="cpu")
    ranks = _train_ranks(out, 2)
    for r in ranks:
        for k in ("rel_l1", "rel_l2", "rel_max"):
            np.testing.assert_allclose(r["evaluate"][k], want[k], rtol=1e-5, err_msg=k)
    served, inferred = ranks[0]["served"], np.load(os.path.join(out, "infer.npy"))
    np.testing.assert_array_equal(served, inferred)
    pred = t_eval.Predictor(cfg, ckpt, device="cpu").predict_array({"x": x})
    np.testing.assert_allclose(served, pred, rtol=1e-5, atol=1e-6)


@pytest.fixture
def fake_world():
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    yield
    dist.destroy_process_group()


def test_pipeline_refuses_tf_family_and_per_sample_geometry(fake_world):
    """tests/test_parallel.py:608: the TF family and per-sample meshes are
    not stage-splittable (ValueError, "torch-family"), in ``runner.train``
    and ``evaluate``; a block count the stages do not divide raises."""
    tf = dataclasses.replace(t_configs.BURGERS_TF, grid=(64,), latent_grid=(32,))
    kw = dict(verbose=False, device="cpu", epochs=1, mesh="stage=2")
    with pytest.raises(ValueError, match="torch-family"):
        t_runner.train(tf, ntrain=8, ntest=4, **kw)
    with pytest.raises(ValueError, match="torch-family"):
        t_runner.train(t_configs.apply_overrides(t_configs.ELASTICITY, ["batch_size=4"]),
                       ntrain=8, ntest=4, setup_kwargs={"n_points": 48}, **kw)
    with pytest.raises(ValueError, match="n_blocks=5 not divisible by n_stages=2"):
        t_runner.train(_cfg(BURGERS[:-1] + ["model.n_blocks=5"]), ntrain=16, ntest=8, **kw)


@pytest.mark.parametrize("batch,stages,env", [
    (8, 2, None), (8, 4, None), (6, 4, None), (9, 4, None), (1, 4, None), (7, 4, None),
    (8, 2, "3"),
])
def test_pick_n_micro_matches_jax(monkeypatch, batch, stages, env):
    """``_pick_n_micro``'s cases against the JAX package's: the stage
    count where it divides the batch, else the largest divisor in [2,
    stages], else 1 with the same warning; ``PIT_PP_MICRO`` overrides."""
    if env:
        monkeypatch.setenv("PIT_PP_MICRO", env)
    else:
        monkeypatch.delenv("PIT_PP_MICRO", raising=False)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = j_pipeline._pick_n_micro(batch, stages)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = t_pipeline._pick_n_micro(batch, stages)
    assert got == want
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert bool(tw) == (batch == 7 and env is None)
