"""The port's model (head) axis for the TF family (``PiTTF``,
``PiTTFPointCloud`` and the ``lite`` / ``transformer`` / ``selfpit``
variants; ``parallel.tensor_parallel``, ``runner.train(mesh="...model=M")``)
on the CPU under gloo, each rank a process of its own
(tests/torch_ranks.py): the parameter layout against the JAX package's
``_param_pspec``; training against the single-process port at the JAX
package's tests/test_parallel.py tolerances (weights rtol 2e-4 / atol 2e-5,
losses and metrics rtol 1e-4; bf16 2e-2 / 2e-3 and 1e-2), with every
replicated parameter equal to the bit on every rank; evaluation,
``Predictor``, ``infer`` and the server with the whole weights against one
process (metrics rtol 1e-5, predictions rtol 1e-5 / atol 1e-6); and one
tensor-parallel step against the JAX package's ``make_train_epoch`` on a
``shard_state``-placed state on its fake CPU devices.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from position_induced_transformer_torch import configs as t_configs
from position_induced_transformer_torch.parallel import DataMesh, make_mesh, param_shardings
from position_induced_transformer_torch.parallel import shard_state
from position_induced_transformer_torch.train import benchmarks as t_bench
from position_induced_transformer_torch.train import evaluate as t_eval
from position_induced_transformer_torch.train import runner as t_runner
from position_induced_transformer_torch.train.serve import make_server
from position_induced_transformer_torch.utils.torch_compat import flax_tf_params_to_state_dict
from position_induced_transformer_tpu import configs as j_configs
from position_induced_transformer_tpu.parallel import make_mesh as j_make_mesh
from position_induced_transformer_tpu.parallel import replicate_tree as j_replicate
from position_induced_transformer_tpu.parallel import shard_state as j_shard_state
from position_induced_transformer_tpu.parallel.sharding import _param_pspec
from position_induced_transformer_tpu.train import benchmarks as j_bench
from position_induced_transformer_tpu.train import make_optimizer as j_make_optimizer
from position_induced_transformer_tpu.train import make_train_epoch as j_make_train_epoch
from position_induced_transformer_tpu.train import runner as j_runner
from tests.test_torch_parallel_model import _assert_same_training, _train_ranks
from tests.torch_ranks import run_ranks

NARROW = ["model.hid_dim=16", "model.n_blocks=2", "batch_size=8"]
BURGERS_TF = ["grid=64", "latent_grid=32"] + NARROW
ELASTICITY_TF = NARROW
DARCY_TF = ["latent_grid=4,4"] + NARROW
CLOUD = {"n_points": 48}  # elasticity_tf's clouds cut to 48 points
TRAIN = dict(epochs=2, ntrain=16, ntest=9)
ONE = dict(epochs=1, ntrain=16, ntest=9)
DARCY_KW = dict(epochs=1, ntrain=16, ntest=8, setup_kwargs={"downsampling": 40})

# label -> (name, overrides, runner.train's arguments, mesh); MODEL2 in two
# ranks at model=2, MESH4 in four ranks
MODEL2 = {
    "burgers_tf": ("burgers_tf", BURGERS_TF, TRAIN, "model=2"),
    "elasticity_tf": ("elasticity_tf", ELASTICITY_TF, dict(TRAIN, setup_kwargs=CLOUD), "model=2"),
    "lite": ("burgers_tf", BURGERS_TF + ["model_variant=lite"], ONE, "model=2"),
    "transformer": ("elasticity_tf", ELASTICITY_TF + ["model_variant=transformer"],
                    dict(ONE, setup_kwargs=CLOUD), "model=2"),
    "selfpit": ("burgers_tf", ["grid=64", "latent_grid=64"] + NARROW + ["model_variant=selfpit"],
                ONE, "model=2"),
}
MESH4 = {
    "data=2,model=2": ("burgers_tf", BURGERS_TF, TRAIN, "data=2,model=2"),
    "dcn=2,data=1,model=2": ("burgers_tf", BURGERS_TF, TRAIN, "dcn=2,data=1,model=2"),
    "bf16": ("burgers_tf", BURGERS_TF + ["model.compute_dtype=bfloat16"],
             dict(epochs=2, ntrain=16, ntest=8), "data=2,model=2"),
    "darcy_tf": ("darcy_tf", DARCY_TF, DARCY_KW, "data=2,model=2"),
}
ZSSR = dict(ntest=8, zssr=True, zssr_downsampling=20)  # 11^2 training grid -> 21^2


def _cfg(name, overrides):
    return t_configs.apply_overrides(t_configs.get(name), overrides)


# each rank's part: one step of an elasticity_tf state at model=2 (its
# parts, moments and the gathered whole); then evaluate, Predictor, infer
# and the server on the trained elasticity_tf checkpoint, all under the mesh
PARTS = """
    import copy, dataclasses, io, threading, urllib.request
    from position_induced_transformer_torch.parallel import parse_mesh_spec, shard_state
    from position_induced_transformer_torch.parallel.tensor_parallel import gather_state
    from position_induced_transformer_torch.train import benchmarks, evaluate, loop
    from position_induced_transformer_torch.train.serve import make_server
    mesh = parse_mesh_spec("model=2")
    cfg = configs.apply_overrides(configs.get("elasticity_tf"), {overrides!r})
    problem = benchmarks.setup(cfg, ntrain=16, ntest=8, device="cpu", **{cloud!r})
    whole = runner.init_state(problem, 0)
    part = shard_state(mesh, whole)
    task = dataclasses.replace(problem.task, model=part.model)
    data = {{k: torch.from_numpy(v) for k, v in problem.train_data.items()}}
    loop.make_train_epoch(task, lambda step: cfg.lr, mesh=mesh)(
        part, problem.geom, data, torch.arange(8).reshape(1, 8))
    moments = lambda st: {{n: {{k: v for k, v in st.optimizer.state[p].items() if k != "step"}}
                          for n, p in st.model.named_parameters()}}
    step = {{n: st["step"] for n, st in zip(dict(part.model.named_parameters()),
                                           part.optimizer.state.values())}}
    gathered = gather_state(mesh, part, copy.deepcopy(whole.model))
    parts = {{"weights": part.model.state_dict(), "moments": moments(part), "step": step,
              "whole": gathered.model.state_dict(), "whole_moments": moments(gathered)}}
    ck = os.path.join(tmp, "elasticity_tf.pt")
    x = np.load({x_path!r})
    np.save(os.path.join(tmp, f"in_rank{{rank}}.npy"), x)
    parts["evaluate"] = evaluate.evaluate(cfg, ck, ntest=9, device="cpu", mesh=mesh,
                                          setup_kwargs={cloud!r})
    parts["predict"] = evaluate.Predictor(cfg, ck, device="cpu", mesh=mesh,
                                          setup_kwargs={cloud!r}).predict_array({{"x": x}})
    evaluate.infer(cfg, ck, os.path.join(tmp, f"in_rank{{rank}}.npy"),
                   output_path=os.path.join(tmp, f"infer_rank{{rank}}.npy"), device="cpu",
                   mesh=mesh, setup_kwargs={cloud!r})
    srv = make_server(cfg, ck, port=0, verbose=False, device="cpu", mesh=mesh,
                      setup_kwargs={cloud!r})
    if rank == 0:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        buf = io.BytesIO()
        np.save(buf, x[:3])
        req = urllib.request.Request("http://127.0.0.1:%d/predict" % srv.server_address[1],
                                     data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            parts["served"] = np.load(io.BytesIO(r.read()))
        srv.shutdown()
        srv.server_close()
    else:
        srv.serve_forever()  # until rank 0 closes
    torch.save(parts, os.path.join(tmp, f"parts{{rank}}.pt"))
"""


@pytest.fixture(scope="module")
def model2(tmp_path_factory):
    """Every run of MODEL2 at model=2 in one pair of ranks, then PARTS."""
    tmp = tmp_path_factory.mktemp("tf_model2")
    x = np.asarray(t_bench.setup(_cfg("elasticity_tf", ELASTICITY_TF), ntrain=8, ntest=5,
                                 device="cpu", **CLOUD).test_data["x"])
    np.save(tmp / "x.npy", x)
    extra = PARTS.format(overrides=ELASTICITY_TF, cloud=CLOUD, x_path=str(tmp / "x.npy"))
    runs, out = _train_ranks(tmp, MODEL2, 2, extra)
    return runs, out, x


# after training: darcy_tf's ZSSR evaluation at data=2,model=2 (the decode
# split by query rows over the data ranks, each model rank the same slab)
ZSSR_EXTRA = """
    cfg = configs.apply_overrides(configs.get("darcy_tf"), {overrides!r})
    from position_induced_transformer_torch.train import evaluate
    torch.save(evaluate.evaluate(cfg, os.path.join(tmp, "darcy_tf.pt"), device="cpu",
                                 mesh="data=2,model=2", **{zssr!r}),
               os.path.join(tmp, f"zssr{{rank}}.pt"))
"""


@pytest.fixture(scope="module")
def mesh4(tmp_path_factory):
    """Every run of MESH4 in one world of four ranks, then ZSSR_EXTRA."""
    extra = ZSSR_EXTRA.format(overrides=DARCY_TF, zssr=ZSSR)
    return _train_ranks(tmp_path_factory.mktemp("tf_mesh4"), MESH4, 4, extra)


def _single(name, overrides, kw):
    return t_runner.train(_cfg(name, overrides), verbose=False, device="cpu", **kw)


def _replicated(name, overrides):
    """The names of the parameters that the model axis keeps whole."""
    model = t_bench._make_model(_cfg(name, overrides))
    return [n for n, d in param_shardings(DataMesh(dcn=1, data=1, model=2), model).items()
            if d is None]


# ------------------------------------------------------------ the layout

# label -> (name, overrides); the variants on burgers_tf's PiTTF
LAYOUTS = {
    "burgers_tf": ("burgers_tf", BURGERS_TF),  # with the decoder's up2 / mlp / w
    "darcy_tf": ("darcy_tf", DARCY_TF),  # without it
    "elasticity_tf": ("elasticity_tf", ELASTICITY_TF),
    "lite": ("burgers_tf", BURGERS_TF + ["model_variant=lite"]),
    "transformer": ("burgers_tf", BURGERS_TF + ["model_variant=transformer"]),
    "selfpit": ("burgers_tf", ["grid=64", "latent_grid=64"] + NARROW + ["model_variant=selfpit"]),
}


def _jax_problem(name, overrides, ntrain=16, ntest=8):
    jcfg = j_configs.apply_overrides(j_configs.get(name), overrides)
    kw = dict(CLOUD) if name == "elasticity_tf" else {}
    if name == "darcy_tf":
        kw["downsampling"] = 40
    return jcfg, j_bench.setup(jcfg, ntrain=ntrain, ntest=ntest, **kw)


@pytest.mark.parametrize("label", list(LAYOUTS))
def test_param_shardings_match_jax_rule(label, fake_world):
    """``param_shardings(make_mesh(n_data=2, n_model=2), model)`` equals the
    JAX package's ``_param_pspec`` on the same model's params, leaf by
    leaf, through ``flax_tf_params_to_state_dict``'s names and the (out, in)
    transpose of every ``kernel``: each TF MLP's ``mlp1`` by its output
    features, ``mlp2``'s weight by its input features and its bias whole;
    everything else (bandwidths, value / query / key projections, plain
    Dense) whole. PiTTFPointCloud's encoder MLP is named ``mlp1``, and JAX's
    rule tests ``mlp1`` first, so its ``mlp1.mlp2.weight`` and
    ``mlp1.mlp2.bias`` split by output features too."""
    name, overrides = LAYOUTS[label]
    jcfg, jproblem = _jax_problem(name, overrides, ntrain=4, ntest=2)
    params = j_runner.init_state(jproblem, j_make_optimizer(jcfg.lr, 4, flavor="keras")).params
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [p.key for p in path]
        spec = tuple(_param_pspec(path, leaf, 2))
        axis = spec.index("model") if "model" in spec else None
        if keys[-1] == "kernel":  # (in, out) -> the port's (out, in)
            keys[-1] = "weight"
            axis = None if axis is None else 1 - axis
        want[".".join(keys)] = axis
    fake_world(4)
    model = t_bench._make_model(_cfg(name, overrides))
    got = param_shardings(make_mesh(n_data=2, n_model=2), model)
    assert got == want
    assert set(got) == set(flax_tf_params_to_state_dict(params))
    if name == "elasticity_tf":
        assert got["mlp1.mlp2.weight"] == got["mlp1.mlp2.bias"] == 0  # JAX's quirk, kept
        assert got["mlp2.mlp2.weight"] == 1 and got["mlp2.mlp2.bias"] is None
    split = {n for n, d in got.items() if d is not None}
    assert split and all(".mlp1." in "." + n or ".mlp2." in "." + n for n in split)
    assert not any(n.endswith("band_width") for n in split)


# ------------------------------------------------------------ training


@pytest.mark.parametrize("label", list(MODEL2))
def test_runner_train_model2_matches_single_process(model2, label):
    """Each TF configuration at model=2 (burgers_tf's PiTTF on kernel #13,
    elasticity_tf's PiTTFPointCloud on #11/#12 with its gathered encoder
    MLP, and the variants on #14; selfpit with its NonNeg projection of
    every replicated ``band_width``): every rank returns the whole weights
    and history of the one-process run, within JAX's bounds, and the same
    as every other rank to the bit."""
    name, overrides, kw, _ = MODEL2[label]
    _assert_same_training(model2[0][label], *_single(name, overrides, kw)[1:])


@pytest.mark.parametrize("label", ["data=2,model=2", "dcn=2,data=1,model=2", "darcy_tf"])
def test_runner_train_data_model_mesh_matches_single_process(mesh4, label):
    """burgers_tf at data=2,model=2 and dcn=2,data=1,model=2, and darcy_tf
    (a PiTTF without the decoder's self-attention) at data=2,model=2, in
    four ranks: the batch over the data (x dcn) ranks, the MLPs over the
    model ranks; the padded eval tail (ntest 9) shared out."""
    name, overrides, kw, _ = MESH4[label]
    _assert_same_training(mesh4[0][label], *_single(name, overrides, kw)[1:])


def test_bf16_composes_with_the_tf_model_axis(mesh4):
    """bf16 activations at data=2,model=2 against the single-process bf16
    run at the JAX test's bf16 bounds."""
    name, overrides, kw, _ = MESH4["bf16"]
    _assert_same_training(mesh4[0]["bf16"], *_single(name, overrides, kw)[1:],
                          w_tol=(2e-2, 2e-3), loss_rtol=1e-2)


@pytest.mark.parametrize("label", list(MODEL2) + list(MESH4))
def test_replicated_parameters_equal_to_the_bit_on_every_rank(model2, mesh4, label):
    """Every parameter the model axis keeps whole (each ``band_width``,
    value ``weight``, ``query`` / ``key`` / ``value``, ``en_layer``,
    ``W_<i>``, ``w``, ``w1``, ``w2``, each row-parallel ``mlp2`` bias) is
    the same to the bit on every rank after training: each takes its whole
    gradient on every model rank, so the ranks cannot drift apart."""
    name, overrides, _, _ = {**MODEL2, **MESH4}[label]
    ranks = model2[0][label] if label in MODEL2 else mesh4[0][label]
    names = _replicated(name, overrides)
    assert any(n.endswith("band_width") or n.endswith("query") for n in names)
    assert any(n.startswith("en_layer.") for n in names)
    assert any(n.endswith("mlp2.bias") for n in names)
    for got in ranks[1:]:
        for n in names:
            assert torch.equal(got["weights"][n], ranks[0]["weights"][n]), n


def test_each_rank_holds_its_slice_of_the_split_leaves(model2):
    """After one elasticity_tf step at model=2 each rank holds exactly its
    half of every split leaf and of its KerasAdam moments (its rank's
    chunk of the gathered whole, to the bit), the replicated leaves and
    their moments whole, and KerasAdam's integer step."""
    whole = t_bench._make_model(_cfg("elasticity_tf", ELASTICITY_TF))
    dims = param_shardings(DataMesh(dcn=1, data=1, model=2), whole)
    shapes = {n: tuple(p.shape) for n, p in whole.named_parameters()}
    for r in range(2):
        parts = torch.load(os.path.join(model2[1], f"parts{r}.pt"), weights_only=False)
        assert set(parts["step"].values()) == {1}
        for n, d in dims.items():
            want = shapes[n] if d is None else tuple(
                s // 2 if i == d else s for i, s in enumerate(shapes[n]))
            assert tuple(parts["weights"][n].shape) == want, n
            cut = (lambda t: t) if d is None else (lambda t: t.chunk(2, d)[r])
            assert torch.equal(parts["weights"][n], cut(parts["whole"][n])), n
            for k in ("exp_avg", "exp_avg_sq"):
                assert tuple(parts["moments"][n][k].shape) == want, (n, k)
                assert torch.equal(parts["moments"][n][k], cut(parts["whole_moments"][n][k]))


def test_evaluate_predict_infer_and_serve_under_model2(model2):
    """``evaluate``, ``Predictor.predict_array``, ``infer`` and
    ``make_server`` at model=2 on the trained elasticity_tf checkpoint (the
    whole weights on both ranks, as the JAX package replicates them) against
    one process: metrics rtol 1e-5, predictions rtol 1e-5 / atol 1e-6; the
    served reply ``infer(mesh)``'s to the bit; only rank 0 writes."""
    _, tmp, x = model2
    ck = os.path.join(tmp, "elasticity_tf.pt")
    cfg = _cfg("elasticity_tf", ELASTICITY_TF)
    want = t_eval.evaluate(cfg, ck, ntest=9, device="cpu", setup_kwargs=CLOUD)
    pred = t_eval.Predictor(cfg, ck, device="cpu", setup_kwargs=CLOUD).predict_array({"x": x})
    srv = make_server(cfg, ck, port=0, verbose=False, device="cpu", setup_kwargs=CLOUD)
    try:
        served = srv.predictor.predict_array({"x": x[:3]})
    finally:
        srv.server_close()
    assert not os.path.exists(os.path.join(tmp, "infer_rank1.npy"))
    inferred = np.load(os.path.join(tmp, "infer_rank0.npy"))
    np.testing.assert_allclose(inferred, pred, rtol=1e-5, atol=1e-6)
    for r in range(2):
        got = torch.load(os.path.join(tmp, f"parts{r}.pt"), weights_only=False)
        for k in ("rel_l1", "rel_l2", "rel_max"):
            np.testing.assert_allclose(got["evaluate"][k], want[k], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(got["predict"], pred, rtol=1e-5, atol=1e-6)
    reply = torch.load(os.path.join(tmp, "parts0.pt"), weights_only=False)["served"]
    np.testing.assert_array_equal(reply, inferred[:3])
    np.testing.assert_allclose(reply, served, rtol=1e-5, atol=1e-6)


def test_darcy_tf_zssr_under_data_model_mesh_matches_single_process(mesh4):
    """darcy_tf trained at data=2,model=2, then ``evaluate(zssr=True)`` at
    21^2 under the same mesh: the decode sequence parallel over the data
    ranks (each model rank the same slab, the whole weights) against one
    process's evaluation of the same checkpoint, rtol 1e-5, on all four
    ranks."""
    runs, tmp = mesh4
    want = t_eval.evaluate(_cfg("darcy_tf", DARCY_TF), os.path.join(tmp, "darcy_tf.pt"),
                           device="cpu", **ZSSR)
    for r in range(4):
        got = torch.load(os.path.join(tmp, f"zssr{r}.pt"), weights_only=False)
        assert got["zssr"] and got["n_test"] == want["n_test"]
        for k in ("rel_l1", "rel_l2", "rel_max", "rel_l1_quartiles"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


# ------------------------------------------------------------ refusals


@pytest.fixture
def fake_world():
    def make(world, rank=0):
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)

    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("name,leaf", [("burgers_tf", "MLP_0.mlp1.weight"),
                                       ("elasticity_tf", "mlp1.mlp1.weight")])
def test_tf_model_axis_rejects_indivisible_width(fake_world, name, leaf):
    """hid 16 at model=3 raises the JAX package's ValueError, naming the
    leaf, from JAX's ``shard_state`` and from the port's ``shard_state``,
    ``param_shardings`` and ``runner.train``; nothing falls back to a
    replicated MLP."""
    overrides = BURGERS_TF if name == "burgers_tf" else ELASTICITY_TF
    jcfg, jproblem = _jax_problem(name, overrides, ntrain=4, ntest=2)
    jstate = j_runner.init_state(jproblem, j_make_optimizer(jcfg.lr, 4, flavor="keras"))
    with pytest.raises(ValueError, match="not divisible by the 'model'"):
        j_shard_state(j_make_mesh(n_data=2, n_model=3), jstate)
    fake_world(6)
    mesh = make_mesh(n_data=2, n_model=3)
    cfg = _cfg(name, overrides)
    kw = CLOUD if name == "elasticity_tf" else {}
    problem = t_bench.setup(cfg, ntrain=16, ntest=8, device="cpu", **kw)
    with pytest.raises(ValueError, match=r"not divisible by the 'model' axis size 3"):
        shard_state(mesh, t_runner.init_state(problem, 0))
    with pytest.raises(ValueError, match=f"{leaf} is not divisible by the 'model'"):
        param_shardings(mesh, problem.model)
    with pytest.raises(ValueError, match="not divisible by the 'model'"):
        t_runner.train(cfg, verbose=False, device="cpu", ntrain=16, ntest=8,
                       mesh="data=2,model=3", setup_kwargs=kw)


# ------------------------------------------------------------ against JAX

STEP = {"burgers_tf": BURGERS_TF, "elasticity_tf": ELASTICITY_TF}


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    """One step at data=2,model=2 of each STEP model in JAX (its
    ``make_train_epoch`` on a ``shard_state``-placed state over four fake
    devices) and in four port ranks (``shard_state``, the port's
    ``make_train_epoch``), both from the JAX weights on the JAX batch of
    8: name -> (JAX loss, JAX weights, every rank's loss and weights)."""
    tmp = tmp_path_factory.mktemp("tf_jax_step")
    want, inputs = {}, {}
    for name, overrides in STEP.items():
        jcfg, problem = _jax_problem(name, overrides)
        optimizer = j_make_optimizer(jcfg.lr, 16, flavor="keras")
        state = j_runner.init_state(problem, optimizer, seed=0)
        weights = {k: v.numpy() for k, v in flax_tf_params_to_state_dict(state.params).items()}
        batch = {k: np.asarray(v[:8]) for k, v in problem.train_data.items()}
        np.savez(tmp / f"{name}.npz", **{f"w.{k}": v for k, v in weights.items()},
                 **{f"d.{k}": v for k, v in batch.items()})
        mesh = j_make_mesh(n_data=2, n_model=2)
        epoch = j_make_train_epoch(problem.task, optimizer, mesh=mesh)
        jstate, jloss = epoch(j_shard_state(mesh, state), j_replicate(mesh, problem.geom),
                              j_replicate(mesh, problem.train_data), jnp.arange(8).reshape(1, 8))
        want[name] = (float(jloss), {k: np.asarray(v) for k, v in
                                     flax_tf_params_to_state_dict(jstate.params).items()})
        inputs[name] = str(tmp / f"{name}.npz")
    out = run_ranks(tmp, f"""
        import dataclasses
        from position_induced_transformer_torch import configs
        from position_induced_transformer_torch.parallel import parse_mesh_spec, shard_state
        from position_induced_transformer_torch.parallel.tensor_parallel import gather_state_dict
        from position_induced_transformer_torch.train import benchmarks, loop, runner
        mesh = parse_mesh_spec("data=2,model=2")
        out = {{}}
        for name, overrides in {STEP!r}.items():
            cfg = configs.apply_overrides(configs.get(name), overrides)
            kw = {CLOUD!r} if name == "elasticity_tf" else {{}}
            problem = benchmarks.setup(cfg, ntrain=16, ntest=8, device="cpu", **kw)
            state = runner.init_state(problem, 0)
            inp = np.load({inputs!r}[name])
            state.model.load_state_dict({{k[2:]: torch.from_numpy(inp[k]) for k in inp.files
                                          if k.startswith("w.")}})
            state = shard_state(mesh, state)
            task = dataclasses.replace(problem.task, model=state.model)
            data = {{k: torch.from_numpy(v[:8]) for k, v in problem.train_data.items()}}
            for k in ("x", "y"):  # JAX's batch (its setup's samples, equal to the bit)
                assert np.array_equal(data[k].numpy(), inp["d." + k]), k
                data[k] = torch.from_numpy(inp["d." + k])
            state, losses = loop.make_train_epoch(task, lambda step: cfg.lr, mesh=mesh)(
                state, problem.geom, data, torch.arange(8).reshape(1, 8))
            out[name] = {{"loss": losses[0], "weights": gather_state_dict(mesh, state.model)}}
        torch.save(out, os.path.join(tmp, f"rank{{rank}}.pt"))
    """, world=4)
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(4)]
    return {name: (*want[name], [r[name] for r in ranks]) for name in STEP}


@pytest.mark.parametrize("name", list(STEP))
def test_tf_tensor_parallel_step_matches_jax(jax_steps, name):
    """One step at data=2,model=2 of the port's ``make_train_epoch`` on a
    ``shard_state`` part against the JAX package's ``make_train_epoch`` on
    a ``shard_state``-placed state over four of its fake devices, both from
    the JAX weights (carried over by ``flax_tf_params_to_state_dict``) on
    one batch of 8 with the keras Adam: the loss rtol 1e-4, the gathered
    weights rtol 2e-4 / atol 2e-5. burgers_tf is a PiTTF on its fixed
    mesh; elasticity_tf a PiTTFPointCloud, whose encoder MLP ``mlp1`` both
    sides split by its output features in both layers."""
    jloss, want, ranks = jax_steps[name]
    for got in ranks:
        np.testing.assert_allclose(float(got["loss"]), jloss, rtol=1e-4)
        assert set(got["weights"]) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got["weights"][k].numpy(), v, rtol=2e-4, atol=2e-5,
                                       err_msg=k)
