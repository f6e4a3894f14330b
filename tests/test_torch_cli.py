"""The port's command line (``python -m position_induced_transformer_torch``)
in process through ``main(argv)``, against the JAX package's CLI on the
CPU: ``benchmarks`` and ``describe`` print what the JAX CLI prints;
``train`` is reproducible with ``--seed`` and equals ``runner.train``;
``--set``; ``infer`` end to end against the JAX ``infer`` of the same
weights; ``convert`` between a reference ``model.pth`` (written from JAX
params by the JAX package's exporter) and the port's checkpoints, the
port's forward from the imported checkpoint equal to JAX's; the catalog's
data paths equal to the JAX CLI's; the options that are not ported; and
``--problem-module`` with a problem defined here on the port's API (file
and dotted forms, duplicates, the atomic registration, a failed module not
cached, a registered benchmark trained and served); the five fixed-mesh
TF benchmarks through ``describe``, ``train``, ``evaluate``, ``infer`` and
``serve`` (a subprocess answering one request) at CPU sizes.
"""

import argparse
import dataclasses
import hashlib
import io
import json
import os
import re
import subprocess
import sys
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import position_induced_transformer_torch as t_pkg
from position_induced_transformer_torch import configs as t_configs
from position_induced_transformer_torch import cli as t_cli
from position_induced_transformer_torch.data import catalog as t_catalog
from position_induced_transformer_torch.train import benchmarks as t_bench
from position_induced_transformer_torch.train import checkpoint as t_ckpt
from position_induced_transformer_torch.train import evaluate as t_eval
from position_induced_transformer_torch.train import runner as t_runner
from position_induced_transformer_torch.train.serve import make_server
from position_induced_transformer_torch.utils import torch_compat as t_tc
from position_induced_transformer_tpu import cli as j_cli
from position_induced_transformer_tpu import configs as j_configs
from position_induced_transformer_tpu.data import catalog as j_catalog
from position_induced_transformer_tpu.train import benchmarks as j_bench
from position_induced_transformer_tpu.train import checkpoint as j_ckpt
from position_induced_transformer_tpu.train import evaluate as j_eval
from position_induced_transformer_tpu.utils import torch_compat as j_tc

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
CPU = ["--device", "cpu"]
# Burgers at a CPU size: 64 -> 16 points, hid 8, 1 block, batch 4
SHRINK = ["--set", "grid=64", "--set", "latent_grid=16", "--set", "model.hid_dim=8",
          "--set", "model.n_blocks=1", "--set", "batch_size=4"]
SHRUNK = ["grid=64", "latent_grid=16", "model.hid_dim=8", "model.n_blocks=1", "batch_size=4"]


def _out(capsys, fn, argv):
    assert fn(argv) == 0
    return capsys.readouterr().out


def test_benchmarks_prints_what_the_jax_cli_prints(capsys):
    got = _out(capsys, t_cli.main, ["benchmarks"])
    assert got == _out(capsys, j_cli.main, ["benchmarks"])
    assert len(got.splitlines()) == 13


@pytest.mark.parametrize("name", ["burgers", "sod", "darcy", "vorticity", "elasticity", "naca",
                                  "cylinder", "elasticity_tf"])
def test_describe_prints_what_the_jax_cli_prints(capsys, name):
    argv = ["describe", "--benchmark", name, "--ntrain", "2", "--ntest", "1"]
    got = json.loads(_out(capsys, t_cli.main, argv + CPU))
    assert got == json.loads(_out(capsys, j_cli.main, argv + ["--platform", "cpu"]))
    assert got["benchmark"] == name and got["params"] > 0


def test_train_is_reproducible_with_seed_and_equals_runner_train(capsys, tmp_path):
    argv = ["train", "--benchmark", "burgers", "--epochs", "2", "--ntrain", "8", "--ntest", "4",
            "--seed", "7", *SHRINK, *CPU]
    finals = [json.loads(_out(capsys, t_cli.main, argv).splitlines()[-1])["final"]
              for _ in range(2)]
    cfg = t_configs.apply_overrides(t_configs.BURGERS, SHRUNK)
    _, _, history = t_runner.train(cfg, epochs=2, ntrain=8, ntest=4, seed=7, verbose=False,
                                   device="cpu")
    drop = lambda row: {k: v for k, v in row.items() if k != "seconds"}
    assert drop(finals[0]) == drop(finals[1]) == drop(history[-1])
    with pytest.raises(ValueError, match="unknown benchmark"):
        t_cli.main(["train", "--benchmark", "nope", "--epochs", "1", *CPU])
    with pytest.raises(ValueError, match="zero whole training batches"):
        t_cli.main(["train", "--benchmark", "burgers", "--epochs", "1", "--ntrain", "4",
                    "--ntest", "8", *CPU])


def test_set_overrides_reach_the_model_and_describe(capsys, tmp_path):
    ckpt = str(tmp_path / "b.pt")
    out = _out(capsys, t_cli.main, ["train", "--benchmark", "burgers", "--epochs", "1",
                                    "--ntrain", "8", "--ntest", "4", "--checkpoint", ckpt,
                                    *SHRINK, *CPU])
    assert json.loads(out.splitlines()[-1])["final"]["epoch"] == 0
    state = t_ckpt.restore(ckpt)["state_dict"]
    assert tuple(state["en_layer.mlp2.weight"].shape) == (8, 8)
    argv = ["describe", "--benchmark", "burgers", *SHRINK]
    got = json.loads(_out(capsys, t_cli.main, argv + CPU))
    assert got == json.loads(_out(capsys, j_cli.main, argv + ["--platform", "cpu"]))
    assert got["params"] == sum(v.numel() for v in state.values())
    with pytest.raises(ValueError, match="unknown config field"):
        t_cli.main(["describe", "--benchmark", "burgers", "--set", "hid_dim=8", *CPU])


def _jax_checkpoint(state, path):
    sd = {k: v.numpy() for k, v in state.items()}
    return j_ckpt.save(path, {"params": j_tc.torch_state_dict_to_flax(sd)})


def test_infer_end_to_end_matches_jax(capsys, tmp_path):
    """train --checkpoint, then ``infer --input x.npy --output pred.npy``
    (and ``.mat``): every sample predicted, equal to the JAX ``infer`` of
    the same weights."""
    ckpt = str(tmp_path / "b.pt")
    _out(capsys, t_cli.main, ["train", "--benchmark", "burgers", "--epochs", "1", "--ntrain", "8",
                              "--ntest", "4", "--checkpoint", ckpt, *SHRINK, *CPU])
    x = np.random.default_rng(0).random((5, 64, 1)).astype(np.float32)
    inp, out, mat = (str(tmp_path / f) for f in ("x.npy", "pred.npy", "pred.mat"))
    np.save(inp, x)
    argv = ["infer", "--benchmark", "burgers", "--checkpoint", ckpt, "--input", inp, *SHRINK, *CPU]
    res = json.loads(_out(capsys, t_cli.main, argv + ["--output", out]).splitlines()[-1])
    assert res == {"benchmark": "burgers", "n": 5, "pred_shape": [5, 64, 1], "rollout_steps": 0,
                   "output": out}
    _out(capsys, t_cli.main, argv + ["--output", mat])
    from scipy.io import loadmat

    np.testing.assert_array_equal(loadmat(mat)["pred"], np.load(out))
    jpath = _jax_checkpoint(t_ckpt.restore(ckpt)["state_dict"], str(tmp_path / "jax_ckpt"))
    jcfg = j_configs.apply_overrides(j_configs.BURGERS, SHRUNK)
    j_eval.infer(jcfg, jpath, inp, output_path=str(tmp_path / "jax.npy"))
    np.testing.assert_allclose(np.load(out), np.load(tmp_path / "jax.npy"), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def reference_pth(tmp_path_factory):
    """A reference-layout ``model.pth`` of full-width Burgers written from
    JAX-initialised params by the JAX package's exporter, and the params."""
    problem = j_bench.setup(j_configs.BURGERS, None, ntrain=8, ntest=4)
    params = problem.model.init(jax.random.PRNGKey(3), problem.geom,
                                jnp.asarray(problem.train_data["x"][:1]))["params"]
    path = str(tmp_path_factory.mktemp("pth") / "model.pth")
    j_tc.save_torch_checkpoint(path, j_tc.flax_params_to_torch_state_dict(params))
    return path, params


def test_convert_round_trip_and_the_imported_forward_equals_jax(capsys, tmp_path, reference_pth):
    pth, params = reference_pth
    ours, back = str(tmp_path / "ours.pt"), str(tmp_path / "back.pth")
    res = json.loads(_out(capsys, t_cli.main, ["convert", "--benchmark", "burgers",
                                               "--from-torch", pth, "--to", ours, *CPU]))
    assert res == {"imported": pth, "checkpoint": ours}
    assert t_ckpt.restore(ours)["config"] == "burgers"
    res = json.loads(_out(capsys, t_cli.main, ["convert", "--benchmark", "burgers",
                                               "--from", ours, "--to-torch", back, *CPU]))
    assert res == {"exported": back, "n_tensors": len(j_tc.load_torch_checkpoint(pth))}
    orig = torch.load(pth, weights_only=True)["model_state"]
    rt = torch.load(back, weights_only=True)["model_state"]
    assert set(rt) == set(orig)
    for k in orig:
        assert torch.equal(rt[k], orig[k]), k
    x = np.random.default_rng(1).random((3, 1024, 1)).astype(np.float32)
    got = t_eval.Predictor("burgers", ours, device="cpu").predict_array({"x": x})
    jpath = j_ckpt.save(str(tmp_path / "jax_ckpt"), {"params": params})
    want = j_eval.Predictor("burgers", jpath).predict_array({"x": jnp.asarray(x)})
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    # torch.compile's prefix is dropped; an affine norm's parameters refused
    state = torch.load(pth, weights_only=True)["model_state"]
    t_tc.save_torch_checkpoint(str(tmp_path / "c.pth"), {f"_orig_mod.{k}": v for k, v in state.items()})
    assert set(t_tc.load_torch_checkpoint(str(tmp_path / "c.pth"))) == set(state)
    torch.save({"norm.weight": torch.ones(3)}, str(tmp_path / "n.pth"))
    with pytest.raises(KeyError, match="InstanceNorm1d"):
        t_tc.load_torch_checkpoint(str(tmp_path / "n.pth"))
    with pytest.raises(ValueError, match="needs --benchmark"):
        t_cli.main(["convert", "--from-torch", pth, "--to", ours, *CPU])
    with pytest.raises(ValueError, match="--from-torch \\+ --to"):
        t_cli.main(["convert", "--benchmark", "burgers", *CPU])


def test_convert_structure_mismatch_is_clean_error(tmp_path):
    pth = str(tmp_path / "model.pth")
    torch.save({"model_state": {"down.lmda": torch.zeros(1, 1, 2)}}, pth)
    with pytest.raises(ValueError, match="do not match benchmark 'burgers'"):
        t_cli.main(["convert", "--benchmark", "burgers", "--from-torch", pth,
                    "--to", str(tmp_path / "out.pt"), *CPU])
    assert not os.path.exists(tmp_path / "out.pt")


@pytest.mark.parametrize("option,value", [("--mesh", "model=2"), ("--model-variant", "lite"),
                                          ("--mesh", "stage=2")])
def test_options_not_ported_raise(option, value):
    """--mesh's model (head) and pipeline (stage) axes are ported (with
    --multihost: tests/test_torch_multihost.py, tests/test_torch_pipeline.py,
    tests/test_torch_parallel_tf.py): in a world of one they raise the JAX
    package's ValueError about devices; in a world of two (the fake
    backend) ``train --benchmark burgers_tf --mesh model=2`` gets past the
    mesh checks and trains (the fake collectives move nothing), and in a
    world of three ``model=3`` on hid 8 raises JAX's ValueError naming the
    leaf;
    --model-variant is ported and reaches the model, which on a benchmark
    of the torch family raises with the JAX package's words (the variants
    exist for the TF family only)."""
    for command in ("train", "evaluate", "describe"):
        argv = [command, "--benchmark", "burgers", option, value, *CPU]
        if command == "evaluate":
            argv += ["--checkpoint", "missing.pt"]
        if option == "--model-variant":
            if command == "evaluate":  # the checkpoint is read before the model is built
                continue
            with pytest.raises(ValueError, match="exists for the TF-family benchmarks only"):
                t_cli.main(argv + ["--ntrain", "4", "--ntest", "2", *SHRINK])
            continue
        with pytest.raises(ValueError, match="needs 2 devices but only 1"):
            t_cli.main(argv)
    if value == "model=2":
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore

        tf = ["train", "--benchmark", "burgers_tf", *CPU, "--ntrain", "5", "--ntest", "2",
              "--epochs", "1", "--set", "grid=64", "--set", "latent_grid=32",
              "--set", "model.hid_dim=8"]
        for world in (2, 3):
            dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
            try:
                if world == 2:
                    assert t_cli.main(tf + [option, value]) in (0, None)
                else:
                    with pytest.raises(ValueError, match="MLP_0.mlp1.weight is not divisible "
                                                         "by the 'model' axis size 3"):
                        t_cli.main(tf + [option, "model=3"])
            finally:
                dist.destroy_process_group()
    with pytest.raises(SystemExit):  # no --fused-mode: the port has no such switch
        t_cli.main(["train", "--benchmark", "burgers", "--fused-mode", "never", *CPU])


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_without_a_card_the_default_device_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_cli.main(["train", "--benchmark", "cylinder"])


def test_catalog_and_data_paths_equal_the_jax_clis(tmp_path, monkeypatch):
    """``dataset_for``, ``available`` and ``data_path_for`` of every name,
    and the CLI's data path: an explicit catalog root, an explicit file, a
    root missing a file, then ``PIT_REAL_DATA_DIR``."""
    root = tmp_path / "data"
    (root / "cylinder").mkdir(parents=True)
    (root / "data_burgers.mat").write_bytes(b"MATLAB 5.0 MAT-file" + bytes(200))
    for f in t_catalog.DATASETS["cylinder"].files[:-1]:
        (root / f).write_text("1,2\n" * 10)
    (root / "naca").mkdir()
    (root / "naca" / "shape_coords.npy").write_text("version https://git-lfs.github.com/spec/v1\n")
    names = sorted(t_configs.REGISTRY) + ["custom"]
    for n in names:
        assert (t_catalog.dataset_for(n) is None) == (j_catalog.dataset_for(n) is None)
        assert t_catalog.available(n, str(root)) == j_catalog.available(n, str(root))
        assert t_catalog.data_path_for(n, str(root)) == j_catalog.data_path_for(n, str(root))
    assert t_catalog.data_path_for("burgers_tf", str(root)) == str(root / "data_burgers.mat")
    (root / "cylinder" / "elements.csv").write_text("1,2,3\n" * 10)
    assert t_catalog.data_path_for("cylinder", str(root)) == str(root / "cylinder")
    cases = [("burgers", str(root)), ("cylinder", str(root)), ("naca", str(root)),
             ("burgers", str(root / "data_burgers.mat")), ("sod", str(root)),
             ("burgers", None), ("cylinder", None)]
    monkeypatch.delenv("PIT_REAL_DATA_DIR", raising=False)
    for env in (None, str(root)):
        if env:
            monkeypatch.setenv("PIT_REAL_DATA_DIR", env)
        assert t_catalog.real_data_root() == j_catalog.real_data_root() == env
        for bench, dp in cases:
            args = argparse.Namespace(benchmark=bench, data_path=dp)
            assert t_cli._resolve_data_path(args) == j_cli._resolve_data_path(args), (bench, dp, env)
    args = argparse.Namespace(benchmark="cylinder", data_path=None)
    assert t_cli._resolve_data_path(args) == str(root / "cylinder")


# ---- user-defined benchmarks through --problem-module, on the port's API

def _tiny_cfg(name: str):
    return t_configs.BenchmarkConfig(
        name=name, model=t_configs.ModelConfig(1, 1, 1, 8, 1, 1, 0.05, 0.05),
        metric="periodic1d", ntrain=8, ntest=4, batch_size=4, epochs=2,
        grid=(16,), latent_grid=(8,), periodic_grid=True,
    )


def _tiny_setup(cfg, data_path=None, ntrain=None, ntest=None, *, device="cuda"):
    """A shift operator on a periodic 1-D mesh, on the port's API."""
    from position_induced_transformer_torch.data import meshes
    from position_induced_transformer_torch.models import build_geometry
    from position_induced_transformer_torch.train.benchmarks import Problem, _make_model
    from position_induced_transformer_torch.train.loop import Task

    ntrain, ntest = ntrain or cfg.ntrain, ntest or cfg.ntest
    L = cfg.grid[0]
    x = np.random.default_rng(0).standard_normal((ntrain + ntest, L, 1)).astype(np.float32)
    y = np.roll(x, 3, axis=1)
    mesh, ltt = meshes.grid_1d(L), meshes.grid_1d(cfg.latent_grid[0])
    geom = build_geometry(mesh, ltt, mesh, metric=cfg.metric, en_loc=cfg.model.en_loc,
                          de_loc=cfg.model.de_loc, device=device)
    model = _make_model(cfg, torch.Generator().manual_seed(cfg.seed)).to(geom.mesh_in.device)
    task = Task(model=model, loss_p=cfg.loss_p, out_dim=1)
    return Problem(cfg, model, task, geom, {"x": x[:ntrain], "y": y[:ntrain]},
                   {"x": x[ntrain:], "y": y[ntrain:]}, ntrain, ntest)


PROBLEM_FILE = '''
import sys
sys.path.insert(0, {tests!r})
import test_torch_cli as t
import position_induced_transformer_torch as pit

pit.register_benchmark(t._tiny_cfg({name!r}), t._tiny_setup, overwrite=True)
'''


@pytest.fixture
def registry():
    """Names registered by a test, removed afterwards (the registries are
    module state shared across the suite)."""
    added = []
    yield added
    for name in added:
        t_configs.REGISTRY.pop(name, None)
        t_bench.SETUPS.pop(name, None)


def _problem_file(tmp_path, name, stem="torch_problem"):
    path = tmp_path / f"{stem}.py"
    path.write_text(PROBLEM_FILE.format(tests=os.path.dirname(os.path.abspath(__file__)), name=name))
    return str(path)


def test_problem_module_file_registers_a_benchmark_that_trains_and_serves(capsys, tmp_path,
                                                                           registry):
    registry.append("custom_shift")
    mod = _problem_file(tmp_path, "custom_shift")
    assert "custom_shift" in _out(capsys, t_cli.main, ["benchmarks", "--problem-module", mod])
    info = json.loads(_out(capsys, t_cli.main, ["describe", "--benchmark", "custom_shift",
                                                "--problem-module", mod, *CPU]))
    assert (info["benchmark"], info["model"], info["train_shape"]) == (
        "custom_shift", "PiT", {"x": [8, 16, 1], "y": [8, 16, 1]})
    ckpt = str(tmp_path / "c.pt")
    out = _out(capsys, t_cli.main, ["train", "--benchmark", "custom_shift", "--problem-module", mod,
                                    "--epochs", "2", "--checkpoint", ckpt, "--set",
                                    "model.hid_dim=8", *CPU])
    assert json.loads(out.splitlines()[-1])["final"]["epoch"] == 1
    problem = t_bench.setup(t_configs.get("custom_shift"), device="cpu")
    problem.model.load_state_dict(t_ckpt.restore(ckpt)["state_dict"])
    srv = make_server("custom_shift", ckpt, port=0, verbose=False, device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        x = np.asarray(problem.test_data["x"])
        buf = io.BytesIO()
        np.save(buf, x)
        req = urllib.request.Request(f"http://127.0.0.1:{srv.server_address[1]}/predict",
                                     data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            served = np.load(io.BytesIO(r.read()))
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    np.testing.assert_allclose(served, t_runner.predict(problem), rtol=1e-6, atol=1e-6)


def test_duplicate_registration_and_the_atomic_rollback(registry):
    cfg = _tiny_cfg("custom_dup")
    t_pkg.register_benchmark(cfg, _tiny_setup)
    registry.append(cfg.name)
    with pytest.raises(ValueError, match="already registered"):
        t_configs.register(cfg)
    with pytest.raises(ValueError, match="already registered"):
        t_bench.register_setup(cfg.name, _tiny_setup)
    t_pkg.register_benchmark(cfg, _tiny_setup, overwrite=True)
    # a failed setup registration leaves no config behind
    atomic = _tiny_cfg("custom_atomic")
    t_bench.register_setup(atomic.name, _tiny_setup)
    registry.append(atomic.name)
    with pytest.raises(ValueError, match="already registered"):
        t_pkg.register_benchmark(atomic, _tiny_setup)
    assert atomic.name not in t_configs.REGISTRY
    nosetup = _tiny_cfg("custom_nosetup")
    t_configs.register(nosetup)
    registry.append(nosetup.name)
    with pytest.raises(ValueError, match="no setup registered"):
        t_bench.setup(nosetup, device="cpu")
    with pytest.raises(TypeError, match="BenchmarkConfig"):
        t_configs.register({"name": "x"})


def test_problem_module_dotted_form_registers_again(capsys, tmp_path, registry):
    _problem_file(tmp_path, "custom_dotted", stem="my_torch_problems")
    registry.append("custom_dotted")
    sys.path.insert(0, str(tmp_path))
    try:
        argv = ["benchmarks", "--problem-module", "my_torch_problems"]
        assert "custom_dotted" in _out(capsys, t_cli.main, argv)
        t_configs.REGISTRY.pop("custom_dotted")
        t_bench.SETUPS.pop("custom_dotted")
        assert "custom_dotted" in _out(capsys, t_cli.main, argv)
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("my_torch_problems", None)


def test_problem_module_failure_is_not_cached_and_shadows_nothing(capsys, tmp_path):
    broken = tmp_path / "broken_problem.py"
    broken.write_text("raise RuntimeError('boom')\n")
    with pytest.raises(RuntimeError, match="boom"):
        t_cli.main(["benchmarks", "--problem-module", str(broken)])
    assert "_pit_torch_problem_broken_problem" not in sys.modules
    shadow = tmp_path / "json.py"
    shadow.write_text("REGISTERED = True\n")
    _out(capsys, t_cli.main, ["benchmarks", "--problem-module", str(shadow)])
    assert sys.modules["json"] is json and hasattr(json, "dumps")


# the fixed-mesh TF benchmarks at CPU sizes: overrides, a raw input batch's
# shape, and the evaluate / infer options
TF_FIXED_CLI = {
    "burgers_tf": (["grid=64", "latent_grid=32", "batch_size=5"], (3, 64, 1), [], []),
    "sod_tf": (["grid=64", "latent_grid=32"], (3, 64, 3), [], []),
    "darcy_tf": (["latent_grid=4,4"], (3, 22, 22, 1), ["--zssr", "--zssr-downsampling", "20"],
                 ["--zssr-downsampling", "20"]),
    "vorticity_tf": (["latent_grid=4,4", "rollout_steps=2"], (3, 4096, 10), [],
                     ["--rollout-steps", "3"]),
    "naca_tf": (["grid=23,11", "latent_grid=12,6"], (3, 23, 11, 2), [], []),
}


_SERVING = re.compile(r"serving benchmark '([^']*)' on http://([^:\s]+):(\d+) ")


def _start_server(cmd, timeout=300):
    """Start ``serve --port 0`` in a subprocess and wait until it prints the
    address it bound: (process, base URL, its output lines so far and to
    come, the thread that reads them). The port is the server's own from
    the moment it is reported, so no other process can answer on it."""
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            errors="replace", env=dict(os.environ, JAX_PLATFORMS="cpu"))
    lines, bound, found = [], threading.Event(), {}

    def read():
        for line in proc.stdout:
            lines.append(line)
            match = _SERVING.search(line)
            if match and not bound.is_set():
                found["url"] = f"http://{match.group(2)}:{match.group(3)}"
                bound.set()
        bound.set()  # the process ended

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    bound.wait(timeout)
    return proc, found.get("url"), lines, reader


@pytest.mark.parametrize("name", list(TF_FIXED_CLI))
def test_tf_fixed_benchmarks_run_through_every_command(capsys, tmp_path, name):
    """describe, train --checkpoint, evaluate (darcy_tf zero-shot at 22^2),
    infer (a raw .npy; darcy_tf at 22^2, vorticity_tf rolled out 3 steps)
    and serve (the command in a subprocess answering one POST as infer
    does; darcy_tf at its 43^2 training grid) on the CPU; ``--model-variant
    pit`` is accepted, and ``selfpit`` is refused with the JAX package's
    words where the latent grid is not the query grid."""
    overrides, shape, eval_opts, infer_opts = TF_FIXED_CLI[name]
    shrink = [a for o in overrides + ["model.hid_dim=8", "model.n_blocks=1"] for a in ("--set", o)]
    sizes = ["--ntrain", "10" if name == "burgers_tf" else "16", "--ntest", "4"]
    info = json.loads(_out(capsys, t_cli.main, ["describe", "--benchmark", name, *sizes, *shrink,
                                                *CPU]))
    assert info["benchmark"] == name and info["model"] == "PiTTF" and info["params"] > 0
    ckpt = str(tmp_path / f"{name}.pt")
    out = _out(capsys, t_cli.main, ["train", "--benchmark", name, "--epochs", "1", *sizes,
                                    "--checkpoint", ckpt, "--model-variant", "pit", *shrink, *CPU])
    final = json.loads(out.splitlines()[-1])["final"]
    assert final["epoch"] == 0 and np.isfinite(final["train_loss"])
    res = json.loads(_out(capsys, t_cli.main, ["evaluate", "--benchmark", name, "--checkpoint", ckpt,
                                               "--ntest", "4", *eval_opts, *shrink, *CPU,
                                               "--set", f"ntrain={sizes[1]}"]).splitlines()[-1])
    assert res["benchmark"] == name and res["zssr"] == ("--zssr" in eval_opts)
    assert all(np.isfinite(v).all() for k, v in res.items() if k.startswith("rel_"))
    x = np.random.default_rng(0).random(shape).astype(np.float32)
    inp, pred = str(tmp_path / "x.npy"), str(tmp_path / "pred.npy")
    np.save(inp, x)
    argv = ["infer", "--benchmark", name, "--checkpoint", ckpt, "--input", inp, "--output", pred,
            *infer_opts, *shrink, *CPU, "--set", f"ntrain={sizes[1]}"]
    res = json.loads(_out(capsys, t_cli.main, argv).splitlines()[-1])
    got = np.load(pred)
    assert res["n"] == 3 and got.shape[0] == 3 and np.isfinite(got).all()
    if name == "vorticity_tf":
        assert got.shape == (3, 4096, 1, 3)
    cmd = [sys.executable, "-m", "position_induced_transformer_torch", "serve", "--benchmark", name,
           "--checkpoint", ckpt, "--port", "0", *shrink, *CPU, "--set", f"ntrain={sizes[1]}"]
    proc, base, lines, reader = _start_server(cmd)
    served = info = None
    try:
        if base is not None:
            with urllib.request.urlopen(base + "/info", timeout=60) as r:
                info = json.loads(r.read())
            url = base + "/predict"
            if name == "vorticity_tf":
                url += "?rollout_steps=3"
            if name == "darcy_tf":  # the server answers at its own 43^2 grid
                x = np.random.default_rng(0).random((3, 43, 43, 1)).astype(np.float32)
            buf = io.BytesIO()
            np.save(buf, x)
            req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                served = np.load(io.BytesIO(r.read()))
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        reader.join(timeout=60)
        log = "".join(lines)
    assert served is not None, log[-2000:]
    # the reply came from this test's server, on this test's checkpoint
    with open(ckpt, "rb") as f:
        digest = hashlib.file_digest(f, "sha256").hexdigest()
    assert info["benchmark"] == name and info["checkpoint_sha256"] == digest, (info, log[-2000:])
    assert info["model_variant"] == "pit"
    if name != "darcy_tf":
        np.testing.assert_allclose(served, got, rtol=1e-6, atol=1e-6)
    # selfpit needs the latent grid to be the query grid: none of these is
    with pytest.raises(ValueError, match="latent == query"):
        t_cli.main(["train", "--benchmark", name, "--model-variant", "selfpit", *sizes, *shrink,
                    *CPU])


def test_model_variant_runs_through_train_infer_and_serve(capsys, tmp_path):
    """``--model-variant lite`` (burgers_tf at a CPU size) through train
    --checkpoint, infer of a raw .npy and serve (the command in a
    subprocess answering one POST as infer does); ``/info`` reports the
    variant, and the pit model refuses the lite checkpoint."""
    shrink = [a for o in ["grid=64", "latent_grid=32", "batch_size=5", "model.hid_dim=8",
                          "model.n_blocks=1"] for a in ("--set", o)]
    lite = ["--model-variant", "lite"]
    ckpt = str(tmp_path / "lite.pt")
    out = _out(capsys, t_cli.main, ["train", "--benchmark", "burgers_tf", "--epochs", "1",
                                    "--ntrain", "10", "--ntest", "4", "--checkpoint", ckpt, *lite,
                                    *shrink, *CPU])
    assert np.isfinite(json.loads(out.splitlines()[-1])["final"]["train_loss"])
    x = np.random.default_rng(0).random((3, 64, 1)).astype(np.float32)
    inp, pred = str(tmp_path / "x.npy"), str(tmp_path / "pred.npy")
    np.save(inp, x)
    common = ["--benchmark", "burgers_tf", "--checkpoint", ckpt, *shrink, *CPU, "--set", "ntrain=10"]
    res = json.loads(_out(capsys, t_cli.main, ["infer", *common, "--input", inp, "--output", pred,
                                               *lite]).splitlines()[-1])
    got = np.load(pred)
    assert res["n"] == 3 and got.shape == (3, 64, 1) and np.isfinite(got).all()
    with pytest.raises(RuntimeError, match="state_dict"):
        t_cli.main(["infer", *common, "--input", inp])
    cmd = [sys.executable, "-m", "position_induced_transformer_torch", "serve", *common, *lite,
           "--port", "0"]
    proc, base, lines, reader = _start_server(cmd)
    served = info = None
    try:
        if base is not None:
            with urllib.request.urlopen(base + "/info", timeout=60) as r:
                info = json.loads(r.read())
            buf = io.BytesIO()
            np.save(buf, x)
            req = urllib.request.Request(base + "/predict", data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                served = np.load(io.BytesIO(r.read()))
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        reader.join(timeout=60)
        log = "".join(lines)
    assert served is not None, log[-2000:]
    assert info["benchmark"] == "burgers_tf" and info["model_variant"] == "lite", info
    np.testing.assert_allclose(served, got, rtol=1e-6, atol=1e-6)
