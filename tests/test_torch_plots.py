"""The port's figures and run artifacts on the CPU: ``evaluate(plots_dir=)``
writes the figures of ``plots.save_benchmark_plots`` for every ported
benchmark (cylinder's ``tricontourf`` over its element triangles among
them) and a rollout's per-step error curve, as the JAX package writes
them; ``runner.train``'s ``history_csv`` / ``history_plot`` and
``profile_dir`` (a ``torch.profiler`` Chrome trace), and the command line's
``--plots``, ``--save-pred``, ``--profile`` and ``--debug-nans``.
matplotlib is optional: the figure tests skip without it, and without it
the options raise an ``ImportError`` that names it; importing the package
imports no matplotlib.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from position_induced_transformer_torch import cli as t_cli
from position_induced_transformer_torch import configs as t_configs
from position_induced_transformer_torch.train import benchmarks as t_bench
from position_induced_transformer_torch.train import checkpoint as t_ckpt
from position_induced_transformer_torch.train import evaluate as t_eval
from position_induced_transformer_torch.train import loop as t_loop
from position_induced_transformer_torch.train import plots as t_plots
from position_induced_transformer_torch.train import runner as t_runner
from position_induced_transformer_torch.utils import profiling

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_LINES = lambda n: {f"pred_var{i}.pdf" for i in range(1, n + 1)}
_FIELDS = lambda names, n: {f"{k}_var{i}.pdf" for k in names for i in range(1, n + 1)}
# (overrides, setup kwargs, figures save_benchmark_plots writes)
CASES = {
    "burgers": (dict(grid=(32,), latent_grid=(8,)), {}, _LINES(1)),
    "sod": ({}, {}, _LINES(3)),
    "darcy": (dict(latent_grid=(8, 8)), {"downsampling": 20}, {"prediction.pdf"}),
    "vorticity": (dict(latent_grid=(8, 8), rollout_steps=2, memory=3,
                       model=dict(in_dim=3)), {},
                  {f"{k}_{i}.pdf" for k in ("reference", "pred", "err") for i in (1, 2)}
                  | {"rollout_error.png"}),
    "elasticity": ({}, {"n_points": 32}, _FIELDS(("true", "pred", "error"), 1)),
    "naca": (dict(grid=(41, 21), latent_grid=(8, 4)), {}, _FIELDS(("true", "pred", "error"), 4)),
    "cylinder": ({}, {"n_points": 64, "n_latent": 16},
                 _FIELDS(("true", "pred", "err"), 3) | {"rollout_error.png"}),
    "elasticity_tf": (dict(model=dict(n_head=2, hid_dim=8)), {"n_points": 32},
                      _FIELDS(("true", "pred", "error"), 1)),
}


def _config(name):
    over, setup_kwargs, files = CASES[name]
    over = dict(over)
    cfg = t_configs.get(name)
    model = dataclasses.replace(cfg.model, **{"hid_dim": 8, "n_blocks": 1, **over.pop("model", {})})
    return dataclasses.replace(cfg, model=model, batch_size=4, ntrain=4, **over), setup_kwargs, files


@pytest.mark.parametrize("name", sorted(CASES))
def test_evaluate_writes_the_benchmark_figures(tmp_path, name):
    pytest.importorskip("matplotlib")
    cfg, setup_kwargs, files = _config(name)
    path = t_ckpt.save(str(tmp_path / "m.pt"), t_bench._make_model(cfg).state_dict(), name)
    plots = str(tmp_path / "plots")
    result = t_eval.evaluate(cfg, path, ntest=4, plots_dir=plots, setup_kwargs=setup_kwargs,
                             device="cpu")
    assert set(os.listdir(plots)) == files
    if name == "cylinder":  # tricontourf over the element triangles, and the rollout curve
        assert len(result["rollout_rel_l2_step"]) == 10
        problem = t_bench.setup(cfg, ntrain=4, ntest=4, device="cpu", **setup_kwargs)
        assert problem.extras["elements"].shape[-1] == 3


def test_step_error_plot_and_history_plot(tmp_path):
    pytest.importorskip("matplotlib")
    path = t_plots.save_step_error_plot([0.1, 0.2, 0.4], str(tmp_path / "p"))
    assert path == str(tmp_path / "p" / "rollout_error.png") and os.path.getsize(path) > 0
    cfg = t_configs.apply_overrides(t_configs.BURGERS, ["grid=32", "latent_grid=8",
                                                        "model.hid_dim=8", "model.n_blocks=1",
                                                        "batch_size=4"])
    csv, png = str(tmp_path / "h.csv"), str(tmp_path / "h.png")
    _, _, history = t_runner.train(cfg, epochs=2, ntrain=8, ntest=4, verbose=False,
                                   history_csv=csv, history_plot=png, device="cpu")
    assert os.path.getsize(png) > 0
    rows = open(csv).read().splitlines()
    assert rows[0] == ",".join(history[0]) and len(rows) == 3


def test_without_matplotlib_the_options_name_it(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import matplotlib raises
    cfg = t_configs.apply_overrides(t_configs.BURGERS, ["grid=32", "latent_grid=8",
                                                        "model.hid_dim=8", "model.n_blocks=1"])
    path = t_ckpt.save(str(tmp_path / "m.pt"), t_bench._make_model(cfg).state_dict(), "burgers")
    with pytest.raises(ImportError, match="matplotlib"):
        t_eval.evaluate(cfg, path, ntest=2, plots_dir=str(tmp_path / "p"), device="cpu")
    with pytest.raises(ImportError, match="matplotlib"):
        t_runner.train(cfg, epochs=1, ntrain=8, ntest=2, history_plot=str(tmp_path / "h.png"),
                       device="cpu")
    assert not os.path.exists(tmp_path / "p") and not os.path.exists(tmp_path / "h.png")


def test_the_package_imports_no_matplotlib():
    code = (
        "import importlib, pkgutil, sys\n"
        "import position_induced_transformer_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'matplotlib' not in sys.modules\n"
        "assert 'position_induced_transformer_torch.__main__' in sys.modules\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr


def test_profile_dir_writes_a_chrome_trace(tmp_path):
    cfg = t_configs.apply_overrides(t_configs.BURGERS, ["grid=32", "latent_grid=8",
                                                        "model.hid_dim=8", "model.n_blocks=1",
                                                        "batch_size=4"])
    for epochs in (1, 2):  # a one-epoch run traces its only epoch
        logdir = str(tmp_path / f"trace{epochs}")
        t_runner.train(cfg, epochs=epochs, ntrain=8, ntest=4, verbose=False, profile_dir=logdir,
                       device="cpu")
        trace = json.load(open(os.path.join(logdir, "trace.json")))
        names = {e.get("name", "") for e in trace["traceEvents"]}
        assert any("addmm" in n or "mm" == n.split("::")[-1] for n in names)


def _nan_task():
    from position_induced_transformer_torch.models import PiT, build_geometry
    from position_induced_transformer_torch.data import meshes

    mesh, ltt = meshes.grid_1d(16), meshes.grid_1d(8)
    geom = build_geometry(mesh, ltt, mesh, metric="periodic1d", en_loc=0.3, de_loc=0.3,
                          device="cpu")
    model = PiT(1, 1, 1, 8, 1, 1, 0.3, 0.3)
    return t_loop.Task(model=model, loss_p=2, out_dim=1), geom


def test_debug_nans_raises_on_a_non_finite_step():
    task, geom = _nan_task()
    x = torch.rand(4, 16, 1)
    y = torch.rand(4, 16, 1)
    y[2, 5] = float("nan")
    data, perm = {"x": x, "y": y}, torch.arange(4)[None]
    before = {k: v.clone() for k, v in task.model.state_dict().items()}

    def epoch():
        opt = t_loop.make_optimizer(task.model.parameters(), 1e-3)
        return t_loop.make_train_epoch(task, lambda s: 1e-3)(
            t_loop.TrainState(task.model, opt), geom, data, perm)

    profiling.debug_nans(True)
    try:
        with pytest.raises(FloatingPointError, match="non-finite training loss"):
            epoch()
    finally:
        profiling.debug_nans(False)
    for k, v in task.model.state_dict().items():  # raised before the update
        assert torch.equal(v, before[k]), k
    _, losses = epoch()  # off: the step runs on
    assert not torch.isfinite(losses).all()
    grads = {"w": torch.nn.Parameter(torch.zeros(2))}
    grads["w"].grad = torch.tensor([0.0, float("inf")])
    with pytest.raises(FloatingPointError, match="gradient of parameter 'w'"):
        profiling.check_finite(torch.tensor(1.0), grads)


def test_cli_train_artifacts(capsys, tmp_path):
    """``train`` with ``--plots``, ``--save-pred``, ``--profile``,
    ``--history-csv``, ``--history-plot`` and ``--debug-nans``."""
    pytest.importorskip("matplotlib")
    out = {k: str(tmp_path / k) for k in ("plots", "pred.mat", "trace", "h.csv", "h.png")}
    argv = ["train", "--benchmark", "burgers", "--epochs", "2", "--ntrain", "8", "--ntest", "4",
            "--set", "grid=32", "--set", "latent_grid=8", "--set", "model.hid_dim=8",
            "--set", "batch_size=4", "--device", "cpu", "--plots", out["plots"],
            "--save-pred", out["pred.mat"], "--profile", out["trace"], "--history-csv",
            out["h.csv"], "--history-plot", out["h.png"], "--debug-nans"]
    assert t_cli.main(argv) == 0
    capsys.readouterr()
    assert os.listdir(out["plots"]) == ["pred_var1.pdf"]
    from scipy.io import loadmat

    saved = loadmat(out["pred.mat"])
    assert saved["pred"].shape == saved["trueY"].shape == (4, 32, 1)
    assert os.path.exists(os.path.join(out["trace"], "trace.json"))
    assert os.path.getsize(out["h.png"]) > 0 and len(open(out["h.csv"]).readlines()) == 3
    assert not profiling.debug_nans_enabled()  # the CLI restores the setting
