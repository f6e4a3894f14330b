"""Per-benchmark prediction figures.

The figures of the JAX package's ``train/plots.py``: 1-D true-against-
predicted lines (Burgers, sod), Darcy's contour panels, vorticity's frame
triplets, point-cloud scatters (elasticity, NACA) and cylinder's field
plots (``tricontourf`` over the element triangles where the problem has
them, a scatter otherwise), and the per-step error curve of a rollout
(``runner.save_history`` draws the training history).

matplotlib is optional: it is imported when a figure is drawn, never when
this module is imported, and a figure asked for without it raises an
``ImportError`` that names it.
"""

from __future__ import annotations

import os

import numpy as np


def require_matplotlib():
    """``matplotlib.pyplot`` on the Agg backend; an ``ImportError`` that
    names matplotlib when it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "plots (plots_dir, history_plot, --plots, --history-plot) need "
            "matplotlib, which is not installed"
        ) from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _line_plots(mesh, true, pred, outdir, index=-1):
    plt = require_matplotlib()
    t = true[index].reshape(len(mesh), -1)
    p = pred[index].reshape(len(mesh), -1)
    for var in range(t.shape[-1]):
        plt.figure(figsize=(8, 5), dpi=120)
        plt.plot(mesh.ravel(), t[:, var], label="true")
        plt.plot(mesh.ravel(), p[:, var], label="pred", ls="--")
        plt.legend()
        plt.savefig(os.path.join(outdir, f"pred_var{var + 1}.pdf"))
        plt.close()


def _grid_panels(x, true, pred, s, outdir, index=-1):
    plt = require_matplotlib()
    fields = {
        "input": x[index].reshape(s, s, -1)[..., -1],
        "reference": true[index].reshape(s, s, -1)[..., 0],
        "prediction": pred[index].reshape(s, s, -1)[..., 0],
    }
    fields["abs error"] = np.abs(fields["reference"] - fields["prediction"])
    plt.figure(figsize=(14, 4), dpi=150)
    for i, (name, f) in enumerate(fields.items(), 1):
        plt.subplot(1, 4, i)
        plt.imshow(f, cmap="plasma")
        plt.colorbar(location="bottom", fraction=0.046, pad=0.04)
        plt.axis("off")
        plt.title(name)
    plt.tight_layout()
    plt.savefig(os.path.join(outdir, "prediction.pdf"))
    plt.close()


def save_step_error_plot(step_err, outdir, name="rollout_error.png"):
    """The relative L2 error against the rollout step; returns the path."""
    plt = require_matplotlib()
    os.makedirs(outdir, exist_ok=True)
    steps = np.arange(1, len(step_err) + 1)
    plt.figure(figsize=(6, 4), dpi=120)
    plt.plot(steps, np.asarray(step_err), marker="o")
    plt.xlabel("rollout step")
    plt.ylabel("relative $L_2$ error")
    plt.xticks(steps[:: max(1, len(steps) // 10)])
    plt.grid(alpha=0.3)
    plt.tight_layout()
    path = os.path.join(outdir, name)
    plt.savefig(path)
    plt.close()
    return path


def _frame_plots(true, pred, s, outdir, index=-1, max_frames=5):
    plt = require_matplotlib()
    t = true[index].reshape(s, s, -1)
    p = pred[index].reshape(s, s, -1)
    vmax, vmin = t.max(), t.min()
    for i in range(min(t.shape[-1], max_frames)):
        for name, f in (("reference", t), ("pred", p), ("err", np.abs(t - p))):
            plt.figure(figsize=(4, 4), dpi=120)
            plt.imshow(
                f[..., i],
                vmax=vmax if name != "err" else None,
                vmin=vmin if name != "err" else None,
                cmap="plasma",
            )
            plt.axis("off")
            plt.savefig(os.path.join(outdir, f"{name}_{i + 1}.pdf"))
            plt.close()


def _scatter_plots(points, true, pred, outdir, index=-1):
    plt = require_matplotlib()
    xy = points[index] if points.ndim == 3 else points
    t = true[index].reshape(len(xy), -1)
    p = pred[index].reshape(len(xy), -1)
    for var in range(t.shape[-1]):
        for name, f in (("true", t), ("pred", p), ("error", np.abs(t - p))):
            plt.figure(figsize=(8, 8), dpi=120)
            plt.scatter(xy[:, 0], xy[:, 1], c=f[:, var], cmap="plasma", s=12)
            plt.colorbar()
            plt.axis("equal")
            plt.savefig(os.path.join(outdir, f"{name}_var{var + 1}.pdf"))
            plt.close()


def _tricontourf_plots(points, elements, true, pred, outdir, index=-1):
    """Field plots over the element triangles: true, predicted and error
    per variable, the true value range for the first two."""
    plt = require_matplotlib()
    import matplotlib.tri as mtri

    triangulation = mtri.Triangulation(points[:, 0], points[:, 1], elements)
    t = true[index].reshape(len(points), -1)
    p = pred[index].reshape(len(points), -1)
    for var in range(t.shape[-1]):
        vmax, vmin = t[:, var].max(), t[:, var].min()
        fields = (
            ("true", t[:, var], vmin, vmax),
            ("pred", p[:, var], vmin, vmax),
            ("err", np.abs(t[:, var] - p[:, var]), None, None),
        )
        for name, f, lo, hi in fields:
            plt.figure(figsize=(8, 4), dpi=100)
            plt.axes([0, 0, 1, 1])
            plt.tricontourf(triangulation, f, vmin=lo, vmax=hi, levels=512, cmap="plasma")
            plt.axis("off")
            plt.axis("equal")
            plt.savefig(os.path.join(outdir, f"{name}_var{var + 1}.pdf"))
            plt.close()


def save_benchmark_plots(problem, pred: np.ndarray, outdir: str, index=-1):
    """Write the figures of this benchmark's predictions ``pred`` (of the
    test split, in its order) into ``outdir``; returns ``outdir``."""
    require_matplotlib()
    os.makedirs(outdir, exist_ok=True)
    cfg = problem.config
    true = np.asarray(problem.test_data["y"])[: pred.shape[0]]
    name = cfg.name.replace("_tf", "")

    if name in ("burgers", "sod"):
        L = pred.shape[1]
        mesh = np.linspace(*cfg.domain, L, endpoint=False).reshape(-1, 1)
        _line_plots(mesh, true, pred, outdir, index)
    elif name == "darcy":
        s = problem.extras.get("s", int(round(pred.shape[1] ** 0.5)))
        x = np.asarray(problem.test_data["x"])[: pred.shape[0]]
        _grid_panels(x, true, pred, s, outdir, index)
    elif name == "vorticity":
        s = problem.extras.get("s", int(round(pred.shape[1] ** 0.5)))
        _frame_plots(true, pred, s, outdir, index)
    elif name in ("elasticity", "naca"):
        key = "mesh" if "mesh" in problem.test_data else "mesh_out"
        pts = np.asarray(problem.test_data[key])[: pred.shape[0]]
        _scatter_plots(
            pts, true.reshape(pred.shape[0], -1, cfg.model.out_dim),
            pred.reshape(pred.shape[0], -1, cfg.model.out_dim), outdir, index,
        )
    elif name == "cylinder":
        pts = problem.geom.mesh_in.cpu().numpy()
        elements = problem.extras.get("elements")
        if elements is not None:
            _tricontourf_plots(pts, np.asarray(elements), true, pred, outdir, index)
        else:
            _scatter_plots(pts, true, pred, outdir, index)
    return outdir

