"""Checkpoint evaluation and deployment inference.

:func:`evaluate` gives a checkpoint's test metrics, and with ``zssr=True``
evaluates the same weights zero-shot at a finer resolution (darcy: trained
on the 43^2 grid, evaluated on the 421^2 one). :class:`Predictor` holds a
checkpoint warm on one device for repeated calls; :func:`infer` is the
one-shot form. Inputs are ``.npy``, MATLAB ``.mat`` (v5, or v7.3 through
the optional h5py) or HDF5 ``.h5`` files laid out like the benchmark's
inputs, with raw values: a normalizing benchmark (darcy) normalizes them
with the checkpoint's statistics, resized to the input's own grid. A benchmark on per-sample meshes
(elasticity) also needs each sample's coordinates: its input is a
``.mat`` or ``.h5`` that holds them beside ``x`` (variable ``mesh``).
elasticity_tf reads them from ``x`` and computes its locality thresholds
per call, so a bare ``.npy`` serves it. naca's input is a ``.mat`` holding
the shape points ``x`` and the three meshes ``mesh_in``, ``mesh_ltt`` and
``mesh_out``; its thresholds are computed per call where the input has
none. An autoregressive benchmark (vorticity) rolls each input window
forward ``rollout_steps`` steps (default: its configured horizon), and its
:func:`evaluate` gives stepwise rollout errors. A one-step benchmark whose
problem keeps raw test trajectories (cylinder) is also evaluated by a
closed-loop rollout from each trajectory's first frame, and its model's
output fed back as the next input serves ``rollout_steps`` too.
"""

from __future__ import annotations

import hashlib
import inspect
from typing import Optional

import numpy as np
import torch

from position_induced_transformer_torch.ops.locality import batched_topk_thresholds
from position_induced_transformer_torch.ops.metrics import (
    rel_l1_quartiles,
    rel_lp_norm,
    rel_max_norm,
    rel_norm_step,
    rel_norm_traj,
)
from position_induced_transformer_torch.ops.normalization import PixelWiseNormalizer
from position_induced_transformer_torch.train import benchmarks
from position_induced_transformer_torch.train import checkpoint as ckpt
from position_induced_transformer_torch.train import runner
from position_induced_transformer_torch.train.plots import (
    require_matplotlib,
    save_benchmark_plots,
    save_step_error_plot,
)
from position_induced_transformer_torch.train.runner import padded_batches
from position_induced_transformer_torch.utils.devices import resolve_device


def _setup_accepts(cfg, kwarg: str) -> bool:
    """Whether the benchmark's setup function declares ``kwarg``: found
    from its signature, not from its name, so that any setup following the
    darcy pattern opts in (``normalizers``: an ``(x_norm, y_norm)`` pair
    passed back at evaluation and inference; ``downsampling``: the
    resolution factor of ``evaluate(zssr=True)``)."""
    setup_fn = benchmarks.SETUPS.get(cfg.name)
    if setup_fn is None:
        return False
    try:
        params = inspect.signature(setup_fn).parameters
    except (TypeError, ValueError):
        return False
    return kwarg in params


def _checkpoint_normalizers(cfg, restored, setup_kwargs: dict) -> dict:
    """Pass the training-time normalizer statistics of a restored
    checkpoint to the benchmark's setup, so that evaluation and inference
    at any resolution reuse them (resized on apply)."""
    if _setup_accepts(cfg, "normalizers") and "y_normalizer" in restored:
        if "x_normalizer" not in restored:
            raise ValueError(
                "checkpoint carries y_normalizer but no x_normalizer; "
                "re-train, or evaluate with freshly fitted statistics by "
                "removing y_normalizer from the checkpoint"
            )
        setup_kwargs["normalizers"] = (
            PixelWiseNormalizer(**restored["x_normalizer"]),
            PixelWiseNormalizer(**restored["y_normalizer"]),
        )
    return setup_kwargs


def _load_input(path: str, key: str = "x"):
    """Load a user input batch: ``(x, table)`` where ``table`` is the full
    variable dict of a ``.mat`` or ``.h5``/``.hdf5`` file (None for
    ``.npy``). ``.mat`` goes through ``load_mat`` (v5, or v7.3 transposed
    from MATLAB's column-major storage); ``.h5``/``.hdf5`` are read with
    h5py in their native row-major layout, so batches written by ordinary
    h5py code round-trip unchanged."""
    if path.endswith(".npy"):
        return np.asarray(np.load(path, allow_pickle=False)), None
    from position_induced_transformer_torch.data.loaders import load_mat, read_hdf5

    if path.endswith(".mat"):
        d = load_mat(path)
    elif path.endswith((".h5", ".hdf5")):
        d = read_hdf5(path, transpose=False)
    else:
        raise ValueError(f"unsupported input format {path!r} (expected .npy, .mat, .h5)")
    if key not in d:
        raise KeyError(
            f"variable {key!r} not found in {path}; available: "
            f"{sorted(k for k in d if not k.startswith('__'))}"
        )
    return np.asarray(d[key]), d


def _prepare_inputs(problem, x: np.ndarray) -> np.ndarray:
    """Check a raw input batch against the benchmark's model input layout,
    reshaping when the per-sample element counts agree. A normalizing
    benchmark's inputs are normalized here, on the host: a grid-shaped
    batch at its own resolution with the statistics resized to it (the
    problem's grid may differ from the statistics' one), a flattened batch
    of the statistics' resolution after a reshape to their grid."""
    x = np.asarray(x, np.float32)
    norm = problem.x_normalizer
    if norm is not None:
        gs = tuple(norm.mean.shape[1:])  # the statistics' grid (h, w, C)
        if x.ndim - 1 == len(gs) and x.shape[-1] == gs[-1]:
            pass
        elif int(np.prod(x.shape[1:])) == int(np.prod(gs)):
            x = x.reshape((x.shape[0],) + gs)
        else:
            raise ValueError(
                f"input sample shape {tuple(x.shape[1:])} is incompatible: "
                f"expected a grid-shaped batch (..., h, w, {gs[-1]}) or a "
                f"flattened batch of the training resolution {gs}"
            )
        x = norm.normalize(torch.from_numpy(np.ascontiguousarray(x))).numpy()
    expect = tuple(np.shape(problem.test_data["x"])[1:])
    if x.shape[1:] != expect:
        if int(np.prod(x.shape[1:])) != int(np.prod(expect)):
            raise ValueError(
                f"input sample shape {tuple(x.shape[1:])} does not match "
                f"the benchmark's model input {expect} (after normalization "
                "and reshape)"
            )
        x = x.reshape((x.shape[0],) + expect)
    return np.ascontiguousarray(x)


class _AccessRecorder(dict):
    """A batch dict that records the keys read with ``batch[k]``;
    ``batch.get(k)`` goes through dict's own lookup and is not recorded,
    which is the required/optional split the geometry builders follow."""

    def __init__(self, base):
        super().__init__(base)
        self.hard = set()

    def __getitem__(self, k):
        self.hard.add(k)
        return super().__getitem__(k)


def _required_geometry_keys(problem) -> set:
    """The batch variables besides ``x`` that the benchmark's per-sample
    geometry cannot do without: ``Task.geometry_required_keys`` where it is
    declared, else found by probing ``geom_fn`` on one test sample."""
    task = problem.task
    if task.geometry_required_keys is not None:
        return set(task.geometry_required_keys)
    if task.geom_fn is None:
        return set()
    dev = next(task.model.parameters()).device
    probe = _AccessRecorder(
        {k: torch.from_numpy(np.asarray(v)[:1]).to(dev) for k, v in problem.test_data.items()}
    )
    task.geom_fn(probe)
    return probe.hard - {"x", "y"}


def _prepare_infer_data(problem, x, table, input_path: str, input_key: str, required=None) -> dict:
    """The inference batch dict of a raw input: ``x`` in the model's layout
    and, for per-sample geometry, the benchmark's other variables from the
    parsed ``.mat`` ``table`` (None for ``.npy``). Required variables (the
    coordinates) must be there; optional ones (precomputed thresholds and
    bands) are taken when present, and computed per step otherwise."""
    data = {"x": _prepare_inputs(problem, x)}
    n = int(data["x"].shape[0])
    extra = [k for k in problem.test_data if k not in ("x", "y")]
    if not extra:
        return data
    if required is None:
        required = _required_geometry_keys(problem)
    if table is None and required:
        raise ValueError(
            f"benchmark {problem.config.name!r} builds per-sample geometry "
            f"from the batch variables {sorted(required)}; send a .mat holding "
            f"them beside {input_key!r} (a bare .npy carries one array only)"
        )
    for k in extra:
        if table is None or k not in table:
            if k in required:
                raise ValueError(
                    f"input file {input_path} is missing the required variable "
                    f"{k!r} (benchmark {problem.config.name!r} takes "
                    f"{['x'] + extra})"
                )
            continue
        ref = np.asarray(problem.test_data[k])
        arr = np.asarray(table[k], ref.dtype)
        expect = (n,) + ref.shape[1:]
        if arr.shape != expect:
            raise ValueError(
                f"input variable {k!r} has shape {tuple(arr.shape)}, expected {expect}"
            )
        data[k] = np.ascontiguousarray(arr)
    return data


class Predictor:
    """A restored checkpoint held warm on ``device`` for repeated inference.

    The benchmark problem (geometry on the device, a minimal synthetic data
    split for layouts) is built once, and the batch variables its
    per-sample geometry requires are found once; each ``predict_*`` call
    moves its batches to the device and back. ``setup_kwargs``: extra
    arguments of the benchmark's setup (darcy at 421^2:
    ``{"downsampling": 1}``). A normalizing benchmark takes its statistics
    from the checkpoint; a checkpoint without them refits them on the full
    training split, as its training did. ``model_variant``: the TF family's
    ablation model the checkpoint holds.
    """

    def __init__(
        self,
        config,
        checkpoint_path: str,
        data_path: Optional[str] = None,
        setup_kwargs: Optional[dict] = None,
        device="cuda",
        model_variant: Optional[str] = None,
    ):
        dev = resolve_device(device)
        cfg = runner.with_variant(config, model_variant)
        restored = _restore(checkpoint_path, cfg)
        setup_kwargs = _checkpoint_normalizers(cfg, restored, dict(setup_kwargs or {}))
        nmin = max(2, min(cfg.batch_size, 8))
        # statistics fitted on a minimal split would denormalize wrongly
        ntrain = None if (_setup_accepts(cfg, "normalizers")
                          and "normalizers" not in setup_kwargs) else nmin
        problem = benchmarks.setup(
            cfg, data_path, ntrain=ntrain, ntest=nmin, device=dev, **setup_kwargs
        )
        problem.model.load_state_dict(restored["state_dict"])
        problem.model.eval()
        problem.train_data = {}
        self.cfg = cfg
        with open(checkpoint_path, "rb") as f:  # the checkpoint's identity, not its path
            self.checkpoint_sha256 = hashlib.file_digest(f, "sha256").hexdigest()
        self.problem = problem
        self.device = dev
        self.required_keys = frozenset(_required_geometry_keys(problem))

    def _batch_size(self, batch_size: Optional[int] = None) -> int:
        """The device batch size: requests pad up to it, so every call runs
        at one shape."""
        if batch_size is not None and batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        return batch_size or self.cfg.eval_batch_size or self.cfg.batch_size

    def predict_array(
        self, data: dict, rollout_steps: int = 0, batch_size: Optional[int] = None,
    ) -> np.ndarray:
        """Predictions over a prepared batch dict (padded-tail batching:
        every sample covered, one batch shape); every variable of the dict
        is gathered per batch. ``rollout_steps`` > 0: each window rolled
        forward that many steps, (n, L, out_dim, steps) as
        :meth:`Task.rollout` lays it out."""
        n = int(np.shape(data["x"])[0])
        bs = self._batch_size(batch_size)
        task, geom = self.problem.task, self.problem.geom
        outs = []
        with torch.inference_mode():
            for idx in padded_batches(n, bs):
                batch = {
                    k: torch.from_numpy(np.ascontiguousarray(np.asarray(v)[idx])).to(self.device)
                    for k, v in data.items()
                }
                if rollout_steps:
                    out = task.rollout(geom, batch["x"], rollout_steps)
                else:
                    out = task.forward(geom, batch)
                outs.append(out.cpu().numpy())
        return np.concatenate(outs, axis=0)[:n]

    def prepare_file(self, input_path: str, input_key: str = "x") -> dict:
        """Parse and check an input file into the dict ``predict_array``
        takes."""
        x_raw, table = _load_input(input_path, input_key)
        if x_raw.ndim < 2:
            raise ValueError(
                f"input must carry a leading batch axis; got shape "
                f"{tuple(x_raw.shape)}"
            )
        if x_raw.shape[0] < 1:
            raise ValueError("input batch is empty (0 samples)")
        return _prepare_infer_data(
            self.problem, x_raw, table, input_path, input_key, required=self.required_keys
        )

    def predict_file(
        self, input_path: str, input_key: str = "x",
        rollout_steps: Optional[int] = None, batch_size: Optional[int] = None,
    ) -> np.ndarray:
        """Predictions for an input file; ``rollout_steps`` defaults to the
        benchmark's horizon."""
        steps = self.cfg.rollout_steps if rollout_steps is None else rollout_steps
        return self.predict_array(self.prepare_file(input_path, input_key), steps, batch_size)


def infer(
    config,
    checkpoint_path: str,
    input_path: str,
    input_key: str = "x",
    output_path: Optional[str] = None,
    batch_size: Optional[int] = None,
    rollout_steps: Optional[int] = None,
    data_path: Optional[str] = None,
    setup_kwargs: Optional[dict] = None,
    device="cuda",
    model_variant: Optional[str] = None,
) -> dict:
    """One-shot inference on an input file; writes ``.npy`` or ``.mat``
    (variable ``pred``) when ``output_path`` is given. ``rollout_steps``:
    the horizon of an autoregressive benchmark (default: its configured
    one). ``setup_kwargs`` and ``model_variant`` as for
    :class:`Predictor`."""
    if output_path and not output_path.endswith((".npy", ".mat")):
        raise ValueError(
            f"unsupported output format {output_path!r} (expected .npy or .mat)"
        )
    predictor = Predictor(config, checkpoint_path, data_path=data_path,
                          setup_kwargs=setup_kwargs, device=device, model_variant=model_variant)
    steps = predictor.cfg.rollout_steps if rollout_steps is None else rollout_steps
    pred = predictor.predict_file(input_path, input_key, rollout_steps=steps,
                                  batch_size=batch_size)
    if output_path and output_path.endswith(".npy"):
        np.save(output_path, pred)
    elif output_path:
        from scipy.io import savemat

        savemat(output_path, {"pred": pred})
    return {
        "benchmark": predictor.cfg.name,
        "n": int(pred.shape[0]),
        "pred_shape": [int(s) for s in pred.shape],
        "rollout_steps": int(steps),
        "output": output_path,
    }


def _restore(checkpoint_path: str, cfg) -> dict:
    restored = ckpt.restore(checkpoint_path)
    if restored["config"] != cfg.name:
        raise ValueError(
            f"checkpoint {checkpoint_path!r} holds benchmark "
            f"{restored['config']!r}, not {cfg.name!r}"
        )
    return restored


def _shuffle_perm(n: int) -> np.ndarray:
    """A seeded random n-cycle (no sample keeps its own input): pairings
    uniform over the test set and reproducible."""
    if n < 2:
        raise ValueError(
            "input_shuffle_ablation needs >= 2 test samples: with n=1 the "
            "only permutation is the identity, so the probe would compare "
            "the model against its own true pairing and report zero "
            "inflation regardless of whether the input is used"
        )
    order = np.random.default_rng(0).permutation(n)
    perm = np.empty(n, dtype=np.int64)
    perm[order] = np.roll(order, 1)
    return perm


def input_shuffle_ablation(problem, pred_true=None) -> dict:
    """Whether a one-step model reads its input function: the test rel-L2
    (per-sample mean) with the true inputs and with the inputs shuffled
    across test samples by :func:`_shuffle_perm`, targets and geometry
    fixed.

    - ``naca``: the input shape is also the encoder's source cloud, so it
      moves with the inputs, and the encoder thresholds are recomputed for
      the new pairing (the model sees a consistent geometry);
    - ``elasticity``: only the void-radius channels (2 on) move, the
      cloud's coordinates stay with their targets;
    - otherwise the input frame ``x`` moves.
    """
    cfg = problem.config
    data = dict(problem.test_data)
    n = int(np.shape(data["y"])[0])
    perm = _shuffle_perm(n)
    if cfg.name.startswith("naca") and "mesh_in" in data:
        shuf = np.ascontiguousarray(np.asarray(data["x"])[perm])
        data["x"] = data["mesh_in"] = shuf
        if "thr_down" in data:
            dev = next(problem.model.parameters()).device
            on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            data["thr_down"] = batched_topk_thresholds(
                on(data["mesh_ltt"]), on(shuf), cfg.model.en_loc, cfg.metric
            ).cpu().numpy()
    elif cfg.name.startswith("elasticity") and np.ndim(data["x"]) == 3 and data["x"].shape[-1] > 2:
        x = np.array(data["x"])
        x[:, :, 2:] = x[perm][:, :, 2:]
        data["x"] = x
    else:
        data["x"] = np.asarray(data["x"])[perm]
    if pred_true is None:
        pred_true = runner.predict(problem)
    pred_shuf = runner.predict(problem, data=data)
    y = np.asarray(problem.test_data["y"])

    def rl2(p):  # predictions are mesh-flattened, targets may be grids
        p = np.asarray(p).reshape(y.shape[0], -1, y.shape[-1])
        yy = y.reshape(y.shape[0], -1, y.shape[-1])
        num = np.sqrt(((p - yy) ** 2).sum(1))
        den = np.sqrt((yy**2).sum(1)) + 1e-30
        return round(float((num / den).mean()), 6)

    return {"true_relL2": rl2(pred_true), "shuffled_inputs_relL2": rl2(pred_shuf)}


def _rollout_batches(problem, x: np.ndarray, steps: int) -> np.ndarray:
    """``Task.rollout`` of the windows ``x`` over ``steps`` steps, in padded
    batches of the eval batch size on the model's device: (n, L, C,
    steps)."""
    cfg = problem.config
    n = x.shape[0]
    bs = min(cfg.eval_batch_size or cfg.batch_size, n)
    dev = next(problem.model.parameters()).device
    problem.model.eval()
    preds = []
    with torch.inference_mode():
        for idx in padded_batches(n, bs):
            xb = torch.from_numpy(np.ascontiguousarray(x[idx])).to(dev)
            preds.append(problem.task.rollout(problem.geom, xb, steps).cpu().numpy())
    return np.concatenate(preds, axis=0)[:n]


def _cylinder_rollout(problem) -> dict:
    """The closed-loop rollout of every raw test trajectory (N, L, C, T)
    of ``problem.extras["test_trajectories"]``: T - 1 steps from its first
    frame, the model's output fed back, scored against the true frames by
    the per-step relative L2 error."""
    traj = np.asarray(problem.extras["test_trajectories"])
    steps = traj.shape[-1] - 1
    pred = _rollout_batches(problem, np.ascontiguousarray(traj[..., 0]), steps)
    true = torch.from_numpy(np.ascontiguousarray(traj[..., 1:]))
    step_err = rel_norm_step(true, torch.from_numpy(pred)).numpy()
    return {
        "rollout_steps": steps,
        "rollout_rel_l2_step": [float(v) for v in step_err],
        "rollout_rel_l2_mean": float(step_err.mean()),
    }


def _evaluate_rollout(cfg, problem, zssr: bool, save_pred: Optional[str],
                      plots_dir: Optional[str] = None) -> dict:
    """The rollout metrics of an autoregressive benchmark: each test
    window rolled ``cfg.rollout_steps`` steps in padded batches of the eval
    batch size; the per-step relative L2 error (mean over samples), its
    mean over steps, and the whole-trajectory error."""
    steps = cfg.rollout_steps
    pred = _rollout_batches(problem, np.asarray(problem.test_data["x"]), steps)
    n = pred.shape[0]  # (n, L, out_dim, steps)
    true = np.asarray(problem.test_data["y"])[:n]
    t, p = torch.from_numpy(np.ascontiguousarray(true)), torch.from_numpy(pred)
    step_err = rel_norm_step(t, p).numpy()
    result = {
        "benchmark": cfg.name,
        "n_test": int(n),
        "zssr": zssr,
        "rollout_steps": steps,
        "rel_l2_step": [float(v) for v in step_err],
        "rel_l2_traj": float(rel_norm_traj(t, p)),
        "rel_l2_mean_step": float(step_err.mean()),
    }
    if plots_dir:
        save_step_error_plot(step_err, plots_dir)
        save_benchmark_plots(problem, pred, plots_dir)
    if save_pred:
        from scipy.io import savemat

        savemat(save_pred, {"pred": pred, "true": true})
    return result


def evaluate(
    config,
    checkpoint_path: str,
    data_path: Optional[str] = None,
    ntest: Optional[int] = None,
    zssr: bool = False,
    zssr_downsampling: int = 1,
    save_pred: Optional[str] = None,
    plots_dir: Optional[str] = None,
    setup_kwargs: Optional[dict] = None,
    mesh=None,
    model_variant: Optional[str] = None,
    shuffle_ablation: bool = False,
    device="cuda",
) -> dict:
    """Test metrics of a checkpoint on one device: ``rel_l1``, ``rel_l2``
    and ``rel_max`` (per-sample means) and the quartiles of the per-sample
    relative L1 error, over ``ntest`` test samples.

    ``zssr=True``: zero-shot super-resolution, the same weights bound to
    the grid of ``zssr_downsampling`` (1: darcy's full 421^2 grid), for a
    benchmark whose setup declares ``downsampling``. Normalizer statistics
    come from the checkpoint (refitted on the training split where it has
    none); with them, the training split is cut to ``ntest`` samples,
    since nothing reads it. ``save_pred``: a ``.mat`` with ``pred`` and
    ``true``. ``shuffle_ablation=True`` adds :func:`input_shuffle_ablation`
    (one-step benchmarks only: a rollout benchmark refuses it).

    A problem whose ``extras`` hold raw ``test_trajectories`` (cylinder)
    adds the closed-loop rollout of each: ``rollout_steps``,
    ``rollout_rel_l2_step`` and ``rollout_rel_l2_mean``. An
    autoregressive benchmark (vorticity) gives its rollout metrics
    instead: ``rel_l2_step`` per step, ``rel_l2_mean_step`` and
    ``rel_l2_traj``. ``plots_dir``: the benchmark's figures
    (``plots.save_benchmark_plots``) and, with a rollout, the per-step
    error curve (needs matplotlib, checked first). ``model_variant``: the
    TF family's ablation model the checkpoint holds. ``mesh`` is not
    ported.
    """
    runner._not_ported("evaluate", mesh=mesh)
    if plots_dir:
        require_matplotlib()
    cfg = runner.with_variant(config, model_variant)
    if cfg.rollout_steps and shuffle_ablation:
        raise ValueError(
            "--shuffle-ablation probes the one-step operator map; "
            f"{cfg.name!r} evaluates an in-graph rollout (shuffling "
            "the initial frame would measure trajectory divergence, "
            "not input use)"
        )
    restored = _restore(checkpoint_path, cfg)
    setup_kwargs = dict(setup_kwargs or {})
    if zssr:
        if not _setup_accepts(cfg, "downsampling"):
            raise ValueError(
                "zssr needs a benchmark whose setup declares a "
                f"'downsampling' argument (darcy); {cfg.name!r} does not"
            )
        setup_kwargs["downsampling"] = zssr_downsampling
    setup_kwargs = _checkpoint_normalizers(cfg, restored, setup_kwargs)
    ntrain = (ntest or cfg.ntest) if "normalizers" in setup_kwargs else None
    problem = benchmarks.setup(
        cfg, data_path, ntrain=ntrain, ntest=ntest, device=device, **setup_kwargs
    )
    problem.model.load_state_dict(restored["state_dict"])
    if cfg.rollout_steps:
        return _evaluate_rollout(cfg, problem, zssr, save_pred, plots_dir)
    pred = runner.predict(problem)
    n = pred.shape[0]
    true = np.asarray(problem.test_data["y"])[:n]
    out_dim = cfg.model.out_dim
    t, p = torch.from_numpy(np.ascontiguousarray(true)), torch.from_numpy(pred)
    q25, q50, q75 = rel_l1_quartiles(t.reshape(n, -1, out_dim), p.reshape(n, -1, out_dim))
    result = {
        "benchmark": cfg.name,
        "n_test": n,
        "zssr": zssr,
        "rel_l1": float(rel_lp_norm(t, p, out_dim, 1)) / n,
        "rel_l2": float(rel_lp_norm(t, p, out_dim, 2)) / n,
        "rel_max": float(rel_max_norm(t, p, out_dim)) / n,
        "rel_l1_quartiles": [float(q25), float(q50), float(q75)],
    }
    if shuffle_ablation:
        result["shuffle_ablation"] = input_shuffle_ablation(problem, pred_true=pred)
    # a capability, not a name: any problem with raw test trajectories
    if "test_trajectories" in problem.extras:
        result.update(_cylinder_rollout(problem))
    if plots_dir:
        save_benchmark_plots(problem, pred, plots_dir)
        if "rollout_rel_l2_step" in result:
            save_step_error_plot(result["rollout_rel_l2_step"], plots_dir)
    if save_pred:
        from scipy.io import savemat

        savemat(save_pred, {"pred": pred, "true": true})
    return result
