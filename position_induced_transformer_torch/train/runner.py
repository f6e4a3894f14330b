"""The benchmark runner: train, evaluate and predict on one device.

Per epoch it runs the train epoch and the eval epoch, prints the columns
the JAX package's runner prints (epoch, seconds, train loss, the test
metrics), appends them as JSONL, and writes checkpoints. Also the batching
conventions shared by prediction and serving.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import time
from typing import Optional

import numpy as np
import torch

from position_induced_transformer_torch.configs import BenchmarkConfig, get
from position_induced_transformer_torch.ops.metrics import rel_lp_norm, rel_max_norm
from position_induced_transformer_torch.train import benchmarks
from position_induced_transformer_torch.train import checkpoint as ckpt
from position_induced_transformer_torch.train.loop import (
    TrainState,
    epoch_permutation,
    eval_permutation,
    make_eval_epoch,
    make_lr_schedule,
    make_optimizer,
    make_train_epoch,
)
from position_induced_transformer_torch.train.plots import require_matplotlib
from position_induced_transformer_torch.utils.profiling import trace


def padded_batches(n: int, batch_size: int):
    """Index arrays covering all ``n`` samples in batches of one size; the
    final partial batch repeats the last index (slice the concatenated
    outputs to ``[:n]`` to drop the duplicates)."""
    for i in range(0, n, batch_size):
        yield np.minimum(np.arange(i, i + batch_size), n - 1)


def round_batch(bs: int, k: int) -> int:
    """Round ``bs`` down to a multiple of ``k`` (floor ``k``)."""
    return max(k, bs - bs % k) if k > 1 else bs


def init_state(problem, seed: int = 0) -> TrainState:
    """Draw the model's weights from ``torch.Generator().manual_seed(seed)``
    (in place, so ``problem.task.model`` stays the same module) and make
    its optimizer: the keras Adam where the task asks for it (the TF
    family), else Adam."""
    fresh = benchmarks._make_model(problem.config, torch.Generator().manual_seed(seed))
    problem.model.load_state_dict(fresh.state_dict())
    flavor = "keras" if problem.task.keras_adam else "adam"
    return TrainState(problem.model, make_optimizer(problem.model.parameters(), problem.config.lr, flavor))


def default_metrics(out_dim: int):
    return {
        "rel_l1": functools.partial(rel_lp_norm, out_dim=out_dim, p=1),
        "rel_l2": functools.partial(rel_lp_norm, out_dim=out_dim, p=2),
        "rel_max": functools.partial(rel_max_norm, out_dim=out_dim),
    }


def _not_ported(fn="train", **options):
    for name, value in options.items():
        if value:
            raise NotImplementedError(f"{fn}({name}=...) is not ported yet: {value!r}")


def with_variant(config, model_variant: Optional[str] = None):
    """The benchmark's config (a name or a config), with ``model_variant``
    (``pit``, ``lite``, ``transformer``, ``selfpit``: the TF family's
    ablation models) where one is given."""
    cfg = get(config) if isinstance(config, str) else config
    return dataclasses.replace(cfg, model_variant=model_variant) if model_variant else cfg


def train(
    config: "BenchmarkConfig | str",
    data_path: Optional[str] = None,
    epochs: Optional[int] = None,
    ntrain: Optional[int] = None,
    ntest: Optional[int] = None,
    seed: Optional[int] = None,
    log_path: Optional[str] = None,
    checkpoint_path: Optional[str] = None,
    verbose: bool = True,
    profile_dir: Optional[str] = None,
    history_csv: Optional[str] = None,
    history_plot: Optional[str] = None,
    resume_from: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    schedule_epochs: Optional[int] = None,
    sync_every: int = 1,
    mesh=None,
    model_variant: Optional[str] = None,
    grad_accum: int = 1,
    setup_kwargs: Optional[dict] = None,
    device="cuda",
):
    """Train a benchmark end to end on one device; returns
    ``(problem, state, history)``.

    The training data move to the device once. ``resume_from``: restore
    weights, optimizer state and step from a training checkpoint and go
    on from the epoch they end in. ``checkpoint_every``: also write
    ``checkpoint_path`` every N epochs. ``schedule_epochs``: the cosine
    horizon when it differs from ``epochs`` (a run that will be resumed
    decays over the whole intended horizon). ``sync_every``: read the
    epoch's sums back every N epochs (0 = only at the end); with N != 1
    the ``seconds`` column is the mean over the group. ``setup_kwargs``:
    extra arguments of the benchmark's setup (darcy: ``downsampling``).
    A normalizing benchmark's checkpoints carry its normalizer statistics.
    ``profile_dir``: a ``torch.profiler`` Chrome trace of one epoch (the
    second one run, the first of a one-epoch run) into that directory.
    ``history_csv`` / ``history_plot``: the per-epoch rows as CSV and as a
    log-scale plot (needs matplotlib, checked before training starts).
    ``model_variant``: the TF family's ablation model (``lite``,
    ``transformer``, ``selfpit``; default the config's). ``mesh`` is not
    ported.
    """
    _not_ported(mesh=mesh)
    if history_plot:
        require_matplotlib()
    cfg = with_variant(config, model_variant)
    problem = benchmarks.setup(
        cfg, data_path, ntrain=ntrain, ntest=ntest, device=device, **(setup_kwargs or {})
    )
    dev = next(problem.model.parameters()).device
    epochs = epochs if epochs is not None else cfg.epochs
    seed = seed if seed is not None else cfg.seed

    n_batches = problem.n_train // cfg.batch_size
    if n_batches == 0:
        raise ValueError(
            f"ntrain={problem.n_train} yields zero whole training batches at "
            f"batch_size={cfg.batch_size}; pass ntrain >= the batch size"
        )
    if grad_accum > 1 and cfg.batch_size % grad_accum:
        raise ValueError(
            f"batch_size {cfg.batch_size} is not divisible into {grad_accum} microbatches"
        )
    schedule = make_lr_schedule(
        cfg.lr, (schedule_epochs or epochs) * n_batches, warmup_steps=cfg.warmup_steps
    )
    state = init_state(problem, seed)
    start_epoch = 0
    if resume_from:
        restored = ckpt.restore(resume_from)
        if "step" not in restored or restored["config"] != cfg.name:
            raise ValueError(
                f"{resume_from!r} is not a training checkpoint of {cfg.name!r}"
            )
        state.model.load_state_dict(restored["state_dict"])
        state.optimizer.load_state_dict(restored["optimizer"])
        state.step = restored["step"]
        start_epoch = state.step // n_batches

    norms = {k: n.state() for k, n in (("x_normalizer", problem.x_normalizer),
                                        ("y_normalizer", problem.y_normalizer)) if n is not None}

    def save(path):
        ckpt.save(path, state.model.state_dict(), cfg.name,
                  optimizer=state.optimizer.state_dict(), step=state.step, **norms)

    to_dev = lambda d: {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in d.items()}
    train_data, test_data = to_dev(problem.train_data), to_dev(problem.test_data)
    train_epoch = make_train_epoch(problem.task, schedule, grad_accum)
    # a rollout task's eval epoch gives its own stepwise set
    metrics = None if cfg.rollout_steps else default_metrics(cfg.model.out_dim)
    eval_epoch = make_eval_epoch(problem.task, metrics)
    eval_bs = min(cfg.eval_batch_size or cfg.batch_size, problem.n_test)
    eval_perm = eval_permutation(problem.n_test, eval_bs).to(dev)
    denom = n_batches if problem.task.batch_mean_loss else n_batches * cfg.batch_size

    history = []
    logf = open(log_path, "a") if log_path else None
    pending = []  # (epoch, device train loss, device eval sums)
    group_t0 = time.perf_counter()

    def flush():
        nonlocal group_t0
        if not pending:
            return
        # the host reads of the last epoch's sums wait for the device
        rows = [(ep, float(loss), {k: float(v) for k, v in evals.items()})
                for ep, loss, evals in pending]
        dt = (time.perf_counter() - group_t0) / len(pending)
        for ep, loss, evals in rows:
            row = {"epoch": ep, "seconds": dt, "train_loss": loss / denom,
                   **{k: v / problem.n_test for k, v in evals.items()}}
            if cfg.rollout_steps and not problem.task.trajectory_loss:
                # summed per-step losses, reported per step (the stepwise
                # metrics are means over steps already)
                row["loss"] /= cfg.rollout_steps
                row["train_loss"] /= cfg.rollout_steps
            history.append(row)
            if verbose:
                print(ep, f"{dt:.3f}", f"{row['train_loss']:.6f}",
                      *(f"{row[k]:.6f}" for k in evals), flush=True)
            if logf:
                logf.write(json.dumps(row) + "\n")
                logf.flush()
        pending.clear()
        group_t0 = time.perf_counter()

    last_periodic_save = -1
    try:
        # the first epoch pays for kernel builds and allocator growth
        profile_epoch = min(start_epoch + 1, epochs - 1) if profile_dir else -1
        for ep in range(start_epoch, epochs):
            perm = epoch_permutation(seed, ep, problem.n_train, cfg.batch_size).to(dev)
            if ep == profile_epoch:
                with trace(profile_dir):
                    state, train_loss = train_epoch(state, problem.geom, train_data, perm)
                    float(train_loss.sum())  # the device finishes inside the trace
            else:
                state, train_loss = train_epoch(state, problem.geom, train_data, perm)
            evals = eval_epoch(problem.geom, test_data, eval_perm, problem.n_test)
            pending.append((ep, train_loss.sum(), evals))
            if sync_every and (ep + 1 - start_epoch) % sync_every == 0:
                flush()
            if checkpoint_path and checkpoint_every and (ep + 1) % checkpoint_every == 0:
                flush()
                save(checkpoint_path)
                last_periodic_save = ep
                group_t0 = time.perf_counter()  # the save is not the next epoch's time
        flush()
    finally:
        if logf:
            logf.close()
    if history_csv or history_plot:
        save_history(history, history_csv, history_plot)
    if checkpoint_path and last_periodic_save != epochs - 1:
        save(checkpoint_path)
    return problem, state, history


def save_history(history, csv_path=None, plot_path=None):
    """The per-epoch rows: as CSV, one column per key, and as a log-scale
    plot of every column but the epoch and its seconds (needs
    matplotlib)."""
    if not history:
        return
    keys = list(history[0].keys())
    if csv_path:
        with open(csv_path, "w") as f:
            f.write(",".join(keys) + "\n")
            for row in history:
                f.write(",".join(str(row.get(k, "")) for k in keys) + "\n")
    if plot_path:
        plt = require_matplotlib()
        plt.figure(figsize=(6, 4), dpi=120)
        epochs = [r["epoch"] for r in history]
        for k in keys:
            if k not in ("epoch", "seconds"):
                plt.semilogy(epochs, [r[k] for r in history], label=k)
        plt.xlabel("epoch")
        plt.legend()
        plt.tight_layout()
        plt.savefig(plot_path)
        plt.close()


def predict(problem, data=None, batch_size: Optional[int] = None) -> np.ndarray:
    """Predictions of ``problem.model`` over a host data dict (default: the
    test split), in padded batches of one size on the model's device. Every
    variable of the dict rides with its batch: per-sample geometry reads
    its coordinates from there."""
    data = data if data is not None else problem.test_data
    n = np.shape(data["x"])[0]
    bs = min(batch_size or problem.config.eval_batch_size or problem.config.batch_size, n)
    dev = next(problem.model.parameters()).device
    problem.model.eval()
    outs = []
    with torch.inference_mode():
        for idx in padded_batches(n, bs):
            batch = {k: torch.from_numpy(np.ascontiguousarray(np.asarray(v)[idx])).to(dev)
                     for k, v in data.items()}
            outs.append(problem.task.forward(problem.geom, batch).cpu().numpy())
    return np.concatenate(outs, axis=0)[:n]
