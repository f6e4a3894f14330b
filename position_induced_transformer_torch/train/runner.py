"""The benchmark runner: train, evaluate and predict on one device, or
over the ranks of a ``torch.distributed`` world (data, model and stage
axes).

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
from position_induced_transformer_torch.parallel import multihost
from position_induced_transformer_torch.parallel.pipeline import enable_pipeline, sync_stages
from position_induced_transformer_torch.parallel.sharding import (
    StageMesh,
    data_axis_size,
    gather_rows,
    parse_mesh_spec,
    replicate_tree,
    shard_rows,
)
from position_induced_transformer_torch.parallel.tensor_parallel import (
    gather_state,
    param_shardings,
    shard_state,
)
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
    """Train a benchmark end to end on one device, or data-parallel over a
    ``mesh``; returns ``(problem, state, history)``.

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
    ``transformer``, ``selfpit``; default the config's).

    ``mesh`` (``'auto'``, ``'data=N[,model=M]'``, ``'dcn=K,data=N[,model=M]'``,
    ``'stage=K'``, or a ``parallel.DataMesh`` / ``StageMesh``;
    ``parallel.sharding.parse_mesh_spec``): this process is one rank of an
    initialized process group, and every rank calls ``train`` with the
    same arguments. Each batch index takes its shard of every batch (which
    must divide over the data x dcn ranks, as must a grad-accum
    microbatch), and the gradients are summed over them each step. Under
    ``model=M`` each rank trains its part of the model, of either family
    (``parallel.tensor_parallel``: MLP widths split, PiT's heads where M
    divides them, the TF family's attention whole, Adam moments alike;
    ``Task.param_constraint`` acts on each rank's part); under
    ``stage=K`` the processor runs GPipe pipelined over the ranks
    (``parallel.pipeline``; the torch family's fixed meshes; the schedule
    picked from the batch a forward sees, ``batch_size / grad_accum``).
    Every rank returns the same whole weights (the one-process layout) and
    history. Only rank 0 prints and writes the log, the history files and
    the checkpoints, which hold the model's own state dict and restore in
    one process.
    """
    if history_plot:
        require_matplotlib()
    mesh = parse_mesh_spec(mesh)
    main = multihost.is_main()
    verbose = verbose and main
    cfg = with_variant(config, model_variant)
    problem = benchmarks.setup(
        cfg, data_path, ntrain=ntrain, ntest=ntest, device=device, **(setup_kwargs or {})
    )
    stages = isinstance(mesh, StageMesh)
    data_mesh = None if stages else mesh  # a stage mesh keeps every batch whole
    tensor_parallel = data_mesh is not None and data_mesh.model > 1
    if tensor_parallel:
        param_shardings(data_mesh, problem.model)  # odd MLP widths raise now
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
    n_data = data_axis_size(data_mesh)
    if cfg.batch_size % n_data:
        raise ValueError(
            f"batch_size {cfg.batch_size} is not divisible by the mesh data "
            f"(x dcn) axis size ({n_data})"
        )
    if (cfg.batch_size // grad_accum) % n_data:
        raise ValueError(
            f"microbatch size {cfg.batch_size // grad_accum} (batch {cfg.batch_size} / "
            f"grad-accum {grad_accum}) is not divisible by the mesh data (x dcn) "
            f"axis size ({n_data})"
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
    replicate_tree(mesh, state.model.state_dict())  # rank 0's weights everywhere
    whole_task, whole_model, n_micro = problem.task, state.model, 1
    if stages:
        fwd_bs = cfg.batch_size // grad_accum  # the batch a forward sees
        n_micro = enable_pipeline(problem, mesh, batch_size=fwd_bs)
        if fwd_bs % n_micro:  # only where PIT_PP_MICRO forces a non-divisor
            raise ValueError(
                f"microbatch size {fwd_bs} is not divisible into the pipeline "
                f"schedule's {n_micro} GPipe microbatches"
            )
    elif tensor_parallel:
        state = shard_state(data_mesh, state)
        problem.task = dataclasses.replace(problem.task, model=state.model)

    norms = {k: n.state() for k, n in (("x_normalizer", problem.x_normalizer),
                                        ("y_normalizer", problem.y_normalizer)) if n is not None}

    def whole_state():
        """The one-process training state: a collective under a model or
        stage axis (every rank's part gathered, or every stage's blocks)."""
        if tensor_parallel:
            return gather_state(data_mesh, state, whole_model)
        if stages:
            sync_stages(mesh, state.model, state.optimizer)
        return state

    def save(path, st=None):
        st = st or whole_state()
        if main:
            ckpt.save(path, st.model.state_dict(), cfg.name,
                      optimizer=st.optimizer.state_dict(), step=st.step, **norms)
        multihost.barrier()  # no rank reads it before it is whole

    to_dev = lambda d: {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in d.items()}
    train_data, test_data = to_dev(problem.train_data), to_dev(problem.test_data)
    train_epoch = make_train_epoch(problem.task, schedule, grad_accum, mesh=data_mesh)
    # a rollout task's eval epoch gives its own stepwise set
    metrics = None if cfg.rollout_steps else default_metrics(cfg.model.out_dim)
    eval_epoch = make_eval_epoch(problem.task, metrics, mesh=data_mesh)
    # the eval batch divides over the ranks too, and into the GPipe schedule
    eval_bs = round_batch(min(cfg.eval_batch_size or cfg.batch_size, problem.n_test), n_data)
    eval_bs = round_batch(eval_bs, n_micro)
    eval_perm = eval_permutation(problem.n_test, eval_bs).to(dev)
    denom = n_batches if problem.task.batch_mean_loss else n_batches * cfg.batch_size

    history = []
    logf = open(log_path, "a") if log_path and main else None
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
        profile_epoch = min(start_epoch + 1, epochs - 1) if profile_dir and main else -1
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
    if (history_csv or history_plot) and main:
        save_history(history, history_csv, history_plot)
    state = whole_state()
    if tensor_parallel:  # prediction after training replicates the whole weights
        problem.task = whole_task
    if checkpoint_path and last_periodic_save != epochs - 1:
        save(checkpoint_path, state)
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


def predict(problem, data=None, batch_size: Optional[int] = None, mesh=None) -> np.ndarray:
    """Predictions of ``problem.model`` over a host data dict (default: the
    test split), in padded batches of one size on the model's device. Every
    variable of the dict rides with its batch: per-sample geometry reads
    its coordinates from there. The batch size is rounded to the task's
    GPipe micro-batch count where it runs pipelined. ``mesh``: data-parallel
    prediction, every rank calling with the same arguments; each batch
    index runs its shard of every batch (the batch size rounded to a
    multiple of the data x dcn ranks; the ranks of a model group compute
    the same rows with the whole weights) and every rank returns the whole
    prediction. A stage mesh keeps every batch whole."""
    mesh = parse_mesh_spec(mesh)
    if isinstance(mesh, StageMesh):
        mesh = None
    data = data if data is not None else problem.test_data
    n = np.shape(data["x"])[0]
    bs = min(batch_size or problem.config.eval_batch_size or problem.config.batch_size, n)
    bs = round_batch(round_batch(bs, problem.task.pp_micro or 1), data_axis_size(mesh))
    dev = next(problem.model.parameters()).device
    problem.model.eval()
    outs = []
    with torch.inference_mode():
        for idx in padded_batches(n, bs):
            if mesh is not None:
                idx = shard_rows(mesh, idx)
            batch = {k: torch.from_numpy(np.ascontiguousarray(np.asarray(v)[idx])).to(dev)
                     for k, v in data.items()}
            out = problem.task.forward(problem.geom, batch)
            if mesh is not None:
                out = gather_rows(mesh, out)
            outs.append(out.cpu().numpy())
    return np.concatenate(outs, axis=0)[:n]
