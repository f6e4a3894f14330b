"""Training traffic: the program's training step (``train/loop.
make_train_epoch`` over the Problem ``train/benchmarks.setup`` builds, with
the configuration's optimizer and cosine schedule) run back to back over
seeded epochs of the training set, which lives on the device.

Set-up builds the one training state, drives it through the first three
steps on rows that all differ (the steps the reference follows), then
``warm_steps`` more, all through the window's own call and feed. The
window then runs chunks of ``chunk_steps`` steps until ``--seconds`` have
passed, with no synchronisation but one at its end: samples completed over
the whole window's time give the mix's ``metric`` (in its ``unit``). A
traced run then runs a second window of the same length under the
profiler, for the per-layer readers.

Mix parameters: ``chunk_steps``, ``warm_steps``, ``metric``, ``unit``.
"""

from __future__ import annotations

import json
import time

import torch

from portbench import checks, harness, trace, weights
from portbench.reference.common import Precision, no_tf32

N_CHECKED = 3


class Rows:
    """Seeded epochs of shuffled batch rows on the device."""

    def __init__(self, seed: int, n: int, batch: int, device):
        self.gen = weights.generator(seed, "batches", device)
        self.n, self.batch, self.device = n, batch, device
        self.epoch_rows = []
        self.taken = []

    def take(self, k: int) -> torch.Tensor:
        while len(self.epoch_rows) < k:
            perm = torch.randperm(self.n, generator=self.gen, device=self.device)
            nb = self.n // self.batch
            self.epoch_rows += list(perm[: nb * self.batch].reshape(nb, self.batch))
        rows, self.epoch_rows = self.epoch_rows[:k], self.epoch_rows[k:]
        self.taken += rows
        return torch.stack(rows)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _span_hooks(model, opt):
    """Host spans around each forward, backward (with the loss) and
    optimizer update, opened from the module's and optimizer's hooks."""
    fwd, bwd, upd = (trace.OpenSpan(f"portbench.{n}") for n in ("forward", "backward", "optimizer"))

    def after_forward(*_):
        fwd.close()
        bwd.open()

    def before_update(*_):
        bwd.close()
        upd.open()

    return [model.register_forward_pre_hook(fwd.open), model.register_forward_hook(after_forward),
            opt.register_step_pre_hook(before_update), opt.register_step_post_hook(upd.close)]


def prepare(cell: harness.Cell) -> dict:
    """Set-up: the program's training state, driven through its checked and
    warm-up steps. Returns what the window and the check need."""
    from position_induced_transformer_torch.train import loop

    cfg, dev, ref = cell.cfg, cell.device, cell.reference
    pcfg = harness.program_config(cfg)
    problem, data, ref_inputs = cell.inputs.train_problem(cfg, pcfg, cell.seed, dev, cell.workdir)
    shapes = {k: tuple(v.shape) for k, v in problem.model.state_dict().items()}
    if shapes != ref.param_shapes(cfg):
        raise RuntimeError(f"{cfg['name']}: the program's parameters differ from the reference's")
    problem.model.load_state_dict(weights.make(shapes, ref.init_rule, cell.seed, dev))
    flavor = "keras" if problem.task.keras_adam else "adam"
    if flavor != cfg["optimizer"]:
        raise RuntimeError(f"{cfg['name']}: the program trains with {flavor}, not {cfg['optimizer']}")
    opt = loop.make_optimizer(problem.model.parameters(), pcfg.lr, flavor)
    state = loop.TrainState(problem.model, opt)
    total = pcfg.epochs * (pcfg.ntrain // pcfg.batch_size)
    train_epoch = loop.make_train_epoch(
        problem.task, loop.make_lr_schedule(pcfg.lr, total, warmup_steps=pcfg.warmup_steps))
    rows = Rows(cell.seed, pcfg.ntrain, pcfg.batch_size, dev)
    checked = rows.take(N_CHECKED)
    names = dict((id(p), n) for n, p in problem.model.named_parameters())
    state, first = train_epoch(state, problem.geom, data, checked[:1])
    b1 = opt.param_groups[0]["betas"][0]
    grad_norms = {names[id(p)]: s["exp_avg"].double().norm() / (1 - b1)
                  for p, s in opt.state.items() if "exp_avg" in s}
    state, rest = train_epoch(state, problem.geom, data, checked[1:])
    after = {n: p.detach().clone() for n, p in problem.model.named_parameters()}
    losses = torch.cat([first, rest])
    batches = [(ref_inputs["x"][r].clone(), ref_inputs["y"][r].clone()) for r in checked]
    ref_ctx_inputs = {k: v for k, v in ref_inputs.items() if k not in ("x", "y")}
    state, _ = train_epoch(state, problem.geom, data, rows.take(cell.mix["warm_steps"]))
    _sync(dev)
    return {"state": state, "problem": problem, "data": data, "rows": rows,
            "train_epoch": train_epoch, "total": total, "shapes": shapes,
            "losses": losses, "grad_norms": grad_norms, "after": after,
            "batches": batches, "ref_inputs": ref_ctx_inputs, "ref_x": ref_inputs["x"],
            "checked": checked}


def check(cell: harness.Cell, s: dict, prec: Precision | None = None, loss_fn=None,
          grad_fn=None) -> tuple:
    """The reference's three steps from the same weights on the same rows,
    against the program's (or, with ``prec``, against the reference's own
    steps in that precision, with ``loss_fn`` for its loss and ``grad_fn``
    on its gradients: the control, or a planted fault)."""
    no_tf32()
    ref, cfg, dev = cell.reference, cell.cfg, cell.device
    w0 = weights.make(s["shapes"], ref.init_rule, cell.seed, dev)
    ctx = ref.context(cfg, s["ref_inputs"])
    r_losses, r_grads, r_after = ref.train(cfg, w0, ctx, s["batches"], s["total"], Precision())
    if prec is None:
        p_losses = [float(v) for v in s["losses"].cpu()]
        p_grads = {k: float(v) for k, v in s["grad_norms"].items()}
        p_after = s["after"]
    else:
        p_losses, grads, p_after = ref.train(cfg, w0, ctx, s["batches"], s["total"], prec,
                                             loss_fn, grad_fn)
        p_grads = {k: float(v.double().norm()) for k, v in grads.items()}
    change = lambda after: {k: after[k] - w0[k] for k in w0}
    return checks.training(p_losses, r_losses, p_grads, r_grads, change(p_after),
                           change(r_after), _bandwidths(cell, s), ref.BANDWIDTH_FLOOR)


def _bandwidths(cell: harness.Cell, s: dict) -> list:
    return [k for k in s["shapes"] if k.endswith(cell.reference.BANDWIDTH_SUFFIX)]


def calibration(cell: harness.Cell) -> dict:
    """The numbers the limits' upper readings come from, at this cell's
    size, each with its notes: the control (the reference in TF32 in the
    program's place), the fault of half of the batch left out, and the
    fault of the bandwidths' gradients zeroed (a dscale kernel that returns
    nothing)."""
    s = prepare(cell)
    for k in ("state", "problem", "data", "train_epoch", "ref_x"):
        del s[k]
    zero = set(_bandwidths(cell, s))
    zeroed = lambda grads: {k: torch.zeros_like(v) if k in zero else v for k, v in grads.items()}
    return {"control": check(cell, s, Precision(tf32=True)),
            "half_batch": half_batch(cell, s),
            "bandwidth_grads_zeroed": check(cell, s, Precision(), grad_fn=zeroed)}


def half_batch(cell: harness.Cell, s: dict) -> tuple:
    """A fault planted in the reference put in the program's place: each
    step's loss over half of its batch, the mean taken over the rest (a
    batch-summed loss scaled up to the whole batch)."""
    plain = cell.reference.loss

    def loss(cfg, pred, y):
        n = pred.shape[0] // 2
        part = plain(cfg, pred[:n], y[:n])
        return part * pred.shape[0] / n if cell.reference.BATCH_SUMMED_LOSS else part

    return check(cell, s, Precision(), loss)


def _window(cell: harness.Cell, s: dict) -> tuple:
    """(steps, seconds): chunks of ``chunk_steps`` steps back to back until
    ``--seconds`` have passed, with one synchronisation, at the end."""
    problem, data, chunk = s["problem"], s["data"], cell.mix["chunk_steps"]
    steps = 0
    with trace.span(trace.WINDOW):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < cell.seconds:
            with trace.span("portbench.chunk"):
                s["state"], _ = s["train_epoch"](s["state"], problem.geom, data,
                                                 s["rows"].take(chunk))
            steps += chunk
        with trace.span("portbench.sync"):
            _sync(cell.device)
        elapsed = time.perf_counter() - t0
    return steps, elapsed


def run(cell: harness.Cell) -> harness.Outcome:
    s = prepare(cell)
    setup_s = time.perf_counter() - cell.t_start
    steps, elapsed = _window(cell, s)
    untraced_rows = s["rows"].taken[-steps:]
    notes = [f"steps {steps} in {elapsed:.4f} s"]
    rec = None
    if cell.trace:
        hooks = _span_hooks(s["problem"].model, s["state"].optimizer)
        with trace.profiled(True) as rec:
            t_steps, t_elapsed = _window(cell, s)
        for h in hooks:
            h.remove()
        notes.append(f"a step {1e3 * elapsed / steps:.4f} ms untraced, "
                     f"{1e3 * t_elapsed / t_steps:.4f} ms traced ({t_steps} steps)")
    peak = torch.cuda.max_memory_allocated() if torch.device(cell.device).type == "cuda" else 0
    win = None
    if rec is not None:
        tr = trace.Trace.from_events(trace.trace_events(rec.result))
        work = lambda rows: cell.work.window_work(cell.cfg, cell.reference, s["ref_inputs"],
                                                  s["ref_x"], rows, True)
        flops, _ = work(untraced_rows)
        _, bound = work(s["rows"].taken[-t_steps:])
        win = trace.Window(tr, t_steps, bound, flops, elapsed)
    for k in ("state", "problem", "data", "train_epoch", "ref_x"):
        del s[k]
    if torch.device(cell.device).type == "cuda":
        torch.cuda.empty_cache()
    numbers, check_notes = check(cell, s)
    notes.append(f"check {json.dumps(check_notes)}")
    return harness.Outcome(
        metrics={cell.mix["metric"]: (steps * cell.cfg["batch_size"] / elapsed, cell.mix["unit"]),
                 "setup_s": (setup_s, "s")},
        attempted=steps, failed=0, numbers=numbers, memory_peak_bytes=peak, window=win,
        notes=notes)
