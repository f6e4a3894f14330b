"""Batched inference traffic: ``Predictor.predict_array`` (host arrays in,
host arrays out, as ``infer`` runs it) over a fixed seeded set of
``n_fields`` input fields, again and again until ``--seconds`` have
passed. Fields answered over the whole window give ``infer_fields_per_s``.
A traced run then runs a second window of the same length under the
profiler, for the per-layer readers.

Set-up writes a checkpoint of the seeded weights under the run's TMPDIR,
builds the Predictor from it and warms it with ``warm_passes`` passes over
the set. The answers of ``sample`` fields drawn from the seed are kept
from every pass and held against the reference once the window has closed.

Mix parameters: ``n_fields``, ``warm_passes``, ``sample``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from portbench import checks, harness, seeds, trace, weights
from portbench.reference.common import Precision, no_tf32


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def prepare(cell: harness.Cell) -> dict:
    from position_induced_transformer_torch.train import checkpoint
    from position_induced_transformer_torch.train.evaluate import Predictor

    cfg, dev, ref = cell.cfg, cell.device, cell.reference
    pcfg = harness.program_config(cfg)
    n = cell.mix["n_fields"]
    path, x, ref_inputs = cell.inputs.infer_inputs(cfg, cell.seed, dev, cell.workdir, n)
    shapes = ref.param_shapes(cfg)
    ckpt = checkpoint.save(os.path.join(cell.workdir, "model.pt"),
                           weights.make(shapes, ref.init_rule, cell.seed, dev), cfg["name"])
    pred = Predictor(pcfg, ckpt, data_path=path, device=dev)
    for _ in range(cell.mix["warm_passes"]):
        pred.predict_array({"x": x})
    return {"pred": pred, "x": x, "sample": _sample(cell), "ref_inputs": ref_inputs,
            "shapes": shapes, "batch": pred._batch_size()}


def check(cell: harness.Cell, s: dict, answers: list, prec: Precision | None = None) -> tuple:
    """(numbers, notes): ``answer_gap`` of the kept answers (each pass's
    answers of the sampled fields) against the reference's; with ``prec``,
    the reference in that precision stands in for the program."""
    no_tf32()
    ref, cfg, dev = cell.reference, cell.cfg, cell.device
    w = weights.make(s["shapes"], ref.init_rule, cell.seed, dev)
    ctx = ref.context(cfg, s["ref_inputs"])
    xs = torch.from_numpy(s["x"][s["sample"]]).to(dev)
    with torch.no_grad():
        want = torch.cat([ref.predict(cfg, w, ctx, xs[i : i + 8], Precision())
                          for i in range(0, len(xs), 8)])
        if prec is not None:
            answers = [torch.cat([ref.predict(cfg, w, ctx, xs[i : i + 8], prec)
                                  for i in range(0, len(xs), 8)]).cpu().numpy()]
    pairs = [(torch.from_numpy(a[j]), want[j].cpu()) for a in answers for j in range(len(xs))]
    return {"answer_gap": checks.answers(pairs)}, {"answers": len(pairs)}


def calibration(cell: harness.Cell) -> dict:
    """The numbers the limits' upper readings come from, at this cell's
    size: the control, the reference in TF32 in the program's place,
    on the fields a run of this seed samples."""
    _, x, ref_inputs = cell.inputs.infer_inputs(cell.cfg, cell.seed, cell.device, cell.workdir,
                                                cell.mix["n_fields"])
    s = {"x": x, "sample": _sample(cell), "ref_inputs": ref_inputs,
         "shapes": cell.reference.param_shapes(cell.cfg)}
    return {"control": check(cell, s, [], Precision(tf32=True))}


def _sample(cell: harness.Cell) -> np.ndarray:
    n = cell.mix["n_fields"]
    return np.sort(seeds.rng(cell.seed, "sample").choice(n, cell.mix["sample"], replace=False))


def _window(cell: harness.Cell, s: dict, answers: list) -> tuple:
    """(passes, seconds): passes over the set until ``--seconds`` have
    passed; each pass's answers of the sampled fields go to ``answers``."""
    pred, x, sample = s["pred"], s["x"], s["sample"]
    passes = 0
    with trace.span(trace.WINDOW):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < cell.seconds:
            with trace.span("portbench.predict_array"):
                out = pred.predict_array({"x": x})
            answers.append(out[sample].copy())
            passes += 1
        elapsed = time.perf_counter() - t0
    return passes, elapsed


def run(cell: harness.Cell) -> harness.Outcome:
    s = prepare(cell)
    _sync(cell.device)
    setup_s = time.perf_counter() - cell.t_start
    answers = []
    passes, elapsed = _window(cell, s, answers)
    n = len(s["x"])
    notes = [f"passes {passes} of {n} fields in {elapsed:.4f} s"]
    rec = None
    if cell.trace:
        with trace.profiled(True) as rec:
            t_passes, t_elapsed = _window(cell, s, answers)
        notes.append(f"a pass {1e3 * elapsed / passes:.4f} ms untraced, "
                     f"{1e3 * t_elapsed / t_passes:.4f} ms traced ({t_passes} passes)")
    peak = torch.cuda.max_memory_allocated() if torch.device(cell.device).type == "cuda" else 0
    win = None
    if rec is not None:
        tr = trace.Trace.from_events(trace.trace_events(rec.result))
        b = s["batch"]
        one_pass = [torch.arange(i, min(i + b, n), device=cell.device) for i in range(0, n, b)]
        flops, bound = cell.work.window_work(cell.cfg, cell.reference, s["ref_inputs"],
                                             torch.from_numpy(s["x"]).to(cell.device),
                                             one_pass, False)
        win = trace.Window(tr, t_passes * len(one_pass), t_passes * bound, passes * flops,
                           elapsed)
    del s["pred"]
    if torch.device(cell.device).type == "cuda":
        torch.cuda.empty_cache()
    numbers, _ = check(cell, s, answers)
    return harness.Outcome(
        metrics={"infer_fields_per_s": (passes * n / elapsed, "fields/s"), "setup_s": (setup_s, "s")},
        attempted=passes * n, failed=0, numbers=numbers, memory_peak_bytes=peak, window=win,
        notes=notes)
