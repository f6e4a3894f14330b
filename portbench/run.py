"""Run one cell of the port's benchmark once, on the chips of this machine.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is an entry of ``workloads`` in
``BENCHMARK.json``; its configuration, traffic mix, traffic kind, limits
and per-layer readers are files under ``portbench/`` found by name (see
``harness.py``). Inputs and weights are made from ``--seed``. Set-up
(the kernels' first build included) is timed from the process's start to
the first timed unit of work; then the window runs for ``--seconds``;
then what the window produced is held against the plain reference.

Standard error ends with each number compared and its limit; the last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer metrics), ``device`` (with ``--trace 1`` also
``busy_s`` and ``window_s``), with ``--trace 1`` ``breakdown``, and last
``checks``. Without a CUDA device, or with fewer than the cell asks for,
it prints no result and exits with 2; if JAX or the JAX package was
loaded, with 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import checks, harness  # noqa: E402


def reported(metric: dict, workload: str, bench: dict) -> bool:
    """Whether a per-layer metric is read in this cell: listed in its
    ``workloads``, or, without that key, in every cell that reports the
    end-to-end metric it moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    moved = next(m for m in bench["end_to_end"] if m["name"] == metric["moves"])
    return "workloads" not in moved or workload in moved["workloads"]


@contextlib.contextmanager
def cell_of(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
            overrides: dict | None = None, t_start: float | None = None):
    """The :class:`harness.Cell` of one run, with a working directory under
    the run's TMPDIR that is removed when the block ends. ``overrides``
    (tests and calibration only) changes keys of the configuration file,
    and of the traffic mix where a key starts with ``mix.``."""
    bench = harness.manifest()
    wl = harness.workload(workload, bench)
    mix = harness.mix(wl["traffic"])
    overrides = dict(overrides or {})
    for key in [k for k in overrides if k.startswith("mix.")]:
        mix[key[4:]] = overrides.pop(key)
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        yield harness.Cell(wl, harness.config(wl["config"], overrides), mix,
                           harness.limits(workload), int(seed), float(seconds), bool(trace),
                           device, T_START if t_start is None else t_start, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides: dict | None = None, t_start: float | None = None) -> tuple:
    """(result dict, lines for standard error) of one run."""
    bench = harness.manifest()
    with cell_of(workload, seed, seconds, trace, device, overrides, t_start) as cell:
        outcome = harness.module("traffic", cell.mix["kind"]).run(cell)
    wl = cell.workload
    correct, table = checks.judge(outcome.numbers, cell.limits)
    dev = {"platform": "gpu" if device == "cuda" else device, "kind": _device_name(device),
           "count": wl["chips"], "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    result = {"correct": correct, "attempted": int(outcome.attempted),
              "failed": int(outcome.failed), "metrics": {}, "device": dev}
    if not trace:
        result["metrics"] = {k: {"value": v, "unit": u} for k, (v, u) in outcome.metrics.items()}
    else:
        units = {m["name"]: m["unit"] for m in bench["per_layer"]}
        for m in bench["per_layer"]:
            if reported(m, workload, bench):
                v = harness.reader(m["name"]).read(outcome.window)
                if v is not None:
                    result["metrics"][m["name"]] = {"value": v, "unit": units[m["name"]]}
        w = outcome.window
        if w is not None and w.trace is not None:
            dev["busy_s"], dev["window_s"] = w.trace.busy_s(), w.trace.window_s
            result["breakdown"] = w.trace.breakdown()
    # json has no infinity: a missing answer's gap is written as a string
    plain = lambda v: v if v is None or math.isfinite(v) else str(v)
    result["checks"] = {k: {n: plain(v) for n, v in row.items()} for k, row in table.items()}
    lines = list(outcome.notes)
    lines += [f"{k} {v['value']!r} limit {v['limit']!r}" for k, v in table.items()]
    return result, lines


def _device_name(device: str) -> str:
    import torch

    return torch.cuda.get_device_name(0) if device == "cuda" else device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    wl = harness.workload(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = harness.jax_modules()
    if found:
        print(f"loaded modules of JAX or the JAX package: {found}", file=sys.stderr)
        return 3
    from portbench import peaks

    print(f"card {peaks.card()}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
