"""Readings the benchmark's limits are set from, on the chips of this
machine (not run by the benchmark's own runs):

    python3 portbench/calibrate.py upper --workload <name> --seeds <a,b,c>
    python3 portbench/calibrate.py lower --workload <name> --seeds <a,b,...> [--seconds s]

``upper``: for each seed, one JSON line with the numbers (and notes) of
the control (the plain reference in TF32 in the program's place) and of
each fault planted in the reference that the cell's traffic kind reads
(``calibration`` of ``traffic/<kind>.py``), at the cell's own size.

``lower``: for each seed, one JSON line with a run of the cell (a short
window, ``--seconds``, 2 by default) as the benchmark makes it: the
numbers compared and the lines it writes to standard error. All seeds run
in one process, so the set-up of the process is paid once.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness, run  # noqa: E402


def readings(workload: str, seed: int, device: str = "cuda", overrides: dict | None = None) -> dict:
    """{"control": (numbers, notes), <fault>: (numbers, notes), ...} of one
    seed."""
    seconds = harness.manifest()["run_seconds"]
    with run.cell_of(workload, seed, seconds, False, device, overrides) as cell:
        return harness.module("traffic", cell.mix["kind"]).calibration(cell)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("upper", "lower"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if args.what == "upper":
            out = {"readings": readings(args.workload, seed)}
        else:
            res, lines = run.run_cell(args.workload, seed, args.seconds, False, t_start=t0)
            out = {"correct": res["correct"], "checks": res["checks"], "notes": lines}
        print(json.dumps({"workload": args.workload, "seed": seed, **out,
                          "seconds": time.perf_counter() - t0}), flush=True)
    found = harness.jax_modules()
    if found:
        print(f"loaded modules of JAX or the JAX package: {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
