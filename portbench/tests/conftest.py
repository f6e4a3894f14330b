"""Shared settings of the benchmark's CPU tests: the cells at a size a
test run holds (every width and count cut; the CPU runs the port's plain
versions of its kernels)."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

TINY = {
    "cylinder": {"model.hid_dim": 16, "inputs.n_points": 300, "inputs.n_latent": 64,
                 "batch_size": 4, "ntrain": 40, "model.en_loc": 0.05, "model.de_loc": 0.05},
    "elasticity_tf": {"model.hid_dim": 32, "model.n_head": 4, "inputs.n_points": 200,
                      "batch_size": 4, "ntrain": 24, "ntest": 4, "model.en_loc": 5.0,
                      "model.de_loc": 5.0},
}
MIX = {"cylinder.infer": {"mix.n_fields": 10, "mix.sample": 4}}
# the cells of BENCHMARK.json
WORKLOADS = ("cylinder.train", "elasticity_tf.train", "cylinder.infer")
SEED = 2**35 + 11


def tiny(workload: str) -> dict:
    return {**TINY[workload.split(".")[0]], **MIX.get(workload, {})}


@pytest.fixture
def run_tiny():
    """run_tiny(workload, seed=SEED, seconds=1.0, trace=0) -> (result, lines)
    on the CPU at the tiny size."""
    import time

    from portbench import run

    def go(workload, seed=SEED, seconds=1.0, trace=0):
        return run.run_cell(workload, seed, seconds, trace, device="cpu",
                            overrides=tiny(workload), t_start=time.perf_counter())

    return go
