"""The traffic kinds know no model family: each takes its configuration's
reference, work counts and inputs by name through the cell, so a cell of
another family, or of a family not yet in the benchmark, needs new files
only."""

import tempfile
import time
import types

import pytest

from portbench import checks, harness
from portbench.tests.conftest import SEED, TINY


def _cell(cls, workload: dict, cfg: dict, mix: dict, limits: dict, workdir: str, trace=True):
    return cls(workload, cfg, mix, limits, SEED, 0.5, trace, "cpu", time.perf_counter(), workdir)


def test_the_traffic_kinds_name_no_family():
    families = {harness.config(c["name"])["family"] for c in harness.manifest()["configs"]}
    for path in (harness.HERE / "traffic").glob("*.py"):
        text = path.read_text()
        assert '["family"]' not in text, path.name
        assert not any(f'"{f}"' in text for f in families), path.name


def test_a_point_cloud_inference_cell_runs_on_the_sweep():
    """elasticity_tf through ``infer_sweep``, traced: a TF-family
    inference cell would be a workload entry, a mix and limits."""
    wl = {"name": "elasticity_tf.infer", "config": "elasticity_tf",
          "traffic": "infer_sweep_2000", "chips": 1}
    mix = {**harness.mix("infer_sweep_2000"), "n_fields": 6, "sample": 3}
    cfg = harness.config("elasticity_tf", TINY["elasticity_tf"])
    with tempfile.TemporaryDirectory() as workdir:
        cell = _cell(harness.Cell, wl, cfg, mix, {"answer_gap": 1e-5}, workdir)
        outcome = harness.module("traffic", "infer_sweep").run(cell)
    ok, table = checks.judge(outcome.numbers, cell.limits)
    assert ok, table
    w = outcome.window
    assert w.flops > 0 and w.posatt_bound_s > 0 and w.untraced_s > 0
    assert harness.reader("mfu.infer").read(w) > 0


@pytest.mark.parametrize("kind,traffic,workload_name",
                         [("train_loop", "train", "stub.train"),
                          ("infer_sweep", "infer_sweep_2000", "stub.infer")])
def test_a_third_family_runs_through_both_generators(kind, traffic, workload_name):
    """A family the benchmark does not have (the torch family's reference
    and inputs under another name, with work counts of its own) through
    each traffic kind, traced: the kind calls the family's
    ``window_work`` and the readers read what it returns."""
    from portbench.inputs import cylinder
    from portbench.reference import pit

    calls = []

    def window_work(cfg, ref, ref_inputs, x, batches, train):
        calls.append((len(batches), [len(r) for r in batches], train))
        return 1e9 * len(batches), 1e-6 * len(batches)

    class StubCell(harness.Cell):
        reference = property(lambda self: pit)
        work = property(lambda self: types.SimpleNamespace(window_work=window_work))
        inputs = property(lambda self: cylinder)

    cfg = harness.config("cylinder", TINY["cylinder"])
    cfg["family"] = "stub_family"
    mix = harness.mix(traffic)
    if kind == "infer_sweep":
        mix = {**mix, "n_fields": 10, "sample": 4}
    wl = {"name": workload_name, "config": "cylinder", "traffic": traffic, "chips": 1}
    limits = harness.limits("cylinder.train" if kind == "train_loop" else "cylinder.infer")
    with tempfile.TemporaryDirectory() as workdir:
        cell = _cell(StubCell, wl, cfg, mix, limits, workdir)
        outcome = harness.module("traffic", kind).run(cell)
    ok, table = checks.judge(outcome.numbers, limits)
    assert ok, table
    w = outcome.window
    B = cfg["batch_size"]
    if kind == "train_loop":
        # the untraced window's steps, then the traced window's
        (n_untraced, sizes, train), (n_traced, _, _) = calls
        assert train and set(sizes) == {B}
        assert n_untraced == outcome.attempted and w.units == n_traced
        assert w.flops == 1e9 * n_untraced and w.posatt_bound_s == pytest.approx(1e-6 * n_traced)
    else:
        # one pass's device batches, scaled by the passes of each window
        ((n_batches, sizes, train),) = calls
        assert not train and sum(sizes) == 10 and n_batches == len(sizes)
        assert w.flops == 1e9 * n_batches * outcome.attempted // 10
    assert harness.reader("mfu.train").read(w) > 0
