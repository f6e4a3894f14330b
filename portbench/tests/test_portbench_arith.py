"""The idle, roofline and MFU arithmetic on made-up traces and windows,
and the comparison's numbers on made-up readings."""

import math

import pytest
import torch

from portbench import checks, harness, peaks, trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def _trace():
    ev = [
        (CPU, 0.0, 1000.0, trace.WINDOW, True),
        (CPU, 0.0, 400.0, "portbench.forward", True),
        (CPU, 400.0, 1000.0, "portbench.optimizer", True),
        (CUDA, 0.0, 400.0, "portbench.forward", True),  # a device-side annotation
        (CUDA, 10.0, 110.0, "void (anonymous namespace)::fwd_kernel<1>(Args)", False),
        (CUDA, 100.0, 200.0, "ampere_sgemm_128x64_nn", False),
        (CUDA, 300.0, 350.0, "Memcpy HtoD (Pageable -> Device)", False),
        (CUDA, 600.0, 700.0, "void (anonymous namespace)::bwd_kernel<true>(Args)", False),
        (CUDA, 990.0, 1100.0, "vectorized_elementwise_kernel", False),
        (CPU, 5.0, 6.0, "aten::mm", False),
    ]
    return trace.Trace.from_events(ev)


def test_busy_union_gaps_and_spans():
    tr = _trace()
    assert tr.window_s == pytest.approx(1e-3)
    # [10, 200] + [300, 350] + [600, 700] + [990, 1000]: 350 us busy
    assert tr.busy_s() == pytest.approx(350e-6)
    assert len(tr.kernels()) == 4 and len(tr.memcpys()) == 1 and len(tr.gemms()) == 1
    assert trace.gaps([(10, 200), (300, 350)], 0, 400) == [(0, 10), (200, 300), (350, 400)]
    assert tr.open_span(250.0) == "portbench.forward"
    assert tr.open_span(500.0) == "portbench.optimizer"
    b = tr.breakdown()
    idle = dict(b["idle_gaps"])
    # each gap is named by the span open where it begins: [0, 10], [200,
    # 300] and [350, 600] begin in the forward, [700, 990] in the update
    assert idle["portbench.forward"] == pytest.approx((10 + 100 + 250) * 1e-6)
    assert idle["portbench.optimizer"] == pytest.approx(290e-6)
    assert b["device_ops"][0][1] == pytest.approx(100e-6)


def test_readers_on_a_made_up_window():
    tr = _trace()
    # the untraced window: half the peak's operations over 2 ms
    w = trace.Window(tr, units=2, posatt_bound_s=100e-6, flops=0.5 * 67e12 * 2e-3,
                     untraced_s=2e-3)
    read = lambda name: harness.reader(name).read(w)
    assert read("mfu.train") == pytest.approx(50.0)
    assert read("device_idle_pct.train") == pytest.approx(65.0)
    assert read("launches_per_step.train") == pytest.approx(2.0)
    assert read("gemm_ms_per_step.train") == pytest.approx(0.05)
    # #1 and #4's 200 us against a bound of 100 us
    assert read("posatt_roofline.train") == pytest.approx(50.0)
    # #11/#12 did not run: nothing to read
    assert read("posatt_roofline.train_tf") is None
    assert read("memcpy_ms_per_batch.infer") == pytest.approx(0.025)
    # a metric split by the end-to-end metric it moves shares its stem's reader
    assert harness.reader("mfu.train_tf") is harness.reader("mfu.infer")
    assert harness.reader("posatt_roofline.infer") is not harness.reader("posatt_roofline.train")


def test_a_window_without_device_work_reads_nothing():
    ev = [(CPU, 0.0, 10.0, trace.WINDOW, True)]
    w = trace.Window(trace.Trace.from_events(ev), 3, 1e-3, 0.0, 1.0)
    for name in ("mfu.train", "posatt_roofline.train", "device_idle_pct.train",
                 "launches_per_step.train", "gemm_ms_per_step.train", "memcpy_ms_per_batch.infer"):
        assert harness.reader(name).read(w) is None
    assert harness.reader("mfu.infer").read(None) is None


def test_bound():
    assert peaks.bound_s(67e12, 1.0) == pytest.approx(1.0)
    assert peaks.bound_s(1.0, 3.35e12) == pytest.approx(1.0)


def test_training_numbers():
    ref_grads = {"a": torch.ones(4), "b": torch.full((4,), 2.0), "c": torch.full((4,), 1e-9)}
    g_ref = {k: float(v.norm()) for k, v in ref_grads.items()}
    prog = {k: v * 1.01 for k, v in g_ref.items()}
    change = {k: torch.ones(3) for k in ref_grads}
    nums, notes = checks.training([1.0, 2.0], [1.0, 2.0 * (1 + 1e-6)], prog, ref_grads,
                                  change, change)
    assert nums["loss_gap"] == pytest.approx(1e-6, rel=1e-3)
    assert nums["grad_gap"] == pytest.approx(0.01, rel=1e-6)
    assert nums["change_gap"] == 0.0
    assert notes["leaves_left_out_of_change"] == ["c"]
    # a bandwidth leaf: its gradient over the median leaf's, and its own gap
    nums, notes = checks.training([1.0], [1.0], prog, ref_grads, change, change, ["c"])
    ratio, own = notes["bandwidths"]["c"]
    assert ratio == pytest.approx(1e-9) and own == pytest.approx(0.01, rel=1e-6)
    assert nums["bandwidth_grad_gap"] == pytest.approx(0.01, rel=1e-6)
    # held against a floor times the median leaf's gradient where its own is
    # smaller: its gap of 2e-11 over 1e-3 x 2
    nums, _ = checks.training([1.0], [1.0], prog, ref_grads, change, change, ["c"], 1e-3)
    assert nums["bandwidth_grad_gap"] == pytest.approx(2e-11 / 2e-3, rel=1e-6)
    # a leaf the optimizer never reached
    nums, _ = checks.training([1.0], [1.0], {}, ref_grads, change, change)
    assert math.isinf(nums["grad_gap"])
    # a step that left the state unchanged reads 1
    zero = {k: torch.zeros(3) for k in ref_grads}
    nums, _ = checks.training([1.0], [1.0], prog, ref_grads, zero, change)
    assert nums["change_gap"] == pytest.approx(1.0)


def test_answers_and_judge():
    want = torch.ones(2, 5)
    assert checks.answers([(want.clone(), want)]) == 0.0
    got = want.clone()
    got[0, 0] = 1.1
    assert checks.answers([(got, want)]) == pytest.approx(0.1 / math.sqrt(10))
    ok, table = checks.judge({"x": 1e-6, "y": 2.0}, {"x": 1e-5, "y": 1.0})
    assert not ok and table["x"] == {"value": 1e-6, "limit": 1e-5}
    assert checks.judge({"x": float("nan")}, {"x": 1.0})[0] is False
    assert checks.judge({"x": 0.5}, {})[0] is False
