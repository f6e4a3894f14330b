"""Each cell at its own size on the card, with a short window: the run is
correct and its result names the card. Skips without a CUDA device (the
look is made inside the fixture, never at import)."""

import time

import pytest

from portbench.tests.conftest import WORKLOADS


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.cuda.get_device_name(0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_cell_at_its_size_on_the_card(card, workload):
    from portbench import run

    res, lines = run.run_cell(workload, 2**31 + 977, 2.0, False, t_start=time.perf_counter())
    assert res["correct"], lines
    assert res["device"]["kind"] == card and res["device"]["platform"] == "gpu"
    assert res["attempted"] > 0 and res["failed"] == 0
