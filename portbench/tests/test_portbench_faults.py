"""The comparison fails what it must: a run of each cell at the tiny size
on the CPU, with the timed path broken underneath (the harness's look for
a chip skipped), comes out not correct, once for each fault the cell can
have; and the control, the reference in TF32 put in the program's place,
fails the limits. Sound runs of the same cells are correct."""

import pytest
import torch

from portbench import checks, harness
from portbench.tests.conftest import SEED, WORKLOADS, tiny


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_runs_are_correct(run_tiny, workload):
    res, _ = run_tiny(workload)
    assert res["correct"], res["checks"]


def _unchanged_state(monkeypatch):
    from position_induced_transformer_torch.train import loop

    noop = lambda self, closure=None: None
    monkeypatch.setattr(torch.optim.Adam, "step", noop)
    monkeypatch.setattr(loop.KerasAdam, "step", noop)


def _half_batch(monkeypatch):
    from position_induced_transformer_torch.train import loop

    plain = loop.Task.loss_fn

    def half(self, geom, batch):
        n = batch["x"].shape[0] // 2
        loss = plain(self, geom, {k: v[:n] for k, v in batch.items()})
        # the mean over the rest: a batch-summed loss scaled to the batch
        return loss if self.batch_mean_loss else loss * (2 * n) / n

    monkeypatch.setattr(loop.Task, "loss_fn", half)


def _bandwidth_grads_zeroed(monkeypatch):
    """A dscale that returns nothing: the bandwidths' gradients (the only
    parameters whose last two axes are 1: torch-family (H, 1, 1), TF-family
    (1, H, 1, 1)) zeroed before each update."""
    from position_induced_transformer_torch.train import loop

    for cls in (torch.optim.Adam, loop.KerasAdam):
        plain = cls.step

        def step(self, closure=None, plain=plain):
            for group in self.param_groups:
                for p in group["params"]:
                    if p.grad is not None and p.dim() >= 3 and p.shape[-2:] == (1, 1):
                        p.grad.zero_()
            return plain(self, closure)

        monkeypatch.setattr(cls, "step", step)


def _altered_answer(monkeypatch):
    from position_induced_transformer_torch.train import evaluate

    plain = evaluate.Predictor.predict_array

    def altered(self, *a, **k):
        out = plain(self, *a, **k).copy()
        out[:, 0, 0] += 0.1
        return out

    monkeypatch.setattr(evaluate.Predictor, "predict_array", altered)


FAULTS = [("cylinder.train", _unchanged_state), ("cylinder.train", _half_batch),
          ("cylinder.train", _bandwidth_grads_zeroed),
          ("elasticity_tf.train", _unchanged_state), ("elasticity_tf.train", _half_batch),
          ("elasticity_tf.train", _bandwidth_grads_zeroed), ("cylinder.infer", _altered_answer)]


@pytest.mark.parametrize("workload,fault", FAULTS, ids=[f"{w}-{f.__name__[1:]}" for w, f in FAULTS])
def test_a_fault_is_not_correct(run_tiny, monkeypatch, workload, fault):
    fault(monkeypatch)
    res, _ = run_tiny(workload)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_and_planted_faults_are_not_correct(workload):
    from portbench.calibrate import readings

    found = readings(workload, SEED, device="cpu", overrides=tiny(workload))
    assert "control" in found
    for what, (numbers, _) in found.items():
        ok, table = checks.judge(numbers, harness.limits(workload))
        assert not ok, (what, table)
