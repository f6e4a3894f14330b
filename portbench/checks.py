"""The numbers that decide ``correct``: what the timed path produced against
the plain reference, each beside its limit (``limits/<workload>.json``).

Training (the first three steps of the object the window then drives):

- ``loss_gap``: the largest relative gap between the program's and the
  reference's loss over the three steps;
- ``grad_gap``: the first gradient as the optimizer got it (its first
  moment after one step over ``1 - beta1``), by the worst leaf: the gap
  between the norms, over the larger of the reference's norm of that leaf
  and of the median leaf;
- ``change_gap``: the parameters' change over the three steps, taken as
  ``grad_gap``, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (a leaf with a gradient nought to
  rounding moves under Adam by round-off alone);
- ``bandwidth_grad_gap``: the bandwidths' first gradients (the dscale
  outputs of the position attention ops), each leaf's gap between the
  norms over the larger of its own reference norm and ``floor`` times the
  median leaf's, worst leaf. ``grad_gap`` holds a leaf only as far as it
  stands out against the median leaf, which a bandwidth's gradient often
  does not. The reference family gives the floor (``BANDWIDTH_FLOOR``):
  the scale below which its ops' rounding swamps a bandwidth's gradient.

Answers (inference): ``answer_gap``, the largest relative L2
distance of an answer from the reference's over a sample of the answers.
"""

from __future__ import annotations

import statistics


def _norms(tensors: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def _worst(prog: dict, ref: dict, keys) -> tuple:
    keys = list(keys)
    if not keys:
        return 0.0, None
    floor = statistics.median(ref[k] for k in keys)
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30) for k in keys}
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def training(prog_losses, ref_losses, prog_grad_norms: dict, ref_grads: dict,
             prog_change: dict, ref_change: dict, bandwidths=(), floor: float = 0.0) -> tuple:
    """(numbers, notes): ``prog_grad_norms`` and the changes' norms are per
    leaf; a leaf the program's optimizer never reached reads as missing.
    ``bandwidths`` names the leaves ``bandwidth_grad_gap`` holds, by their
    own norm or ``floor`` times the median leaf's. The notes give, for each
    of them, its reference gradient's norm over the median leaf's and the
    gap of its gradient's norm over its own reference norm."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog_losses, ref_losses))
    if len(prog_losses) != len(ref_losses):
        loss_gap = float("inf")
    g_ref = _norms(ref_grads)
    g_prog = {k: prog_grad_norms.get(k, float("inf")) for k in g_ref}
    grad_gap, g_leaf = _worst(g_prog, g_ref, g_ref)
    g_floor = statistics.median(g_ref.values())
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * g_floor]
    c_ref, c_prog = _norms(ref_change), _norms(prog_change)
    change_gap, c_leaf = _worst(c_prog, c_ref, moved)
    own = lambda k: abs(g_prog[k] - g_ref[k]) / max(g_ref[k], 1e-30)
    bw_gap = max((abs(g_prog[k] - g_ref[k]) / max(g_ref[k], floor * g_floor, 1e-30)
                  for k in bandwidths), default=0.0)
    notes = {"grad_gap_leaf": g_leaf, "change_gap_leaf": c_leaf,
             "leaves_left_out_of_change": sorted(set(g_ref) - set(moved)),
             "bandwidths": {k: [g_ref[k] / g_floor, own(k)] for k in sorted(bandwidths)}}
    numbers = {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}
    if bandwidths:
        numbers["bandwidth_grad_gap"] = bw_gap
    return numbers, notes


def answers(pairs) -> float:
    """``answer_gap`` over (program answer, reference answer) pairs of
    tensors of one shape each."""
    worst = 0.0
    for got, want in pairs:
        got, want = got.double(), want.double()
        worst = max(worst, float((got - want).norm() / want.norm()))
    return worst


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or below its
    limit, and a limit for every number."""
    table = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    ok = all(row["limit"] is not None and row["value"] <= row["limit"] for row in table.values())
    return ok, table
