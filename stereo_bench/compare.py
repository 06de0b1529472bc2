"""The numbers that decide ``correct``: what the timed path produced against
the plain reference (``stereo_bench/reference/``), and the control that a
limit has to fail.

Serving: every pixel of the sampled answers, ``disp_mae_px`` (the mean
absolute disparity gap) and ``disp_p999_px`` (its 99.9th percentile).

Training, over the first three steps of the object the window then drives:
``loss_gap``, the largest relative gap of a step's loss; ``grad_gap``, the
first step's gradient as the optimizer got it (Adam's first moment after one
step over 1 - beta1), by the worst leaf: the gap between the program's norm
and the reference's, over the larger of the reference's norm of that leaf
and of the median leaf; ``change_gap``, the same of each parameter's change
over the three steps, leaving out leaves whose reference gradient is under a
thousandth of the median leaf's (the heads' last biases, whose gradient is 0
but for rounding, move under Adam by rounding alone); ``stats_gap``, the
same of the change of each BatchNorm running statistic over the three steps
(the batch statistics the forward folded in: a reading of the forward's
activations, layer by layer). Each ``*_median`` is the median leaf's gap.
"""

from __future__ import annotations

import statistics

import torch

NEGLIGIBLE_GRAD = 1e-3
PERCENTILE = 0.999


def serve_numbers(errors: list[torch.Tensor]) -> dict[str, float]:
    """``errors``: the absolute disparity gaps of the sampled answers."""
    e = torch.cat([x.flatten().double() for x in errors])
    k = max(1, int(round(PERCENTILE * e.numel())))
    return {"disp_mae_px": e.mean().item(), "disp_p999_px": e.kthvalue(k).values.item()}


def _leaf_gaps(prog: dict[str, torch.Tensor], ref: dict[str, torch.Tensor], names: list[str]) -> dict[str, float]:
    norms = {k: (torch.linalg.vector_norm(prog[k].double()).item(), torch.linalg.vector_norm(ref[k].double()).item())
             for k in names}
    median = statistics.median(r for _, r in norms.values())
    return {k: abs(p - r) / max(r, median) for k, (p, r) in norms.items()}


def train_numbers(prog: dict, ref: dict, start: dict[str, torch.Tensor], names: list[str]) -> dict:
    """``prog``/``ref``: ``losses`` of each step, ``first_grads``, and
    ``params`` and ``buffers`` (the BatchNorm running statistics) after the
    last step, by name; ``start``: the state before the first step;
    ``names``: the parameters."""
    loss_gaps = [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"], strict=True)]
    grad = _leaf_gaps(prog["first_grads"], ref["first_grads"], names)
    ref_norm = {k: torch.linalg.vector_norm(ref["first_grads"][k].double()).item() for k in names}
    floor = NEGLIGIBLE_GRAD * statistics.median(ref_norm.values())
    moved = [k for k in names if ref_norm[k] >= floor]
    change = lambda run: {k: run["params"][k].double() - start[k].double() for k in moved}  # noqa: E731
    moves = _leaf_gaps(change(prog), change(ref), moved)
    folded = lambda run: {k: v.double() - start[k].double() for k, v in run["buffers"].items()}  # noqa: E731
    stats = _leaf_gaps(folded(prog), folded(ref), sorted(ref["buffers"]))
    return {
        "numbers": {"loss_gap": max(loss_gaps), "loss_gap_first": loss_gaps[0],
                    "grad_gap": max(grad.values()), "grad_gap_median": statistics.median(grad.values()),
                    "change_gap": max(moves.values()), "change_gap_median": statistics.median(moves.values()),
                    "stats_gap": max(stats.values()), "stats_gap_median": statistics.median(stats.values())},
        "worst_leaf": {"grad_gap": max(grad, key=grad.get), "change_gap": max(moves, key=moves.get),
                       "stats_gap": max(stats, key=stats.get)},
        "left_out": sorted(set(names) - set(moved)),
        "losses": {"program": prog["losses"], "reference": ref["losses"]},
    }
