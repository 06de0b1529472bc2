"""Training loss (port of ``ecm_tpu/train/loss.py``): masked smooth-L1 over
valid ground-truth pixels (``0 < gt < max_disp``), summed over the stage
outputs with weights 0.5, 0.7, 1.0 (a single prediction: weight 1.0).

Smooth-L1 with beta 1 (torch's ``F.smooth_l1_loss``): ``0.5 x^2`` for
``|x| < 1``, else ``|x| - 0.5``, averaged over the masked pixels, in f32.

Under a mesh of more than one rank (``ecm_torch.parallel.use_mesh``) the
mean is the global batch's, as ``ecm_tpu``'s is over a sharded batch: the
valid-pixel count is summed over the ranks (no gradient), and each rank
returns its own sum over ``count / ranks``, so that the ranks' mean of
gradients, which the data-parallel step takes, is the gradient of the
global mean. The global loss is then the ranks' mean of the returned values.
"""

from __future__ import annotations

import torch

from ecm_torch.parallel.sharding import reduction_mesh

STAGE_WEIGHTS = (0.5, 0.7, 1.0)


def smooth_l1(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def masked_smooth_l1(
    pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor, denom: torch.Tensor | None = None
) -> torch.Tensor:
    """Mean smooth-L1 over ``mask``-valid pixels (0 if none is valid);
    ``denom``: the divisor in place of the valid count (``stereo_loss``'s
    share of the global count under a mesh)."""
    mask = mask.float()
    per_px = smooth_l1(pred.float() - gt.float())
    return (per_px * mask).sum() / (mask.sum().clamp_min(1.0) if denom is None else denom)


def _denominator(mask: torch.Tensor) -> torch.Tensor | None:
    """Under a mesh of more than one rank, the global valid count (at least
    1) over the ranks; else None."""
    mesh = reduction_mesh()
    if mesh is None:
        return None
    return mesh.sum(mask.float().sum()).clamp_min(1.0) / mesh.data


def valid_mask(gt: torch.Tensor, max_disp: int) -> torch.Tensor:
    """0 < gt < max_disp (0 encodes missing ground truth)."""
    return (gt > 0.0) & (gt < float(max_disp))


def stereo_loss(
    preds: list[torch.Tensor],
    gt: torch.Tensor,
    max_disp: int,
    weights: tuple[float, ...] = STAGE_WEIGHTS,
) -> torch.Tensor:
    """Weighted multi-stage masked smooth-L1 (a single stage: weight 1.0)."""
    mask = valid_mask(gt, max_disp)
    denom = _denominator(mask)
    if len(preds) == 1:
        return masked_smooth_l1(preds[0], gt, mask, denom)
    if len(preds) != len(weights):
        raise ValueError(f"{len(preds)} predictions for {len(weights)} stage weights")
    return sum(w * masked_smooth_l1(p, gt, mask, denom) for w, p in zip(weights, preds))
