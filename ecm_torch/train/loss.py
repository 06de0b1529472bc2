"""Training loss (port of ``ecm_tpu/train/loss.py``): masked smooth-L1 over
valid ground-truth pixels (``0 < gt < max_disp``), summed over the stage
outputs with weights 0.5, 0.7, 1.0 (a single prediction: weight 1.0).

Smooth-L1 with beta 1 (torch's ``F.smooth_l1_loss``): ``0.5 x^2`` for
``|x| < 1``, else ``|x| - 0.5``, averaged over the masked pixels, in f32.
"""

from __future__ import annotations

import torch

STAGE_WEIGHTS = (0.5, 0.7, 1.0)


def smooth_l1(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def masked_smooth_l1(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean smooth-L1 over ``mask``-valid pixels (0 if none is valid)."""
    mask = mask.float()
    per_px = smooth_l1(pred.float() - gt.float())
    return (per_px * mask).sum() / mask.sum().clamp_min(1.0)


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
    if len(preds) == 1:
        return masked_smooth_l1(preds[0], gt, mask)
    if len(preds) != len(weights):
        raise ValueError(f"{len(preds)} predictions for {len(weights)} stage weights")
    return sum(w * masked_smooth_l1(p, gt, mask) for w, p in zip(weights, preds))
