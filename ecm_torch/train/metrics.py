"""Evaluation metrics (port of ``ecm_tpu/train/metrics.py``), over the valid
pixels of a batch (``0 < gt < max_disp``):

- EPE: mean ``|pred - gt|``;
- D1-all (KITTI 2015): the share of pixels with an error above 3 px and
  above 5 % of gt;
- k-px error rates (KITTI 2012): the share with an error above k px, k in
  {1, 2, 3};
- ``valid_px``: the number of valid pixels.
"""

from __future__ import annotations

import torch

from ecm_torch.train.loss import valid_mask


def disparity_metrics(pred: torch.Tensor, gt: torch.Tensor, max_disp: int = 192) -> dict[str, torch.Tensor]:
    """Every metric as an f32 scalar tensor on the inputs' device."""
    pred, gt = pred.float(), gt.float()
    mask = valid_mask(gt, max_disp).float()
    n = mask.sum().clamp_min(1.0)
    err = (pred - gt).abs()

    def frac(cond: torch.Tensor) -> torch.Tensor:
        return (cond.float() * mask).sum() / n

    return {
        "epe": (err * mask).sum() / n,
        "d1_all": frac((err > 3.0) & (err > 0.05 * gt)),
        "px1": frac(err > 1.0),
        "px2": frac(err > 2.0),
        "px3": frac(err > 3.0),
        "valid_px": mask.sum(),
    }
