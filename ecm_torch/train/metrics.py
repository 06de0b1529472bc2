"""Evaluation metrics (port of ``ecm_tpu/train/metrics.py``), over the valid
pixels of a batch (``0 < gt < max_disp``):

- EPE: mean ``|pred - gt|``;
- D1-all (KITTI 2015): the share of pixels with an error above 3 px and
  above 5 % of gt;
- k-px error rates (KITTI 2012): the share with an error above k px, k in
  {1, 2, 3};
- ``valid_px``: the number of valid pixels.

Under a mesh of more than one rank (``ecm_torch.parallel.use_mesh``) the
sums and the count are summed over the ranks first, so every rank gets the
global batch's metrics, as ``ecm_tpu``'s sharded step returns them.
"""

from __future__ import annotations

import torch

from ecm_torch.parallel.sharding import reduction_mesh
from ecm_torch.train.loss import valid_mask


def disparity_metrics(pred: torch.Tensor, gt: torch.Tensor, max_disp: int = 192) -> dict[str, torch.Tensor]:
    """Every metric as an f32 scalar tensor on the inputs' device."""
    pred, gt = pred.float(), gt.float()
    mask = valid_mask(gt, max_disp).float()
    err = (pred - gt).abs()
    conds = {"d1_all": (err > 3.0) & (err > 0.05 * gt), "px1": err > 1.0, "px2": err > 2.0, "px3": err > 3.0}
    sums = torch.stack([(err * mask).sum(), *((c.float() * mask).sum() for c in conds.values()), mask.sum()])
    mesh = reduction_mesh()
    if mesh is not None:
        sums = mesh.sum(sums)
    n = sums[-1].clamp_min(1.0)
    return {"epe": sums[0] / n, **{k: sums[i + 1] / n for i, k in enumerate(conds)}, "valid_px": sums[-1]}
