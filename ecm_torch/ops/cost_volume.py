"""4D cost-volume construction (port of ``ecm_tpu/ops/cost_volume.py``).

``use_pallas`` keeps its JAX name so that configurations map one to one; in
the port it selects the hand-written CUDA kernel
(``ecm_torch.ops.cuda_cost_volume``) for the concat volume.
"""

from __future__ import annotations

import torch

from ecm_torch.ops.cuda_cost_volume import cost_volume_concat, cost_volume_concat_torch


def cost_volume_correlation_torch(
    fl: torch.Tensor, fr: torch.Tensor, max_disp: int
) -> torch.Tensor:
    """Correlation volume ``[B, D, H, W, 1]``: mean over C of ``fl * fr``
    shifted by d, zero for columns ``w < d``."""
    b, h, w, _ = fl.shape
    out = fl.new_zeros(b, max_disp, h, w, 1)
    for d in range(min(max_disp, w)):
        out[:, d, :, d:] = (fl[:, :, d:] * fr[:, :, : w - d]).mean(-1, keepdim=True)
    return out


def cost_volume(
    fl: torch.Tensor,
    fr: torch.Tensor,
    max_disp: int,
    mode: str = "concat",
    use_pallas: bool = False,
) -> torch.Tensor:
    """Build the NDHWC cost volume from ``[B, H, W, C]`` features (1/4
    resolution), for every aggregation layout (the JAX package's grouped
    builders emit the same volume disparity-folded).

    ``use_pallas=True`` with ``mode="concat"`` runs the CUDA kernel."""
    if mode not in ("concat", "correlation"):
        raise ValueError(f"unknown cost-volume mode: {mode!r}")
    if use_pallas:
        if mode == "correlation":
            raise NotImplementedError(
                "no CUDA kernel for the correlation volume yet: ROADMAP queue "
                "2, cost_volume_pallas(mode='correlation')"
            )
        return cost_volume_concat(fl, fr, max_disp)
    if mode == "concat":
        return cost_volume_concat_torch(fl, fr, max_disp)
    return cost_volume_correlation_torch(fl, fr, max_disp)
