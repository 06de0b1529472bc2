"""4D cost-volume construction (port of ``ecm_tpu/ops/cost_volume.py``).

``use_pallas`` keeps its JAX name so that configurations map one to one; in
the port it selects the hand-written CUDA kernels
(``ecm_torch.ops.cuda_cost_volume``) for both volumes.
"""

from __future__ import annotations

import torch

from ecm_torch.ops.cuda_cost_volume import (
    cost_volume_concat,
    cost_volume_concat_torch,
    cost_volume_correlation,
    cost_volume_correlation_torch,
)


def cost_volume(
    fl: torch.Tensor,
    fr: torch.Tensor,
    max_disp: int,
    mode: str = "concat",
    use_pallas: bool = False,
    d_start: int = 0,
) -> torch.Tensor:
    """Build the NDHWC cost volume from ``[B, H, W, C]`` features (1/4
    resolution), for every aggregation layout (the JAX package's grouped
    builders emit the same volume disparity-folded): ``max_disp`` planes
    from disparity ``d_start`` (a rank's range under disparity sharding).

    ``use_pallas=True`` runs the mode's CUDA kernel (differentiable)."""
    if mode not in ("concat", "correlation"):
        raise ValueError(f"unknown cost-volume mode: {mode!r}")
    if use_pallas:
        kernel = cost_volume_concat if mode == "concat" else cost_volume_correlation
        return kernel(fl, fr, max_disp, d_start)
    if mode == "concat":
        return cost_volume_concat_torch(fl, fr, max_disp, d_start)
    return cost_volume_correlation_torch(fl, fr, max_disp, d_start)
