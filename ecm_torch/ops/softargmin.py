"""Soft-argmin disparity regression: ``sum_d d * softmax(-cost)_d`` in f32."""

from __future__ import annotations

import torch


def softargmin(cost: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Expected index along ``dim`` under ``softmax(-cost)``, f32."""
    cost = cost.float()
    p = torch.softmax(-cost, dim=dim)
    shape = [1] * cost.ndim
    shape[dim] = cost.shape[dim]
    idx = torch.arange(cost.shape[dim], dtype=torch.float32, device=cost.device)
    return (p * idx.reshape(shape)).sum(dim=dim)


def disparity_regression(cost: torch.Tensor, max_disp: int) -> torch.Tensor:
    """Disparity ``[B, H, W]`` from a full-resolution ``[B, D, H, W]`` cost."""
    if cost.shape[1] != max_disp:
        raise ValueError(f"cost D axis {cost.shape[1]} != max_disp {max_disp}")
    return softargmin(cost, dim=1)
