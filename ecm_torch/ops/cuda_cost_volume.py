"""Concat cost volume: the plain builder and the wrapper of its CUDA kernel
(``ecm_torch/csrc/cost_volume.cu``; replaces ``cost_volume_pallas`` concat).

``[B, H, W, C]`` x2 -> ``[B, D, H, W, 2C]``: column ``w`` pairs the left
feature at ``w`` with the right feature at ``w - d``; columns ``w < d`` are
zero in both halves.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ecm_torch.kernels.build import check, library


def cost_volume_concat_torch(fl: torch.Tensor, fr: torch.Tensor, max_disp: int) -> torch.Tensor:
    """Plain PyTorch concat volume (the CPU path and the kernel's reference)."""
    b, h, w, c = fl.shape
    out = fl.new_zeros(b, max_disp, h, w, 2 * c)
    for d in range(min(max_disp, w)):
        out[:, d, :, d:, :c] = fl[:, :, d:]
        out[:, d, :, d:, c:] = fr[:, :, : w - d]
    return out


@functools.cache
def _kernel():
    fn = library("cost_volume").ecm_cost_volume_concat
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, i, i, i, i, i, vp]
    fn.restype = ctypes.c_int
    return fn


def cost_volume_concat(fl: torch.Tensor, fr: torch.Tensor, max_disp: int) -> torch.Tensor:
    """Concat volume through the CUDA kernel for CUDA tensors; the plain
    version for CPU tensors. Counts its launches in ``.launches``."""
    if fl.ndim != 4 or fl.shape != fr.shape or fl.dtype != fr.dtype:
        raise ValueError(f"fl/fr must be equal [B, H, W, C]: {fl.shape} {fr.shape}")
    if fl.device != fr.device:
        raise ValueError(f"fl on {fl.device}, fr on {fr.device}")
    if fl.device.type == "cpu":
        return cost_volume_concat_torch(fl, fr, max_disp)
    if fl.device.type != "cuda":
        raise ValueError(f"unsupported device {fl.device}")
    for t in (fl, fr):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("fl/fr must be contiguous and 16-byte aligned")
    b, h, w, c = fl.shape
    out = torch.empty(b, max_disp, h, w, 2 * c, dtype=fl.dtype, device=fl.device)
    status = _kernel()(
        fl.data_ptr(), fr.data_ptr(), out.data_ptr(), b, h, w,
        c * fl.element_size(), max_disp, torch.cuda.current_stream(fl.device).cuda_stream,
    )
    check(status, "cost_volume_concat")
    cost_volume_concat.launches += 1
    return out


cost_volume_concat.launches = 0
