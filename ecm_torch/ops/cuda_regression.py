"""Fused x4 trilinear upsample + soft-argmin: the plain version and the
wrapper of its CUDA kernel (``ecm_torch/csrc/regression.cu``; replaces
``ecm_tpu/ops/pallas_regression.py::fused_upsample_softargmin``).

``[B, D/4, H/4, W/4]`` cost (f32 or bf16) -> ``[B, H, W]`` f32 disparity,
equal to ``disparity_regression(upsample_trilinear(cost4, (D, H, W)), D)``
without the full-resolution volume.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ecm_torch.kernels.build import check, library
from ecm_torch.ops.softargmin import disparity_regression
from ecm_torch.ops.upsample import upsample_trilinear


def fused_upsample_softargmin_torch(cost4: torch.Tensor, max_disp: int) -> torch.Tensor:
    """Plain PyTorch version: full-resolution upsample, then soft-argmin."""
    b, d4, h4, w4 = cost4.shape
    return disparity_regression(upsample_trilinear(cost4, (max_disp, 4 * h4, 4 * w4)), max_disp)


@functools.cache
def _kernel():
    fn = library("regression").ecm_upsample_softargmin
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, vp, vp, i, i, i, i, vp]
    fn.restype = ctypes.c_int
    return fn


def fused_upsample_softargmin(cost4: torch.Tensor, max_disp: int) -> torch.Tensor:
    """Disparity through the CUDA kernel for CUDA tensors; the plain version
    for CPU tensors. Counts its launches in ``.launches``."""
    if cost4.ndim != 4 or cost4.shape[1] * 4 != max_disp:
        raise ValueError(f"cost4 {tuple(cost4.shape)} is not [B, {max_disp}/4, H/4, W/4]")
    if cost4.device.type == "cpu":
        return fused_upsample_softargmin_torch(cost4, max_disp)
    if cost4.device.type != "cuda":
        raise ValueError(f"unsupported device {cost4.device}")
    if cost4.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_upsample_softargmin takes float32 or bfloat16, got {cost4.dtype}")
    if not cost4.is_contiguous():
        raise ValueError("cost4 must be contiguous")
    b, d4, h4, w4 = cost4.shape
    if d4 * 128 * 4 > 227 * 1024:
        raise ValueError(f"D/4={d4} planes do not fit the kernel's shared memory")
    out = torch.empty(b, 4 * h4, 4 * w4, dtype=torch.float32, device=cost4.device)
    status = _kernel()(
        1 if cost4.dtype == torch.bfloat16 else 0, cost4.data_ptr(), out.data_ptr(),
        b, d4, h4, w4, torch.cuda.current_stream(cost4.device).cuda_stream,
    )
    check(status, "fused_upsample_softargmin")
    fused_upsample_softargmin.launches += 1
    return out


fused_upsample_softargmin.launches = 0
