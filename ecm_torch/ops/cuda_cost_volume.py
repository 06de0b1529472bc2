"""Concat and correlation cost volumes: the plain builders and the wrappers
of their CUDA kernels (``ecm_torch/csrc/cost_volume.cu``; replace
``cost_volume_pallas`` concat and correlation).

- concat: ``[B, H, W, C]`` x2 -> ``[B, D, H, W, 2C]``: column ``w`` pairs the
  left feature at ``w`` with the right feature at ``w - d``; columns ``w < d``
  are zero in both halves.
- correlation: ``[B, H, W, C]`` x2 -> ``[B, D, H, W, 1]``: the mean over C of
  ``fl[w] * fr[w - d]``, in f32, zero for ``w < d``.

Both wrappers are differentiable: the backward is the plain builder's VJP,
as ``_cv_bwd_rule``/``_corr_bwd_rule`` take the jnp builder's in JAX.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from ecm_torch.kernels.build import check, library


def cost_volume_concat_torch(fl: torch.Tensor, fr: torch.Tensor, max_disp: int) -> torch.Tensor:
    """Plain PyTorch concat volume (the CPU path and the kernel's reference)."""
    b, h, w, c = fl.shape
    out = fl.new_zeros(b, max_disp, h, w, 2 * c)
    for d in range(min(max_disp, w)):
        out[:, d, :, d:, :c] = fl[:, :, d:]
        out[:, d, :, d:, c:] = fr[:, :, : w - d]
    return out


def cost_volume_correlation_torch(fl: torch.Tensor, fr: torch.Tensor, max_disp: int) -> torch.Tensor:
    """Plain PyTorch correlation volume (the CPU path and the kernel's
    reference): products and mean in f32, rounded to fl's dtype."""
    b, h, w, _ = fl.shape
    out = fl.new_zeros(b, max_disp, h, w, 1)
    for d in range(min(max_disp, w)):
        prod = fl[:, :, d:].float() * fr[:, :, : w - d].float()
        out[:, d, :, d:] = prod.mean(-1, keepdim=True).to(fl.dtype)
    return out


@functools.cache
def _kernel(name: str):
    fn = getattr(library("cost_volume"), name)
    vp, i = ctypes.c_void_p, ctypes.c_int
    if name == "ecm_cost_volume_concat":
        fn.argtypes = [vp, vp, vp, i, i, i, i, i, vp]
    else:
        fn.argtypes = [i, vp, vp, vp, i, i, i, i, i, vp]
    fn.restype = ctypes.c_int
    return fn


def _check(fl: torch.Tensor, fr: torch.Tensor) -> None:
    if fl.ndim != 4 or fl.shape != fr.shape or fl.dtype != fr.dtype:
        raise ValueError(f"fl/fr must be equal [B, H, W, C]: {fl.shape} {fr.shape}")
    if fl.device != fr.device:
        raise ValueError(f"fl on {fl.device}, fr on {fr.device}")
    if fl.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {fl.device}")


def _check_cuda(fl: torch.Tensor, fr: torch.Tensor) -> None:
    for t in (fl, fr):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("fl/fr must be contiguous and 16-byte aligned")


def _concat_forward(fl, fr, max_disp):
    if fl.device.type == "cpu":
        return cost_volume_concat_torch(fl, fr, max_disp)
    _check_cuda(fl, fr)
    b, h, w, c = fl.shape
    out = torch.empty(b, max_disp, h, w, 2 * c, dtype=fl.dtype, device=fl.device)
    status = _kernel("ecm_cost_volume_concat")(
        fl.data_ptr(), fr.data_ptr(), out.data_ptr(), b, h, w,
        c * fl.element_size(), max_disp, torch.cuda.current_stream(fl.device).cuda_stream,
    )
    check(status, "cost_volume_concat")
    cost_volume_concat.launches += 1
    return out


def _correlation_forward(fl, fr, max_disp):
    if fl.device.type == "cpu":
        return cost_volume_correlation_torch(fl, fr, max_disp)
    if fl.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"cost_volume_correlation takes float32 or bfloat16, got {fl.dtype}")
    _check_cuda(fl, fr)
    b, h, w, c = fl.shape
    out = torch.empty(b, max_disp, h, w, 1, dtype=fl.dtype, device=fl.device)
    status = _kernel("ecm_cost_volume_correlation")(
        int(fl.dtype == torch.bfloat16), fl.data_ptr(), fr.data_ptr(), out.data_ptr(),
        b, h, w, c, max_disp, torch.cuda.current_stream(fl.device).cuda_stream,
    )
    check(status, "cost_volume_correlation")
    cost_volume_correlation.launches += 1
    return out


class _CostVolume(torch.autograd.Function):
    """A volume whose forward is the kernel (plain builder on the CPU) and
    whose backward is the plain builder's VJP."""

    @staticmethod
    def forward(ctx, fl, fr, max_disp, forward, plain):
        ctx.save_for_backward(fl, fr)
        ctx.max_disp, ctx.plain = max_disp, plain
        return forward(fl, fr, max_disp)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        fl, fr = ctx.saved_tensors
        with torch.enable_grad():
            a, b = fl.detach().requires_grad_(), fr.detach().requires_grad_()
            dfl, dfr = torch.autograd.grad(ctx.plain(a, b, ctx.max_disp), (a, b), g)
        return dfl, dfr, None, None, None


def cost_volume_concat(fl: torch.Tensor, fr: torch.Tensor, max_disp: int) -> torch.Tensor:
    """Concat volume through the CUDA kernel for CUDA tensors; the plain
    version for CPU tensors. Differentiable. Counts its launches in
    ``.launches``."""
    _check(fl, fr)
    return _CostVolume.apply(fl, fr, max_disp, _concat_forward, cost_volume_concat_torch)


def cost_volume_correlation(fl: torch.Tensor, fr: torch.Tensor, max_disp: int) -> torch.Tensor:
    """Correlation volume through the CUDA kernel for CUDA tensors; the plain
    version for CPU tensors. Differentiable. Counts its launches in
    ``.launches``."""
    _check(fl, fr)
    return _CostVolume.apply(fl, fr, max_disp, _correlation_forward, cost_volume_correlation_torch)


cost_volume_concat.launches = 0
cost_volume_correlation.launches = 0
