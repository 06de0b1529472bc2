"""RAFT-Stereo's 1-D correlation pyramid: the volume, the plain lookup and
the wrapper of the lookup's CUDA kernel (``ecm_torch/csrc/corr1d.cu``).

The volume (published ``CorrBlock1D`` with ``corr_implementation reg``) is
``corr[b, h, x1, x2] = sum_c f1[b, c, h, x1] f2[b, c, h, x2] / sqrt(C)``, a
float32 batched matmul, and levels 1.. are ``avg_pool`` by 2 along ``x2``
(the published fifth level, which no lookup reads, is not built). The
lookup samples level ``i`` of each pixel's row at ``x = coords_x / 2**i + k``,
``k`` in ``-radius..radius``, by linear interpolation with zeros outside the
row: ``grid_sample`` with ``align_corners=True`` and zero padding. The
channels of ``[B, levels * (2 * radius + 1), H, W1]`` are level-major,
tap-minor. The kernel replaces no TPU kernel (the JAX package has no
RAFT-Stereo); it does all levels in one launch.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from ecm_torch.kernels.build import check, library

MAX_LEVELS = 4
RADIUS = 4  # the only radius the kernel is built for
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor, levels: int, scaled: bool = True) -> list[torch.Tensor]:
    """``levels`` float32 ``[B, H, W1, W2 >> i]`` from the float32 features
    ``[B, C, H, W1]`` and ``[B, C, H, W2]``; ``scaled`` False leaves out the
    ``1 / sqrt(C)`` (IGEV-Stereo's all-pairs correlation)."""
    b, c, h, w1 = fmap1.shape
    corr = torch.matmul(fmap1.permute(0, 2, 3, 1), fmap2.permute(0, 2, 1, 3))
    if scaled:
        corr = corr / math.sqrt(c)
    out = [corr]
    for _ in range(levels - 1):
        w = out[-1].shape[-1]
        out.append(F.avg_pool2d(out[-1].view(-1, 1, 1, w), (1, 2), (1, 2)).view(b, h, w1, w // 2))
    return out


def corr1d_lookup_torch(pyramid: list[torch.Tensor], coords: torch.Tensor, radius: int,
                        dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version, with ``grid_sample`` as the published lookup:
    ``[B, 2, H, W1]`` float32 coordinates -> ``[B, L * (2r + 1), H, W1]``
    in ``dtype`` (default float32)."""
    b, _, h, w1 = coords.shape
    taps = torch.arange(-radius, radius + 1, dtype=coords.dtype, device=coords.device).view(1, 1, -1, 1)
    out = []
    for i, level in enumerate(pyramid):
        w = level.shape[-1]
        x = coords[:, 0].reshape(-1, 1, 1, 1) / 2**i + taps  # [N, 1, 2r+1, 1]
        grid = torch.cat([2 * x / (w - 1) - 1, torch.zeros_like(x)], -1)
        sampled = F.grid_sample(level.reshape(-1, 1, 1, w), grid, align_corners=True)
        out.append(sampled.view(b, h, w1, -1))
    return torch.cat(out, -1).permute(0, 3, 1, 2).contiguous().to(dtype or torch.float32)


@functools.cache
def _kernel():
    fn = library("corr1d").ecm_corr1d_lookup
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, i, vp, vp, vp, vp, vp, vp, i, i, i, i, i, vp]
    fn.restype = ctypes.c_int
    return fn


def corr1d_lookup(pyramid: list[torch.Tensor], coords: torch.Tensor, radius: int,
                  dtype: torch.dtype | None = None) -> torch.Tensor:
    """The lookup through the CUDA kernel for CUDA tensors, the plain version
    for CPU (and ``meta``) tensors; anything else raises. ``dtype``: float32 (default), float16
    or bfloat16. Counts its launches in ``.launches``."""
    dtype = dtype or torch.float32
    if coords.ndim != 4 or coords.shape[1] != 2:
        raise ValueError(f"coords {tuple(coords.shape)} is not [B, 2, H, W1]")
    b, _, h, w1 = coords.shape
    if not 1 <= len(pyramid) <= MAX_LEVELS:
        raise ValueError(f"{len(pyramid)} pyramid levels; 1 to {MAX_LEVELS} are supported")
    w2 = pyramid[0].shape[-1]
    for i, level in enumerate(pyramid):
        if tuple(level.shape) != (b, h, w1, w2 >> i):
            raise ValueError(f"level {i} {tuple(level.shape)} is not {(b, h, w1, w2 >> i)}")
    if coords.device.type in ("cpu", "meta"):  # meta: shapes alone, for a model built there
        return corr1d_lookup_torch(pyramid, coords, radius, dtype)
    if coords.device.type != "cuda":
        raise ValueError(f"unsupported device {coords.device}")
    if radius != RADIUS:
        raise ValueError(f"the kernel is built for radius {RADIUS}, not {radius}")
    if dtype not in _DTYPES:
        raise ValueError(f"corr1d_lookup writes float32, float16 or bfloat16, not {dtype}")
    tensors = [coords, *pyramid]
    if any(t.dtype != torch.float32 or not t.is_contiguous() or t.device != coords.device for t in tensors):
        raise ValueError("corr1d_lookup takes contiguous float32 coords and levels on one device")
    out = torch.empty(b, len(pyramid) * (2 * radius + 1), h, w1, dtype=dtype, device=coords.device)
    ptrs = [t.data_ptr() for t in pyramid] + [None] * (MAX_LEVELS - len(pyramid))
    status = _kernel()(
        _DTYPES[dtype], len(pyramid), *ptrs, coords.data_ptr(), out.data_ptr(), b, h, w1, w2, radius,
        torch.cuda.current_stream(coords.device).cuda_stream,
    )
    check(status, "corr1d_lookup")
    corr1d_lookup.launches += 1
    return out


corr1d_lookup.launches = 0
