"""IGEV-Stereo's combined geometry-encoding lookup: its two pyramids, the
plain lookup and the wrapper of the lookup's CUDA kernel
(``ecm_torch/csrc/geo_lookup.cu``).

The geometry pyramid (published ``Combined_Geo_Encoding_Volume``) holds the
geometry encoding volume ``[B, C, D, H, W]`` as float32 ``[B*H*W, D, C]``,
each pixel's planes together, and level 1 as ``avg_pool`` by 2 along ``D``;
the correlation pyramid is RAFT-Stereo's (``cuda_corr1d.corr_pyramid``)
without its ``1 / sqrt(C)``. At disparity ``delta`` (float32 ``[B, 1, H, W]``,
1/4 scale) the lookup samples, for level ``i`` and tap ``k`` in
``-radius..radius``, each geometry channel at ``delta / 2**i + k`` and the
correlation row at ``x / 2**i - delta / 2**i + k`` (``x`` the pixel's
column), by linear interpolation with zeros outside the row:
``grid_sample`` with ``align_corners=True`` and zero padding. The channels
of ``[B, L * (C + 1) * (2 radius + 1), H, W]`` are level-major, then the C
geometry channels and the correlation, then tap, and the result is
channels-last. The kernel replaces no TPU kernel (the JAX package has no
IGEV-Stereo); it does every level and row in one launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ecm_torch.kernels.build import check, library

MAX_LEVELS = 2
RADIUS = 4  # the only radius the kernel is built for
CHANNELS = 8  # the only geometry width the kernel is built for
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def geo_pyramid(gev: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """``levels`` float32 ``[B*H*W, D >> i, C]`` from the geometry encoding
    volume ``[B, C, D, H, W]`` (any dtype and layout)."""
    b, c, d, h, w = gev.shape
    g = torch.empty(b * h * w, d, c, dtype=torch.float32, device=gev.device)
    g.view(b, h, w, d, c).copy_(gev.permute(0, 3, 4, 2, 1))
    out = [g]
    for _ in range(levels - 1):
        out.append(F.avg_pool2d(out[-1].unsqueeze(1), (2, 1), (2, 1)).squeeze(1))
    return out


def _grid(x: torch.Tensor, size: int) -> torch.Tensor:
    """``grid_sample``'s grid of the row positions ``x`` of a row of ``size``."""
    return torch.cat([2 * x / (size - 1) - 1, torch.zeros_like(x)], -1)


def geo_lookup_torch(geo: list[torch.Tensor], corr: list[torch.Tensor], disp: torch.Tensor, radius: int,
                     dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version, with ``grid_sample`` as the published lookup:
    ``[B, 1, H, W]`` float32 disparities -> channels-last
    ``[B, L * (C + 1) * (2 radius + 1), H, W]`` in ``dtype`` (default
    float32)."""
    b, _, h, w = disp.shape
    n = b * h * w
    dx = torch.arange(-radius, radius + 1, dtype=torch.float32, device=disp.device).view(1, 1, -1, 1)
    d = disp.reshape(n, 1, 1, 1)
    x = torch.arange(w, dtype=torch.float32, device=disp.device).view(1, 1, w).expand(b, h, w).reshape(n, 1, 1, 1)
    out = []
    for i, (g, c) in enumerate(zip(geo, corr)):
        depth, width = g.shape[1], c.shape[-1]
        sampled = F.grid_sample(g.permute(0, 2, 1).unsqueeze(2), _grid(dx + d / 2**i, depth), align_corners=True)
        out.append(sampled.view(b, h, w, -1))
        sampled = F.grid_sample(c.view(n, 1, 1, width), _grid(x / 2**i - d / 2**i + dx, width), align_corners=True)
        out.append(sampled.view(b, h, w, -1))
    return torch.cat(out, -1).to(dtype or torch.float32).permute(0, 3, 1, 2)


@functools.cache
def _kernel():
    fn = library("geo_lookup").ecm_geo_lookup
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, i, vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, i, vp]
    fn.restype = ctypes.c_int
    return fn


def geo_lookup(geo: list[torch.Tensor], corr: list[torch.Tensor], disp: torch.Tensor, radius: int,
               dtype: torch.dtype | None = None) -> torch.Tensor:
    """The lookup through the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors; anything else raises. ``geo``: :func:`geo_pyramid`;
    ``corr``: float32 ``[B, H, W, W2 >> i]``; ``dtype``: float32 (default),
    float16 or bfloat16. Counts its launches in ``.launches``."""
    dtype = dtype or torch.float32
    if disp.ndim != 4 or disp.shape[1] != 1:
        raise ValueError(f"disp {tuple(disp.shape)} is not [B, 1, H, W]")
    b, _, h, w = disp.shape
    if not 1 <= len(geo) == len(corr) <= MAX_LEVELS:
        raise ValueError(f"{len(geo)} geometry and {len(corr)} correlation levels; 1 to {MAX_LEVELS} of each")
    (_, depth, c), w2 = geo[0].shape, corr[0].shape[-1]
    for i, (g, cl) in enumerate(zip(geo, corr)):
        if tuple(g.shape) != (b * h * w, depth >> i, c) or tuple(cl.shape) != (b, h, w, w2 >> i):
            raise ValueError(f"level {i}: {tuple(g.shape)} and {tuple(cl.shape)} are not "
                             f"{(b * h * w, depth >> i, c)} and {(b, h, w, w2 >> i)}")
    if disp.device.type == "cpu":
        return geo_lookup_torch(geo, corr, disp, radius, dtype)
    if disp.device.type != "cuda":
        raise ValueError(f"unsupported device {disp.device}")
    if radius != RADIUS or c != CHANNELS:
        raise ValueError(f"the kernel is built for radius {RADIUS} and {CHANNELS} channels, not {radius} and {c}")
    if dtype not in _DTYPES:
        raise ValueError(f"geo_lookup writes float32, float16 or bfloat16, not {dtype}")
    tensors = [disp, *geo, *corr]
    if any(t.dtype != torch.float32 or not t.is_contiguous() or t.device != disp.device for t in tensors):
        raise ValueError("geo_lookup takes contiguous float32 levels and disparities on one device")
    levels = len(geo)
    out = torch.empty(b, h, w, levels * (c + 1) * (2 * radius + 1), dtype=dtype, device=disp.device)
    pad = [None] * (MAX_LEVELS - levels)
    status = _kernel()(
        _DTYPES[dtype], levels, *[t.data_ptr() for t in geo], *pad, *[t.data_ptr() for t in corr], *pad,
        disp.data_ptr(), out.data_ptr(), b, h, w, depth, c, w2, radius,
        torch.cuda.current_stream(disp.device).cuda_stream,
    )
    check(status, "geo_lookup")
    geo_lookup.launches += 1
    return out.permute(0, 3, 1, 2)


geo_lookup.launches = 0
