"""Instance norm of a channels-last ``[B, C, H, W]`` tensor (RAFT-Stereo's
``fnet``), in the tensor's layout: the plain version and, for CUDA tensors,
three Triton kernels (``ops/_instance_norm_triton.py``).

``F.instance_norm`` would do the arithmetic, but ``at::instance_norm`` makes
its input contiguous, so a channels-last tensor comes back NCHW and every
convolution after it pays cuDNN's transposes. Both versions compute each
(b, c)'s mean and biased variance over H x W in float32, normalise in
float32 and round once to the input's dtype, as the library's kernels do;
there is no affine and no running statistics (the published
``nn.InstanceNorm2d(c)``).

The plain version's float32 reductions over H x W of an NHWC tensor, with
only B x C outputs, ran at ~0.4 TB/s on the H100 (10.7 ms a RAFT pair
against the library's 5.3 on NCHW), so CUDA tensors take Triton kernels,
which a reduction over a channels-last layout suits. Triton is imported
only there: a machine without a GPU may have none.
"""

from __future__ import annotations

import torch

EPS = 1e-5  # nn.InstanceNorm2d's default, the published
MAX_CHUNKS = 256  # chunks of pixels an image, the combine's one tile
COMBINE_C = 32  # channels a combine program
TILE = 8192  # elements of a stats or normalise program's tile


def instance_norm_torch(x: torch.Tensor) -> torch.Tensor:
    """Plain version: the float32 mean, the float32 deviation, its variance,
    and the scaled deviation stored in ``x``'s dtype and layout."""
    mean = x.mean((2, 3), keepdim=True, dtype=torch.float32)
    d = x - mean
    rstd = torch.rsqrt(d.var((2, 3), correction=0, keepdim=True) + EPS)
    return torch.mul(d, rstd, out=torch.empty_like(x))


def instance_norm(x: torch.Tensor) -> torch.Tensor:
    """Instance norm of the channels-last ``x`` (float32, float16 or
    bfloat16), in its dtype and layout: the Triton kernels for a CUDA tensor,
    the plain version for a CPU (or ``meta``) one. Counts its launches (one
    a call, of three kernels) in ``.launches``."""
    if x.device.type != "cuda":
        return instance_norm_torch(x)
    if x.ndim != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"instance_norm takes a channels-last [B, C, H, W] tensor, not {tuple(x.shape)} "
                         f"of strides {x.stride()}")
    import triton

    from ecm_torch.ops import _instance_norm_triton as k

    b, c, h, w = x.shape
    p = h * w
    block_c = triton.next_power_of_2(c)
    block_p = max(1, TILE // block_c)
    chunk = triton.cdiv(triton.cdiv(p, min(MAX_CHUNKS, triton.cdiv(p, block_p))), block_p) * block_p
    s = triton.cdiv(p, chunk)
    part = torch.empty(b * s * 2 * c, dtype=torch.float32, device=x.device)
    stats = torch.empty(b * 2 * c, dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    k.instance_norm_stats[(b * s,)](x, part, p, c, chunk, s, BLOCK_P=block_p, BLOCK_C=block_c, num_warps=8)
    k.instance_norm_combine[(b, triton.cdiv(c, COMBINE_C))](
        part, stats, p, c, chunk, s, EPS, BLOCK_S=MAX_CHUNKS, BLOCK_C=COMBINE_C, num_warps=8)
    k.instance_norm_normalise[(triton.cdiv(p, block_p), b)](
        x, stats, y, p, c, BLOCK_P=block_p, BLOCK_C=block_c, num_warps=8)
    instance_norm.launches += 1
    return y


instance_norm.launches = 0
