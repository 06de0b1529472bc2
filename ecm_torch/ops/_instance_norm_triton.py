"""The Triton kernels of ``ops/instance_norm.py``: instance norm of a
channels-last ``[B, C, H, W]`` tensor, which is a reduction over H x W with
B x C outputs, read as rows of C contiguous channels.

``instance_norm_stats`` reads a chunk of pixels of one image a program (the
mean and M2 of each channel, its tiles merged by Chan's formula),
``instance_norm_combine`` merges the chunks of each (b, c) in a fixed order
(no atomics, so a graph's replay equals the eager forward bit for bit), and
``instance_norm_normalise`` reads the input once more and writes the output.
Only the CUDA branch of ``instance_norm`` imports this module: a machine
without a GPU may have no Triton.
"""

from __future__ import annotations

import triton
import triton.language as tl


@triton.jit
def instance_norm_stats(x, part, P, C, CHUNK, S, BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
    """Program ``b * S + s``: the mean and M2 of each channel over pixels
    ``[s CHUNK, min((s + 1) CHUNK, P))`` of image ``b``, into ``part``."""
    pid = tl.program_id(0)
    start = (pid % S) * CHUNK
    end = tl.minimum(start + CHUNK, P)
    rows = tl.arange(0, BLOCK_P)
    cols = tl.arange(0, BLOCK_C)
    cmask = cols < C
    img = x + (pid // S).to(tl.int64) * P * C
    mean = tl.zeros([BLOCK_C], dtype=tl.float32)
    m2 = tl.zeros([BLOCK_C], dtype=tl.float32)
    for p0 in range(start, end, BLOCK_P):
        p = p0 + rows
        mask = (p < end)[:, None] & cmask[None, :]
        v = tl.load(img + p[:, None] * C + cols[None, :], mask=mask, other=0.0).to(tl.float32)
        n = (p0 - start).to(tl.float32)
        k = tl.minimum(end - p0, BLOCK_P).to(tl.float32)
        t_mean = tl.sum(v, axis=0) / k
        d = tl.where(mask, v - t_mean[None, :], 0.0)
        delta = t_mean - mean
        mean += delta * (k / (n + k))
        m2 += tl.sum(d * d, axis=0) + delta * delta * (n * k / (n + k))
    out = part + pid.to(tl.int64) * 2 * C + cols
    tl.store(out, mean, mask=cmask)
    tl.store(out + C, m2, mask=cmask)


@triton.jit
def instance_norm_combine(part, stats, P, C, CHUNK, S, eps, BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr):
    """Program ``(b, j)``: channels ``[j BLOCK_C, (j + 1) BLOCK_C)`` of image
    ``b``, its ``S`` chunks merged: the mean and ``1 / sqrt(var + eps)``."""
    b = tl.program_id(0)
    cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
    s = tl.arange(0, BLOCK_S)
    cmask = cols < C
    mask = (s < S)[:, None] & cmask[None, :]
    rows = part + (b * S + s).to(tl.int64)[:, None] * 2 * C + cols[None, :]
    means = tl.load(rows, mask=mask, other=0.0)
    m2s = tl.load(rows + C, mask=mask, other=0.0)
    n = tl.where(s < S, tl.minimum(CHUNK, P - s * CHUNK), 0).to(tl.float32)[:, None]
    mean = tl.sum(means * n, axis=0) / P
    d = means - mean[None, :]
    var = tl.sum(m2s + d * d * n, axis=0) / P
    out = stats + b.to(tl.int64) * 2 * C + cols
    tl.store(out, mean, mask=cmask)
    tl.store(out + C, 1.0 / tl.sqrt_rn(var + eps), mask=cmask)


@triton.jit
def instance_norm_normalise(x, stats, y, P, C, BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
    """Program ``(i, b)``: pixels ``[i BLOCK_P, (i + 1) BLOCK_P)`` of image
    ``b``, ``(x - mean) rstd`` in float32, stored in ``y``'s dtype."""
    b = tl.program_id(1)
    p = tl.program_id(0) * BLOCK_P + tl.arange(0, BLOCK_P)
    cols = tl.arange(0, BLOCK_C)
    cmask = cols < C
    mean = tl.load(stats + b * 2 * C + cols, mask=cmask, other=0.0)
    rstd = tl.load(stats + b * 2 * C + C + cols, mask=cmask, other=0.0)
    off = b.to(tl.int64) * P * C + p[:, None] * C + cols[None, :]
    mask = (p < P)[:, None] & cmask[None, :]
    v = tl.load(x + off, mask=mask, other=0.0).to(tl.float32)
    tl.store(y + off, ((v - mean[None, :]) * rstd[None, :]).to(y.dtype.element_ty), mask=mask)
