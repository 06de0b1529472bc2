"""The Triton kernels of ``ops/conv_gru.py``: RAFT-Stereo's ConvGRU cell
around its two convolutions, on channels-last maps read as rows of
contiguous channels, one row a pixel of every image (``P = B H W`` rows).

``conv_gru_pack`` writes the state and the inputs into one buffer,
``conv_gru_gate`` the two gates (z stored, ``r h`` written over the
buffer's state channels) and ``conv_gru_update`` the new state. Each
program takes ``BLOCK_P`` rows and every channel of a map; each loads the
maps' dtype, computes in float32 and rounds once where it stores. Only the
CUDA branch of ``ops/conv_gru.py`` imports this module: a machine without
a GPU may have no Triton.
"""

from __future__ import annotations

import triton
import triton.language as tl
from triton.language.extra import libdevice


@triton.jit
def _copy_rows(src, dst, rows, pmask, cols, width, dst_width):
    """Rows ``rows`` of the ``width``-channel map ``src`` into the first
    ``width`` channels of ``dst``'s rows of ``dst_width`` (``width`` 0:
    nothing)."""
    mask = pmask & (cols < width)[None, :]
    v = tl.load(src + rows * width + cols[None, :], mask=mask)
    tl.store(dst + rows * dst_width + cols[None, :], v, mask=mask)


@triton.jit
def conv_gru_pack(h, x1, x2, hx, P, C, C1, C2, BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
    """Program ``i``: rows ``[i BLOCK_P, (i + 1) BLOCK_P)`` of ``hx = [h | x1
    | x2]``, of ``C``, ``C1`` and ``C2`` channels (``C2`` 0: no ``x2``)."""
    p = tl.program_id(0) * BLOCK_P + tl.arange(0, BLOCK_P)
    rows = p.to(tl.int64)[:, None]
    pmask = (p < P)[:, None]
    cols = tl.arange(0, BLOCK_C)
    width = C + C1 + C2
    _copy_rows(h, hx, rows, pmask, cols, C, width)
    _copy_rows(x1, hx + C, rows, pmask, cols, C1, width)
    _copy_rows(x2, hx + C + C1, rows, pmask, cols, C2, width)


@triton.jit
def conv_gru_gate(zr, bz, br, cz, cr, h, z, hx, P, C, HX, BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
    """Program ``i``: rows ``[i BLOCK_P, (i + 1) BLOCK_P)``.
    ``z = sigmoid((zr[:, :C] + bz) + cz)`` into ``z``, and with
    ``r = sigmoid((zr[:, C:] + br) + cr)``, ``r h`` into the first ``C``
    channels of ``hx``'s rows of ``HX``."""
    p = tl.program_id(0) * BLOCK_P + tl.arange(0, BLOCK_P)
    rows = p.to(tl.int64)[:, None]
    cols = tl.arange(0, BLOCK_C)
    cmask = cols < C
    mask = (p < P)[:, None] & cmask[None, :]
    at = rows * C + cols[None, :]
    pre = zr + rows * (2 * C) + cols[None, :]
    b_z = tl.load(bz + cols, mask=cmask).to(tl.float32)[None, :]
    b_r = tl.load(br + cols, mask=cmask).to(tl.float32)[None, :]
    zv = tl.sigmoid(tl.load(pre, mask=mask).to(tl.float32) + b_z + tl.load(cz + at, mask=mask).to(tl.float32))
    rv = tl.sigmoid(tl.load(pre + C, mask=mask).to(tl.float32) + b_r + tl.load(cr + at, mask=mask).to(tl.float32))
    tl.store(z + at, zv.to(z.dtype.element_ty), mask=mask)
    hv = tl.load(h + at, mask=mask).to(tl.float32)
    tl.store(hx + rows * HX + cols[None, :], (rv * hv).to(hx.dtype.element_ty), mask=mask)


@triton.jit
def conv_gru_update(q, bq, cq, z, h, out, P, C, BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
    """Program ``i``: rows ``[i BLOCK_P, (i + 1) BLOCK_P)``.
    ``(1 - z) h + z tanh((q + bq) + cq)`` into ``out``."""
    p = tl.program_id(0) * BLOCK_P + tl.arange(0, BLOCK_P)
    cols = tl.arange(0, BLOCK_C)
    cmask = cols < C
    mask = (p < P)[:, None] & cmask[None, :]
    at = p.to(tl.int64)[:, None] * C + cols[None, :]
    b_q = tl.load(bq + cols, mask=cmask).to(tl.float32)[None, :]
    qv = libdevice.tanh(tl.load(q + at, mask=mask).to(tl.float32) + b_q + tl.load(cq + at, mask=mask).to(tl.float32))
    zv = tl.load(z + at, mask=mask).to(tl.float32)
    hv = tl.load(h + at, mask=mask).to(tl.float32)
    tl.store(out + at, ((1.0 - zv) * hv + zv * qv).to(out.dtype.element_ty), mask=mask)
