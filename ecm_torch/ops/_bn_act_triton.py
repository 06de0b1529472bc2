"""The Triton kernel of ``ops/bn_act.py``: eval BatchNorm as an epilogue
over a channels-last map, read as one contiguous run of ``B H W C`` (or
``B D H W C``) values whose channel is the offset modulo ``C``.

The run is cut into rows of ``LANES`` values, ``LANES`` the largest power
of two (at most 64) that divides ``C``, so a row is ``LANES`` consecutive
channels of one pixel, starting at channel ``(row mod Q) LANES`` with
``Q = C / LANES``. Each program takes ``ROWS`` rows: its loads and stores
of the map are whole 16-byte vectors whatever ``C`` is (16, 24, 96, 144,
160, 576 and 960 all occur), and its loads of the per-channel vectors are
contiguous runs of ``LANES``, gathered from L1. One modulo a row, none an
element. The activation, the residual, the second ReLU and the bias are
``constexpr``: one kernel serves every site. Only the CUDA branch of
``ops/bn_act.py`` imports this module: a machine without a GPU may have no
Triton.
"""

from __future__ import annotations

import triton
import triton.language as tl


@triton.jit(do_not_specialize=["R"])
def bn_act_kernel(y, res, conv_bias, mean, var, weight, bias, eps, R, Q, ACT: tl.constexpr, HAS_RES: tl.constexpr,
                  POST: tl.constexpr, HAS_BIAS: tl.constexpr, ROWS: tl.constexpr, LANES: tl.constexpr):
    """Program ``i``: rows ``[i ROWS, (i + 1) ROWS)`` of the ``R`` rows.
    ``post(res + act(((y + conv_bias) - mean) weight rsqrt(var + eps) +
    bias))`` in float32 into ``y``: ``ACT`` 0 none, 1 ReLU, 2 ReLU6, 3
    LeakyReLU(0.01); ``POST`` 0 none, 1 ReLU."""
    row = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
    lane = tl.arange(0, LANES)
    mask = (row < R)[:, None]
    at = row.to(tl.int64)[:, None] * LANES + lane[None, :]
    ch = ((row % Q) * LANES)[:, None] + lane[None, :]
    v = tl.load(y + at, mask=mask).to(tl.float32)
    if HAS_BIAS:
        v += tl.load(conv_bias + ch).to(tl.float32)
    scale = tl.load(weight + ch).to(tl.float32) * tl.rsqrt(tl.load(var + ch).to(tl.float32) + eps)
    v = (v - tl.load(mean + ch).to(tl.float32)) * scale + tl.load(bias + ch).to(tl.float32)
    if ACT == 1:
        v = tl.maximum(v, 0.0)
    elif ACT == 2:
        v = tl.minimum(tl.maximum(v, 0.0), 6.0)
    elif ACT == 3:
        v = tl.where(v > 0.0, v, v * 0.01)
    if HAS_RES:
        v = tl.load(res + at, mask=mask).to(tl.float32) + v
    if POST == 1:
        v = tl.maximum(v, 0.0)
    tl.store(y + at, v.to(y.dtype.element_ty), mask=mask)
