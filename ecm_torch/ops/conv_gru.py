"""RAFT-Stereo's ConvGRU cell around its convolutions (``ConvGRU`` in
``models/raft_stereo.py``): the pack of the state and the inputs into one
buffer, the gates and the state update, each a plain version and, for CUDA
tensors, a Triton kernel (``ops/_conv_gru_triton.py``).

The published cell, on channels-last ``[B, C, H, W]`` maps, is
``hx = [h | x]``, ``z = sigmoid(conv_z(hx) + cz)``,
``r = sigmoid(conv_r(hx) + cr)``, ``q = tanh(conv_q([r h | x]) + cq)`` and
``h' = (1 - z) h + z q``. The model runs it as five device operations:

1. :func:`conv_gru_pack`: ``hx = [h | x]`` (``x`` the cell's inputs);
2. one bias-free convolution of ``hx`` with ``conv_z``'s and ``conv_r``'s
   weights stacked: ``zr``, 2 C channels;
3. :func:`conv_gru_gate`: ``z`` stored, and ``r h`` written over ``hx``'s
   first C channels, which step 2 has read, so ``hx`` is then
   ``[r h | x]``;
4. a bias-free ``conv_q`` of ``hx``: ``q``;
5. :func:`conv_gru_update`: ``h'``.

Each step reads the maps' dtype (the biases too), computes in float32 in the
published order of operations and rounds once where it stores (``hx``,
``z``, ``r h``, ``h'``); the plain versions are that arithmetic in torch,
for CPU and ``meta`` tensors, and the card tests' yardstick.

Why kernels: around its three convolutions the cell is memory-bound
elementwise work, which torch ran as 17 kernels a cell (two channel
``cat``s and a third for ``[r h | x]``, three bias adds, three context
sums, the gates, the products and the update), about 51 reads and writes
of a 128-channel map a cell; the three kernels move 18 (pack 6, gate 7,
update 5). They are Triton, which fused elementwise work on rows of
channels suits. No TPU kernel has this function (the JAX package has no
RAFT-Stereo). Triton is imported only on the CUDA branch.
"""

from __future__ import annotations

import torch

CL = torch.channels_last
DTYPES = (torch.float16, torch.bfloat16, torch.float32)
# Each wrapper counts its own kernel's launches in ``.launches`` (read by
# ``ops/launches.py``): a cell launches one of each.
TILE = 4096  # elements of one map a program covers at most
PROGRAMS_PER_SM = 2  # at least, where the map has rows enough


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def plan(pixels: int, channels: int, sms: int) -> tuple[int, int]:
    """``(BLOCK_P, BLOCK_C)`` of a program: every channel of a row, and as
    many rows as keep ``TILE`` elements a map or ``PROGRAMS_PER_SM``
    programs on each of ``sms`` SMs, whichever is fewer."""
    block_c = _pow2(channels)
    return min(max(1, TILE // block_c), _pow2(-(-pixels // (PROGRAMS_PER_SM * sms)))), block_c


def conv_gru_pack_torch(h: torch.Tensor, xs: tuple[torch.Tensor, ...]) -> torch.Tensor:
    return torch.cat([h, *xs], 1)


def conv_gru_gate_torch(zr, bz, br, cz, cr, h, hx) -> torch.Tensor:
    c = h.shape[1]
    z = torch.sigmoid(zr[:, :c].float() + bz.float()[:, None, None] + cz.float())
    r = torch.sigmoid(zr[:, c:].float() + br.float()[:, None, None] + cr.float())
    hx[:, :c] = r * h.float()
    return z.to(h.dtype)


def conv_gru_update_torch(q, bq, cq, z, h) -> torch.Tensor:
    q = torch.tanh(q.float() + bq.float()[:, None, None] + cq.float())
    z = z.float()
    return torch.add((1 - z) * h.float(), z * q, out=torch.empty_like(h))


def _check(name: str, maps: dict, biases: dict | None = None) -> None:
    """The kernels take channels-last ``[B, C, H, W]`` maps of one shape but
    for their channels, and 1-D biases, all of one of ``DTYPES``, on one
    device, none requiring grad where autograd records (there is no
    backward)."""
    ref, biases = next(iter(maps.values())), biases or {}
    for k, t in {**maps, **biases}.items():
        if t.dtype != ref.dtype or t.dtype not in DTYPES or t.device != ref.device:
            raise ValueError(f"{name}: {k} is {t.dtype} on {t.device}; every tensor one of {DTYPES} on one device")
        if torch.is_grad_enabled() and t.requires_grad:
            raise RuntimeError(f"{name}: {k} requires grad, and the kernels have no backward (RAFT-Stereo's "
                               "training is not ported); call it under torch.inference_mode or torch.no_grad")
    for k, t in maps.items():
        if t.ndim != 4 or t.shape[0] != ref.shape[0] or t.shape[2:] != ref.shape[2:] \
                or not t.is_contiguous(memory_format=CL):
            raise ValueError(f"{name}: {k} must be a channels-last [B, C, H, W] map of {tuple(ref.shape)}'s B, H, "
                             f"W, not {tuple(t.shape)} of strides {t.stride()}")
    for k, t in biases.items():
        if t.ndim != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be a contiguous vector, not {tuple(t.shape)}")


def _launch_plan(x: torch.Tensor, channels: int) -> tuple[tuple[int], int, int]:
    b, _, h, w = x.shape
    p = b * h * w
    block_p, block_c = plan(p, channels, torch.cuda.get_device_properties(x.device).multi_processor_count)
    return (-(-p // block_p),), block_p, block_c


def conv_gru_pack(h: torch.Tensor, xs: tuple[torch.Tensor, ...]) -> torch.Tensor:
    """``[h | xs]``, channels-last, of one or two inputs: the kernel for CUDA
    tensors, the plain version for CPU (or ``meta``) ones."""
    if h.device.type != "cuda":
        return conv_gru_pack_torch(h, xs)
    if len(xs) not in (1, 2):
        raise ValueError(f"conv_gru_pack takes one or two inputs, not {len(xs)}")
    _check("conv_gru_pack", {"h": h, **{f"x{i}": x for i, x in enumerate(xs, 1)}})
    from ecm_torch.ops import _conv_gru_triton as k

    widths = [t.shape[1] for t in (h, *xs)] + [0] * (2 - len(xs))  # x2's 0: none
    hx = torch.empty((h.shape[0], sum(widths), *h.shape[2:]), dtype=h.dtype, device=h.device, memory_format=CL)
    grid, block_p, block_c = _launch_plan(h, max(widths))
    k.conv_gru_pack[grid](h, xs[0], xs[-1], hx, h.numel() // widths[0], *widths,
                          BLOCK_P=block_p, BLOCK_C=block_c, num_warps=4)
    conv_gru_pack.launches += 1
    return hx


def conv_gru_gate(zr, bz, br, cz, cr, h, hx) -> torch.Tensor:
    """The gates of the ``C``-channel state ``h``: ``z = sigmoid(zr[:, :C] +
    bz + cz)``, returned, and ``r h`` with ``r = sigmoid(zr[:, C:] + br +
    cr)`` written over ``hx[:, :C]``; float32 inside, each rounded once to
    the dtype."""
    if h.device.type != "cuda":
        return conv_gru_gate_torch(zr, bz, br, cz, cr, h, hx)
    c = h.shape[1]
    _check("conv_gru_gate", dict(zr=zr, cz=cz, cr=cr, h=h, hx=hx), dict(bz=bz, br=br))
    if zr.shape[1] != 2 * c or cz.shape[1] != c or cr.shape[1] != c or hx.shape[1] < c \
            or bz.shape[0] != c or br.shape[0] != c:
        raise ValueError(f"conv_gru_gate: channels zr {zr.shape[1]}, cz {cz.shape[1]}, cr {cr.shape[1]}, hx "
                         f"{hx.shape[1]}, biases {bz.shape[0]}, {br.shape[0]} against h's {c}")
    from ecm_torch.ops import _conv_gru_triton as k

    z = torch.empty_like(h)
    grid, block_p, block_c = _launch_plan(h, c)
    k.conv_gru_gate[grid](zr, bz, br, cz, cr, h, z, hx, h.numel() // c, c, hx.shape[1],
                          BLOCK_P=block_p, BLOCK_C=block_c, num_warps=4)
    conv_gru_gate.launches += 1
    return z


def conv_gru_update(q, bq, cq, z, h) -> torch.Tensor:
    """The new state ``(1 - z) h + z tanh(q + bq + cq)``, float32 inside,
    rounded once to the dtype."""
    if h.device.type != "cuda":
        return conv_gru_update_torch(q, bq, cq, z, h)
    c = h.shape[1]
    _check("conv_gru_update", dict(q=q, cq=cq, z=z, h=h), dict(bq=bq))
    if not q.shape == cq.shape == z.shape == h.shape or bq.shape[0] != c:
        raise ValueError(f"conv_gru_update: q {tuple(q.shape)}, cq {tuple(cq.shape)}, z {tuple(z.shape)}, "
                         f"bias {tuple(bq.shape)} against h's {tuple(h.shape)}")
    from ecm_torch.ops import _conv_gru_triton as k

    out = torch.empty_like(h)
    grid, block_p, block_c = _launch_plan(h, c)
    k.conv_gru_update[grid](q, bq, cq, z, h, out, h.numel() // c, c, BLOCK_P=block_p, BLOCK_C=block_c,
                            num_warps=4)
    conv_gru_update.launches += 1
    return out


conv_gru_pack.launches = conv_gru_gate.launches = conv_gru_update.launches = 0
