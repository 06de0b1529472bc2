"""The disparity axis of the 3D stack over ``torch.distributed``, forward and
backward (port of ``ecm_tpu/parallel/halo.py``).

``ecm_tpu`` shards the cost volume's disparity axis with a GSPMD hint and
XLA inserts the halo exchanges around each 3D convolution; its ``halo.py``
writes the same collectives out by hand as an executable specification.
PyTorch has no GSPMD, so here they are the implementation: under a mesh with
``disp > 1`` (``use_mesh``) every rank of a disp group holds its own equal
slab of the disparities at every level of the 3D stack.

The specification's three functions and a gather, on this rank's slab
``[B, Dl, ...]``:

- :func:`halo_exchange_d`: ``+-halo`` planes from the ring neighbours, zero
  planes at the ends of the global range;
- :func:`conv3d_d_sharded`: a 3x3x3 SAME convolution as a VALID-in-D
  convolution of the halo-padded slab;
- :func:`softargmin_d_sharded`: a global max, then one sum of the
  (numerator, denominator) pair; the model does not call it, as in
  ``ecm_tpu`` (the regression reads a gathered cost map, see
  ``models.ecm``);
- :func:`gather_d`: the disp group's slabs concatenated in rank order.

The model's conv forms run on a slab through :func:`slab_s1`,
:func:`slab_down` and :func:`slab_up`, one for each kind of D arithmetic.
Each pads the slab with its neighbours' planes, runs the unchanged form (a
CUDA kernel on the card, cuDNN or its plain version) and crops the planes
that read a plane that is not real. A rank at an end of the global range
takes no halo there: the form's own zero padding is then the unsharded
one, which a zero halo would not be for a fused pair (its intermediate's
padding). Every output plane that is kept reads only real planes.

In training the padding, the crops and the zero planes differentiate as
they are; the exchange is one ``autograd.Function`` whose backward returns
each received plane's gradient to the rank that owns the plane (the
neighbours swap the forward's ``lo`` and ``hi``), and the gather's backward
keeps this rank's slice, since every rank computes the loss from the whole
gathered map. Each Function keeps its mesh (autograd runs a CUDA backward
on a thread of its own, which does not see the thread-local one).

Transport is chosen by the disp group's backend name: NCCL sends CUDA
tensors point to point (``batch_isend_irecv``, so no pair of ranks
deadlocks) and all-gathers them; gloo has no CUDA point-to-point or
all-gather, so a CUDA slab is copied (synchronously) into a pinned host
buffer, sent by gloo and copied back. That is how ranks that share one card
run. CPU tensors go over gloo as they are. Every collective raises on a
failed rank, the backward's messages too. :func:`read_traffic` counts, per
rank, the messages and bytes received by the halos (forward, and apart the
backward's gradients) and the gathers, and the copies made to give a kernel
a contiguous slab.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ecm_torch.parallel.sharding import Mesh, disp_mesh

TRAFFIC_KEYS = ("halo_messages", "halo_bytes", "halo_grad_messages", "halo_grad_bytes", "gather_messages",
                "gather_bytes", "copies")
_traffic = dict.fromkeys(TRAFFIC_KEYS, 0)


def reset_traffic() -> None:
    for k in TRAFFIC_KEYS:
        _traffic[k] = 0


def read_traffic() -> dict[str, int]:
    return dict(_traffic)


def _backend(mesh: Mesh) -> str:
    backend = dist.get_backend(mesh.disp_group)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"disparity-axis transport over {backend!r}: the port sends over nccl or gloo")
    return backend


def _staged(t: torch.Tensor, backend: str) -> torch.Tensor:
    """``t`` as the backend sends it: a CUDA tensor under gloo becomes a
    pinned host copy (the copy waits for the stream)."""
    t = t.contiguous()
    if backend == "gloo" and t.is_cuda:
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
    return t


def _buffer(like: torch.Tensor, shape, backend: str) -> torch.Tensor:
    if backend == "gloo" and like.is_cuda:
        return torch.empty(shape, dtype=like.dtype, pin_memory=True)
    return like.new_empty(shape)


def _send_recv(mesh: Mesh, like: torch.Tensor, sends: dict, recvs: dict) -> dict:
    """One batch of point-to-point messages on the disp group: ``sends``
    maps a neighbour's disp index to the planes for it, ``recvs`` a
    neighbour's disp index to the number of planes to take from it. Returns
    the received planes by disp index, on ``like``'s device."""
    backend = _backend(mesh)
    ops, bufs = [], {}
    for peer, planes in sends.items():
        ops.append(dist.P2POp(dist.isend, _staged(planes, backend), mesh.disp_ranks[peer], mesh.disp_group))
    for peer, planes in recvs.items():
        bufs[peer] = _buffer(like, (like.shape[0], planes, *like.shape[2:]), backend)
        ops.append(dist.P2POp(dist.irecv, bufs[peer], mesh.disp_ranks[peer], mesh.disp_group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return {peer: buf.to(like.device) for peer, buf in bufs.items()}


def _count(kind: str, planes) -> None:
    for t in planes:
        _traffic[f"{kind}_messages"] += 1
        _traffic[f"{kind}_bytes"] += t.numel() * t.element_size()


class _HaloPad(torch.autograd.Function):
    """This rank's slab with the ``lo`` highest planes of the rank below
    before it and the ``hi`` lowest planes of the rank above after it, none
    at an end of the global range. The backward sends the gradient of each
    received plane back to its owner, which adds it to the gradient of its
    own edge planes. Every rank of the disp group calls it with the same
    ``lo`` and ``hi``, and each rank's node runs its backward (its output
    always reaches the loss), so the ranks exchange in one order both
    ways."""

    @staticmethod
    def forward(ctx, vol: torch.Tensor, mesh: Mesh, lo: int, hi: int) -> torch.Tensor:
        if vol.shape[1] < max(lo, hi):
            raise ValueError(f"a slab of {vol.shape[1]} planes cannot give a halo of {max(lo, hi)}")
        i, n, d = mesh.disp_index, mesh.disp, vol.shape[1]
        sends, recvs = {}, {}
        if i > 0:
            if hi:
                sends[i - 1] = vol[:, :hi]
            if lo:
                recvs[i - 1] = lo
        if i < n - 1:
            if lo:
                sends[i + 1] = vol[:, d - lo:]
            if hi:
                recvs[i + 1] = hi
        got = _send_recv(mesh, vol, sends, recvs)
        _count("halo", got.values())
        ctx.mesh, ctx.lo, ctx.hi = mesh, lo, hi
        ctx.below, ctx.above = i - 1 in got, i + 1 in got
        parts = [t for t in (got.get(i - 1), vol, got.get(i + 1)) if t is not None]
        return torch.cat(parts, 1) if len(parts) > 1 else vol.view_as(vol)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        mesh, lo, hi = ctx.mesh, ctx.lo, ctx.hi
        i = mesh.disp_index
        start = lo if ctx.below else 0
        d = grad.shape[1] - start - (hi if ctx.above else 0)
        sends = {}
        if ctx.below:
            sends[i - 1] = grad[:, :lo]
        if ctx.above:
            sends[i + 1] = grad[:, start + d:]
        # the owner's side: a neighbour took planes from this rank where it
        # exists and its halo on this side is not 0
        recvs = {}
        if i > 0 and hi:
            recvs[i - 1] = hi
        if i < mesh.disp - 1 and lo:
            recvs[i + 1] = lo
        got = _send_recv(mesh, grad, sends, recvs)
        _count("halo_grad", got.values())
        gvol = grad[:, start:start + d]
        if got:
            gvol = gvol.clone()
            if i - 1 in got:
                gvol[:, :hi] += got[i - 1]
            if i + 1 in got:
                gvol[:, d - lo:] += got[i + 1]
        return gvol, None, None, None


def _halo_pad(vol: torch.Tensor, mesh: Mesh, lo: int, hi: int) -> tuple[torch.Tensor, int, int]:
    """``(padded, below, above)``: :class:`_HaloPad`'s slab and the number of
    planes it put before and after this rank's."""
    below = lo if mesh.disp_index > 0 else 0
    above = hi if mesh.disp_index < mesh.disp - 1 else 0
    return _HaloPad.apply(vol, mesh, lo, hi), below, above


def _zero_planes(t: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """``t`` with ``lo`` zero planes before and ``hi`` after along D."""
    if not lo and not hi:
        return t
    shape = list(t.shape)
    return torch.cat([t.new_zeros([shape[0], lo, *shape[2:]]), t, t.new_zeros([shape[0], hi, *shape[2:]])], 1)


def _crop(y: torch.Tensor, start: int, planes: int) -> torch.Tensor:
    """Planes ``start .. start + planes`` of ``y``. A contiguous ``y`` (a
    kernel's output) gives a contiguous, 16-byte aligned slab, as the
    kernels take it: a view where that is one (batch 1), else a copy
    (counted); a strided ``y`` (a cuDNN output) gives a view."""
    if start == 0 and planes == y.shape[1]:
        return y
    out = y.narrow(1, start, planes)
    if y.is_contiguous() and (not out.is_contiguous() or out.data_ptr() % 16):
        _traffic["copies"] += 1
        out = out.clone(memory_format=torch.contiguous_format)
    return out


def halo_exchange_d(vol: torch.Tensor, mesh: Mesh, halo: int = 1) -> torch.Tensor:
    """This rank's slab ``[B, Dl, ...]`` with ``halo`` planes from each ring
    neighbour before and after it, zero planes at the ends of the global
    range: ``[B, Dl + 2 halo, ...]`` (``ecm_tpu/parallel/halo.py:36``)."""
    padded, below, above = _halo_pad(vol, mesh, halo, halo)
    return _zero_planes(padded, halo - below, halo - above)


def conv3d_d_sharded(vol: torch.Tensor, weight: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The 3x3x3 SAME convolution (stride 1) of the D-sharded volume whose
    slab ``[B, Dl, H, W, Cin]`` this rank holds, weight ``[Cout, Cin, 3, 3,
    3]``: a +-1 halo, then VALID along D and SAME along H and W. Returns this
    rank's slab of the output (``ecm_tpu/parallel/halo.py:56``)."""
    padded = halo_exchange_d(vol, mesh, 1)
    return F.conv3d(padded.movedim(-1, 1), weight.to(vol.dtype), padding=(0, 1, 1)).movedim(1, -1)


def softargmin_d_sharded(cost: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Soft-argmin over a D-sharded ``[B, D, H, W]`` cost whose slab ``[B,
    Dl, H, W]`` this rank holds: ``sum_d d softmax(-cost)_d`` in f32 as the
    two-pass collective (``ecm_tpu/parallel/halo.py:105``), a max over the
    disp group for a stable softmax, then one sum of (sum d p, sum p).
    Returns the disparity ``[B, H, W]`` on every rank of the group."""
    logits = -cost.float()
    peak = logits.amax(1, keepdim=True)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=mesh.disp_group)
    p = torch.exp(logits - peak)
    dl = cost.shape[1]
    d = torch.arange(mesh.disp_index * dl, (mesh.disp_index + 1) * dl, dtype=torch.float32, device=cost.device)
    num_den = torch.stack([(p * d.view(1, -1, 1, 1)).sum(1), p.sum(1)])
    dist.all_reduce(num_den, group=mesh.disp_group)
    return num_den[0] / num_den[1]


class _GatherD(torch.autograd.Function):
    """The all-gather of :func:`gather_d`. Every rank of the disp group
    computes the same loss from the gathered map, so the gradient of this
    rank's slab is its own slice of the incoming gradient: a sum over the
    group (``torch.distributed.nn``'s all-gather) would count it ``disp``
    times. The backward sends nothing."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        local = _staged(t, _backend(mesh))
        parts = [torch.empty_like(local) for _ in range(mesh.disp)]
        dist.all_gather(parts, local, group=mesh.disp_group)
        _traffic["gather_messages"] += mesh.disp - 1
        _traffic["gather_bytes"] += (mesh.disp - 1) * local.numel() * local.element_size()
        ctx.start, ctx.planes = mesh.disp_index * t.shape[1], t.shape[1]
        return torch.cat(parts, 1).to(t.device)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad.narrow(1, ctx.start, ctx.planes), None


def gather_d(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The disp group's slabs ``[B, Dl, ...]`` concatenated along D in the
    order of the group's ranks: ``[B, disp * Dl, ...]`` on every rank;
    the backward keeps this rank's slice (:class:`_GatherD`)."""
    return _GatherD.apply(t, mesh)


def slab_s1(fn, x: torch.Tensor, halo: int = 1, add: torch.Tensor | None = None) -> torch.Tensor:
    """``fn(x)`` (``fn(x, add)`` with ``add``), a stride-1 3D conv form on
    NDHWC ``x`` with zero padding along D whose output plane p reads input
    planes p - halo .. p + halo: 1 for one conv, 2 for a fused pair. Under
    a disp mesh, ``fn`` runs on the slab padded with ``halo`` neighbour
    planes on each side that has a neighbour, and the padding is cropped.
    ``add``, a post-activation add of ``x``'s planes, is padded with zero
    planes (their outputs are cropped); a ``[B, 1, H, W, C]`` map broadcast
    over D passes as it is."""
    mesh = disp_mesh()
    if mesh is None:
        return fn(x) if add is None else fn(x, add)
    xp, lo, hi = _halo_pad(x, mesh, halo, halo)
    if add is None:
        y = fn(xp)
    else:
        y = fn(xp, add if add.shape[1] == 1 else _zero_planes(add, lo, hi))
    return _crop(y, lo, x.shape[1])


def slab_down(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)``, a stride-2 3x3x3 conv form with zero padding 1 (output k
    centred on input plane 2k). Under a disp mesh the slab starts at an even
    global plane s; its outputs s/2 .. read planes s - 1 .. s + Dl - 1, so
    each rank but the first takes one plane from below, puts one zero plane
    before it (the slab then starts at s - 2, even again) and drops the
    first output, which read the zero plane."""
    mesh = disp_mesh()
    if mesh is None:
        return fn(x)
    if x.shape[1] % 2:
        raise ValueError(f"a stride-2 conv on a slab of {x.shape[1]} planes: slabs must split into even planes")
    xp, below, _ = _halo_pad(x, mesh, 1, 0)
    if not below:
        return fn(xp)
    return _crop(fn(_zero_planes(xp, 1, 0)), 1, x.shape[1] // 2)


def slab_up(fn, x: torch.Tensor, add: torch.Tensor | None = None) -> torch.Tensor:
    """``fn(x)`` (``fn(x, add)`` with ``add``), a transposed 3x3x3 conv form
    of stride 2, padding 1, output padding 1: output 2j reads input j,
    output 2j + 1 inputs j and j + 1. Under a disp mesh each rank but the
    last takes one plane from above, runs ``fn`` on ``Dl + 1`` planes and
    keeps the first ``2 Dl`` outputs; ``add`` (``2 Dl`` planes) is padded
    with two zero planes to the ``2 Dl + 2`` outputs of the padded slab (the
    kernel fuses it), whose last two are cropped."""
    mesh = disp_mesh()
    if mesh is None:
        return fn(x) if add is None else fn(x, add)
    xp, _, above = _halo_pad(x, mesh, 0, 1)
    if not above:
        return fn(xp) if add is None else fn(xp, add)
    y = fn(xp) if add is None else fn(xp, _zero_planes(add, 0, 2))
    return _crop(y, 0, 2 * x.shape[1])
