"""Two fused 3x3x3 stride-1 convolutions: the plain version and the wrapper
of its CUDA kernel (``ecm_torch/csrc/fused_conv3d_pair.cu``; replaces
``ecm_tpu/ops/pallas_fused_agg.py::fused_conv3d_pair``).

    out = E2(conv(E1(conv(x, k1)), k2)) [+ ctx broadcast over D] [+ x[..., :Cout]]
    Ei(v) = relu?(v * scale_i + bias_i), in f32

x ``[B, D, H, W, Cin]``; k1 ``[Cm, Cin, 3, 3, 3]`` and k2 ``[Cout, Cm, 3, 3,
3]`` (torch layout); scale/bias per channel (folded BN, or ones/zeros);
ctx ``[B, H, W, Cout]`` in x's dtype; ``residual`` adds ``x[..., :Cout]``
(needs Cin >= Cout). The intermediate is rounded to x's dtype. Returns
``[B, D, H, W, Cout]`` in x's dtype.

On the card the kernel has two routes (:func:`pair_route`): bf16 with Cin a
multiple of 8, Cm = 32 and Cout 1 or a multiple of 8 up to 32 (every form a
path of the port launches) runs on the tensor cores through ``wgmma``; f32
or other channel counts on the CUDA cores. :func:`pair_plan` is each route's
tiling. Every call packs the weights anew (:func:`pair_operands` on the
``wgmma`` route).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ecm_torch.kernels.build import check, library
from ecm_torch.ops.cuda_gband import H100_SMS, SMEM_PER_BLOCK, pack_conv_wgmma, pack_taps

# CUDA-core route: one block per output tile; the stage-1 intermediate over
# the tile and its one-voxel halo lives in shared memory, at most this many bytes
_TILE = (4, 8, 16)
_SMEM_LIMIT = 200 * 1024
# wgmma route (csrc/fused_conv3d_pair.cu, pair_wg): a tile is TH output rows
# of _WG_TW columns, from y rows of _WG_M columns and x rows of _WG_PITCH;
# mbarriers ahead of the weights, _WG_YSLOTS y planes, a ring of at most
# _WG_MAX_RING x stages of _WG_KC input channels (and, where k1 is not
# resident, that stage's 9 taps of k1); TH by preference
_WG_M = 64
_WG_TW = _WG_M - 2
_WG_PITCH = _WG_M + 2
_WG_CM = 32
_WG_KC = 16
_WG_BAR_BYTES = 128
_WG_YSLOTS = 3
_WG_MAX_RING = 8
_WG_TH = (4, 2)


class PairPlan(NamedTuple):
    """A route's tiling of one call. ``tile``: (D, H, W) of outputs per
    block (CUDA cores) or per work item (``wgmma``: D is the item's slab);
    ``blocks`` launched, ``smem_bytes`` per block, and ``recompute``: the
    stage-1 positions computed per output voxel. ``wgmma`` only: ``items``
    walked by the persistent blocks, ``ring`` x stages, and whether k1 is
    ``resident`` in shared memory (else each stage carries its taps)."""

    route: str
    tile: tuple[int, int, int]
    blocks: int
    smem_bytes: int
    recompute: float
    items: int = 0
    ring: int = 0
    resident: bool = False


def pair_route(dtype: torch.dtype, cin: int, cm: int, cout: int) -> str:
    """``"wgmma"`` for bf16 with Cin % 8 == 0, Cm == 32 and Cout 1 or a
    multiple of 8 up to 32; else ``"cuda_cores"``."""
    if (
        dtype == torch.bfloat16 and cin % 8 == 0 and cm == _WG_CM
        and (cout == 1 or (cout % 8 == 0 and cout <= 32))
    ):
        return "wgmma"
    return "cuda_cores"


def _wg_n2(cout: int) -> int:
    """Stage 2's N: Cout padded to 8, 16 or 32."""
    return 8 if cout <= 8 else 16 if cout <= 16 else 32


def _wg_smem(th: int, cin: int, cout: int, resident: bool, ring: int) -> int:
    """A block's shared memory: the mbarriers, k1 (if resident) and k2, the y
    slots and the ring (the kernel's smem_bytes)."""
    ks1 = -(-cin // 16)
    y_bytes = _WG_CM // 8 * (th + 2) * _WG_PITCH * 16
    x_bytes = _WG_KC // 8 * -(-(th + 4) * _WG_PITCH // 8) * 8 * 16  # chunks 128-byte aligned
    k1_tap = _WG_CM * 16 * 2
    return (
        _WG_BAR_BYTES + (27 * ks1 * k1_tap if resident else 0) + 27 * _WG_CM * _wg_n2(cout) * 2
        + _WG_YSLOTS * y_bytes + ring * (x_bytes + (0 if resident else 9 * k1_tap))
    )


def _wg_layout(cin: int, cout: int) -> tuple[int, bool, int]:
    """(TH, k1 resident, ring): the first of TH 4 resident, TH 4 streamed (N2
    = 8 only: the kernel's registers), TH 2 resident, TH 2 streamed whose
    ring of two fits; the ring then as long as fits."""
    for th in _WG_TH:
        if th == 4 and _wg_n2(cout) > 8:
            continue
        for resident in (True, False):
            if _wg_smem(th, cin, cout, resident, 2) <= SMEM_PER_BLOCK:
                ring = max(r for r in range(2, _WG_MAX_RING + 1)
                           if _wg_smem(th, cin, cout, resident, r) <= SMEM_PER_BLOCK)
                return th, resident, ring
    raise ValueError(f"fused_conv3d_pair: no wgmma tile fits for Cin={cin}, Cout={cout}")


@functools.lru_cache(maxsize=256)
def pair_plan(
    dtype: torch.dtype, b: int, d: int, h: int, w: int, cin: int, cm: int, cout: int,
    sms: int = H100_SMS,
) -> PairPlan:
    """The route and tiling :func:`fused_conv3d_pair` launches for x
    ``[b, d, h, w, cin]`` and widths (cm, cout) on a card of ``sms`` SMs.
    ``wgmma``: the D slab minimises the rounds of blocks (at most one per
    SM) times the y planes an item computes (its slab and two)."""
    route = pair_route(dtype, cin, cm, cout)
    if route == "wgmma":
        th, resident, ring = _wg_layout(cin, cout)
        tiles = b * -(-h // th) * -(-w // _WG_TW)
        best = None
        for sd in sorted({-(-d // n) for n in range(1, d + 1)}, reverse=True):
            items = tiles * -(-d // sd)
            blocks = min(items, sms)
            cost = -(-items // blocks) * (sd + 2)
            if best is None or cost < best[0]:
                best = (cost, sd, items, blocks)
        _, sd, items, blocks = best
        y_planes = b * (d + 2 * -(-d // sd)) * -(-h // th) * -(-w // _WG_TW)
        return PairPlan(
            route, (sd, th, _WG_TW), blocks, _wg_smem(th, cin, cout, resident, ring),
            y_planes * (th + 2) * _WG_M / (b * d * h * w), items, ring, resident,
        )
    td, th, tw = _tile(d, h, w, cm, dtype.itemsize)
    blocks = b * -(-d // td) * -(-h // th) * -(-w // tw)
    return PairPlan(
        route, (td, th, tw), blocks,
        (td + 2) * (th + 2) * (tw + 2) * cm * dtype.itemsize,
        (td + 2) * (th + 2) * (tw + 2) / (td * th * tw), blocks,
    )


def pack_pair_wgmma(k1: torch.Tensor, k2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``wgmma`` route's weights, bf16, zero in every pad: k1 ``[Cm, Cin,
    3, 3, 3]`` -> ``[27, ceil(Cin / 16), Cm / 8, 2, 8, 8]`` and k2 ``[Cout,
    Cm, 3, 3, 3]`` -> ``[27, Cm / 16, N2 / 8, 2, 8, 8]`` with N2 = Cout
    padded to 8, 16 or 32: per tap and 16 input channels, wgmma's K-major
    8 x 8 core matrices (``cuda_gband.pack_conv_wgmma``)."""
    return pack_conv_wgmma(k1, _WG_CM), pack_conv_wgmma(k2, _wg_n2(k2.shape[0]))


def pair_operands(k1, scale1, bias1, k2, scale2, bias2, device):
    """The ``wgmma`` route's operands on ``device``: the packed k1 and k2
    (:func:`pack_pair_wgmma`) and the f32 scale and bias vectors."""
    with torch.no_grad():
        k1p, k2p = pack_pair_wgmma(k1.to(device), k2.to(device))
        vecs = tuple(v.to(device, torch.float32).contiguous() for v in (scale1, bias1, scale2, bias2))
    return (k1p, k2p, *vecs)


def fused_conv3d_pair_torch(
    x, k1, scale1, bias1, k2, scale2, bias2, ctx=None,
    *, relu1=True, relu2=True, residual=False,
):
    """Plain PyTorch version (CPU path and the kernel's reference):
    conv -> f32 affine -> ReLU -> cast -> conv -> epilogue."""
    dt = x.dtype
    y = F.conv3d(x.movedim(-1, 1), k1.to(dt), padding=1)
    y = y.float() * scale1.float().view(-1, 1, 1, 1) + bias1.float().view(-1, 1, 1, 1)
    if relu1:
        y = y.clamp_min(0.0)
    y2 = F.conv3d(y.to(dt), k2.to(dt), padding=1).movedim(1, -1)
    y2 = y2.float() * scale2.float() + bias2.float()
    if relu2:
        y2 = y2.clamp_min(0.0)
    if ctx is not None:
        y2 = y2 + ctx.float()[:, None]
    if residual:
        y2 = y2 + x[..., : y2.shape[-1]].float()
    return y2.to(dt)


@functools.cache
def _kernel(route: str):
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib = library("fused_conv3d_pair")
    if route == "wgmma":
        fn = lib.ecm_fused_conv3d_pair_wgmma
        fn.argtypes = [vp] * 9 + [i] * 14 + [ctypes.c_longlong, vp]
    else:
        fn = lib.ecm_fused_conv3d_pair
        fn.argtypes = [i] + [vp] * 9 + [i] * 13 + [vp]
    fn.restype = ctypes.c_int
    return fn


def _tile(d: int, h: int, w: int, cm: int, itemsize: int) -> tuple[int, int, int]:
    td, th, tw = min(_TILE[0], d), min(_TILE[1], h), min(_TILE[2], w)
    while (td + 2) * (th + 2) * (tw + 2) * cm * itemsize > _SMEM_LIMIT:
        if th > 1:
            th = (th + 1) // 2
        elif td > 1:
            td = (td + 1) // 2
        elif tw > 1:
            tw = (tw + 1) // 2
        else:
            raise ValueError(f"fused_conv3d_pair: Cm={cm} too wide for shared memory")
    return td, th, tw


def fused_conv3d_pair(
    x, k1, scale1, bias1, k2, scale2, bias2, ctx=None,
    *, relu1=True, relu2=True, residual=False,
):
    """The fused pair through the CUDA kernel for CUDA tensors, on the route
    of :func:`pair_route`; the plain version for CPU tensors. Counts its
    launches, both routes, in ``.launches`` and by route in
    ``.route_launches``."""
    if x.ndim != 5:
        raise ValueError(f"x must be [B, D, H, W, Cin], got {tuple(x.shape)}")
    b, d, h, w, cin = x.shape
    cm, cout = k1.shape[0], k2.shape[0]
    if tuple(k1.shape) != (cm, cin, 3, 3, 3) or tuple(k2.shape) != (cout, cm, 3, 3, 3):
        raise ValueError(f"kernels {tuple(k1.shape)}, {tuple(k2.shape)} for Cin={cin}")
    for v, n in ((scale1, cm), (bias1, cm), (scale2, cout), (bias2, cout)):
        if v.numel() != n:
            raise ValueError(f"scale/bias of {v.numel()} for {n} channels")
    if ctx is not None and (tuple(ctx.shape) != (b, h, w, cout) or ctx.dtype != x.dtype):
        raise ValueError(f"ctx must be [B, H, W, Cout] in {x.dtype}, got {tuple(ctx.shape)} {ctx.dtype}")
    if residual and cin < cout:
        raise ValueError(f"residual needs Cin >= Cout, got {cin} < {cout}")
    if x.device.type == "cpu":
        return fused_conv3d_pair_torch(
            x, k1, scale1, bias1, k2, scale2, bias2, ctx,
            relu1=relu1, relu2=relu2, residual=residual,
        )
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_conv3d_pair takes float32 or bfloat16, got {x.dtype}")
    for t in (x, ctx):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError("x/ctx must be contiguous and 16-byte aligned")
    dev = x.device
    out = torch.empty(b, d, h, w, cout, dtype=x.dtype, device=dev)
    ctx_ptr = None if ctx is None else ctx.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    plan = pair_plan(x.dtype, b, d, h, w, cin, cm, cout,
                     torch.cuda.get_device_properties(dev).multi_processor_count)
    if plan.route == "wgmma":
        k1p, k2p, s1, b1, s2, b2 = pair_operands(k1, scale1, bias1, k2, scale2, bias2, dev)
        # the C entry encodes x's TMA tensor map on the host with x's address
        # and passes it by value: a CUDA graph captured here freezes it, which
        # is right only because a graph is replayed on its own buffers alone
        # (train/graphs.py)
        status = _kernel(plan.route)(
            x.data_ptr(), k1p.data_ptr(), s1.data_ptr(), b1.data_ptr(),
            k2p.data_ptr(), s2.data_ptr(), b2.data_ptr(), ctx_ptr, out.data_ptr(),
            b, d, h, w, cin, cout, int(relu1), int(relu2), int(residual),
            plan.tile[1], plan.tile[0], plan.ring, int(plan.resident), plan.blocks, plan.smem_bytes,
            stream,
        )
    else:
        s1, b1, s2, b2 = (v.to(dev, torch.float32).contiguous() for v in (scale1, bias1, scale2, bias2))
        k1p = pack_taps(k1, x.dtype, 32).to(dev)
        k2p = pack_taps(k2, x.dtype, 1 if cout == 1 else 32).to(dev)
        status = _kernel(plan.route)(
            1 if x.dtype == torch.bfloat16 else 0,
            x.data_ptr(), k1p.data_ptr(), s1.data_ptr(), b1.data_ptr(),
            k2p.data_ptr(), s2.data_ptr(), b2.data_ptr(), ctx_ptr, out.data_ptr(),
            b, d, h, w, cin, cm, cout, int(relu1), int(relu2), int(residual),
            *plan.tile, stream,
        )
    check(status, "fused_conv3d_pair")
    fused_conv3d_pair.launches += 1
    fused_conv3d_pair.route_launches[plan.route] += 1
    return out


fused_conv3d_pair.launches = 0
fused_conv3d_pair.route_launches = {"wgmma": 0, "cuda_cores": 0}
