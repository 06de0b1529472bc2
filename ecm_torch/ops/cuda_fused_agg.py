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
path of the port launches) runs on the tensor cores; f32 or other channel
counts on the CUDA cores. :func:`pair_plan` is each route's tiling.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ecm_torch.kernels.build import check, library
from ecm_torch.ops.cuda_gband import pack_taps

# CUDA-core route: one block per output tile; the stage-1 intermediate over
# the tile and its one-voxel halo lives in shared memory, at most this many bytes
_TILE = (4, 8, 16)
_SMEM_LIMIT = 200 * 1024
# tensor-core route (csrc/fused_conv3d_pair.cu, pair_mma): an (H, W) tile per
# block, which marches along a slab of D planes of at most _MMA_SD; every
# shared operand row is 32 bf16 at a pitch of _MMA_LD
_MMA_TILE = (8, 16)
_MMA_SD = 16
_MMA_CM = 32
_MMA_LD = 40


class PairPlan(NamedTuple):
    """A route's tiling of one call: ``tile`` (D, H, W) of outputs per block
    (the tensor-core route's D is its slab), ``blocks`` launched,
    ``smem_bytes`` per block, and ``recompute``: the stage-1 positions a
    block computes per output voxel it writes."""

    route: str
    tile: tuple[int, int, int]
    blocks: int
    smem_bytes: int
    recompute: float


def pair_route(dtype: torch.dtype, cin: int, cm: int, cout: int) -> str:
    """``"tensor_cores"`` for bf16 with Cin % 8 == 0, Cm == 32 and Cout 1
    or a multiple of 8 up to 32 (k2 stays in shared memory: 27 x Cout x 80
    bytes); else ``"cuda_cores"``."""
    if (
        dtype == torch.bfloat16 and cin % 8 == 0 and cm == _MMA_CM
        and (cout == 1 or (cout % 8 == 0 and cout <= 32))
    ):
        return "tensor_cores"
    return "cuda_cores"


def _mma_sd(d: int) -> int:
    """The D slab: as even as ceil(D / _MMA_SD) slabs allow."""
    return -(-d // -(-d // _MMA_SD))


def pair_plan(
    dtype: torch.dtype, b: int, d: int, h: int, w: int, cin: int, cm: int, cout: int
) -> PairPlan:
    """The route and tiling :func:`fused_conv3d_pair` launches for x
    ``[b, d, h, w, cin]`` and widths (cm, cout)."""
    route = pair_route(dtype, cin, cm, cout)
    if route == "tensor_cores":
        (th, tw), sd = _MMA_TILE, _mma_sd(d)
        x_rows, y_rows = (th + 4) * (tw + 4), (th + 2) * (tw + 2)
        cout_pad = 8 if cout == 1 else cout
        # x and 9 taps of k1 in each of two ring stages, three y planes, k2
        elems = 2 * (x_rows + 9 * _MMA_CM) * _MMA_LD + 3 * y_rows * _MMA_LD + 27 * cout_pad * _MMA_LD
        return PairPlan(
            route, (sd, th, tw), b * -(-d // sd) * -(-h // th) * -(-w // tw), 2 * elems,
            y_rows / (th * tw) * (sd + 2) / sd,
        )
    td, th, tw = _tile(d, h, w, cm, dtype.itemsize)
    return PairPlan(
        route, (td, th, tw), b * -(-d // td) * -(-h // th) * -(-w // tw),
        (td + 2) * (th + 2) * (tw + 2) * cm * dtype.itemsize,
        (td + 2) * (th + 2) * (tw + 2) / (td * th * tw),
    )


def pack_pair_mma(k1: torch.Tensor, k2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The tensor-core route's weights as the kernel's shared-memory images,
    bf16, zero in every pad: k1 ``[Cm, Cin, 3, 3, 3]`` -> ``[3 kd, nch, 9
    (kh, kw), Cm, 40]`` with input channel ``32 c + i`` at ``[:, c, :, :,
    i]`` (nch = ceil(Cin / 32)); k2 ``[Cout, Cm, 3, 3, 3]`` -> ``[27 taps,
    Cout_pad, 40]`` (Cout_pad 8 for Cout 1, else Cout)."""
    cm, cin = k1.shape[:2]
    cout = k2.shape[0]
    nch = -(-cin // _MMA_CM)
    k1b = F.pad(k1.to(torch.bfloat16), (0, 0, 0, 0, 0, 0, 0, nch * _MMA_CM - cin))
    k1p = k1b.reshape(cm, nch, _MMA_CM, 3, 3, 3).permute(3, 1, 4, 5, 0, 2).reshape(3, nch, 9, cm, _MMA_CM)
    k2b = F.pad(k2.to(torch.bfloat16), (0, 0, 0, 0, 0, 0, 0, 0, 0, (8 if cout == 1 else cout) - cout))
    k2p = k2b.permute(2, 3, 4, 0, 1).reshape(27, -1, cm)
    return (F.pad(k1p, (0, _MMA_LD - _MMA_CM)).contiguous(),
            F.pad(k2p, (0, _MMA_LD - cm)).contiguous())


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
    if route == "tensor_cores":
        fn = lib.ecm_fused_conv3d_pair_mma
        fn.argtypes = [vp] * 9 + [i] * 10 + [vp]
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
    s1, b1, s2, b2 = (v.to(dev, torch.float32).contiguous() for v in (scale1, bias1, scale2, bias2))
    out = torch.empty(b, d, h, w, cout, dtype=x.dtype, device=dev)
    ctx_ptr = None if ctx is None else ctx.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    plan = pair_plan(x.dtype, b, d, h, w, cin, cm, cout)
    if plan.route == "tensor_cores":
        k1p, k2p = pack_pair_mma(k1.to(dev), k2.to(dev))
        status = _kernel(plan.route)(
            x.data_ptr(), k1p.data_ptr(), s1.data_ptr(), b1.data_ptr(),
            k2p.data_ptr(), s2.data_ptr(), b2.data_ptr(), ctx_ptr, out.data_ptr(),
            b, d, h, w, cin, cout, int(relu1), int(relu2), int(residual), plan.tile[0], stream,
        )
    else:
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
fused_conv3d_pair.route_launches = {"tensor_cores": 0, "cuda_cores": 0}
