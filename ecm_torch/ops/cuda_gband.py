"""3x3x3 convolutions with zero padding 1, stride 1 or 2, a folded-BN affine,
optional ReLU and an optional post-activation add: the plain versions and the
wrappers of their CUDA kernel (``ecm_torch/csrc/conv3d_bn.cu``; replaces
``ecm_tpu/ops/pallas_gband.py::gband_conv_bn_s1`` and ``::gband_down_conv_bn``,
whose NDHWC functions these are).

    out = relu?(conv(x, weight) * scale + bias) [+ add]

x ``[B, D, H, W, Cin]``; weight ``[Cout, Cin, 3, 3, 3]`` (torch layout), cast
to x's dtype; scale/bias ``[Cout]`` (folded BN), applied in f32; ``add``
(stride 1 only, in x's dtype) is a residual ``[B, D, H, W, Cout]`` or a
context map ``[B, 1, H, W, Cout]`` broadcast over D, added in f32. Returns
``[B, Do, Ho, Wo, Cout]`` in x's dtype, ``Do = (D - 1) // stride + 1``.

On the card, bf16 with Cin a multiple of 8 (up to 64) and Cout up to 64 runs
on the tensor cores (``csrc/conv_wgmma.cuh``: persistent blocks with the
weights resident in shared memory, wgmma, f32 accumulation), tiled by
:func:`conv_plan`; f32, or another Cin, on the CUDA cores. Every call packs
the weights anew, so a CUDA graph that captures it packs them at each
replay from the weights as they are then.

:func:`gband_conv_s1` is the training path's differentiable conv (replaces
``ecm_tpu/ops/pallas_gband.py::gband_conv_s1`` and its custom VJP): the
forward and the input gradient run the same kernel, the weight gradient goes
to cuDNN, as it goes to XLA outside any Pallas kernel in JAX.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ecm_torch.kernels.build import check, library

_CO = 16  # output channels per thread of the CUDA-core kernel: weights are padded to it
_VX = 4  # output voxels per thread of the CUDA-core kernel
SMEM_PER_BLOCK = 232_448  # dynamic shared memory an H100 block may have
H100_SMS = 132
# the tensor-core core (csrc/conv_wgmma.cuh): mbarriers ahead of the weights,
# at most _MAX_RING ring slots; a work item's (H, W) tile by mode (outputs;
# inputs for "transposed") and the input planes one step reads
_BAR_BYTES = 128
_MAX_RING = 8
_TILE = {"s1": (2, 64), "s2": (1, 64), "transposed": (2, 64)}
_NEED = {"s1": 3, "s2": 3, "transposed": 2}


class ConvPlan(NamedTuple):
    """How one call of the conv kernels runs. ``route``: "tensor_cores" or
    "cuda_cores". Tensor cores: a work item is a ``tile`` (H, W) of outputs
    (of inputs for "transposed") and ``sd`` steps along D (output planes; input
    planes for "transposed"); ``blocks`` persistent blocks of ``threads`` walk
    the ``items``, each with ``smem_bytes`` of shared memory: the weights
    (``cin_pad`` x ``cout_pad`` x 27 bf16) and a ``ring`` of input planes.
    CUDA cores: one thread per 4 output voxels and 16 channels."""

    route: str
    tile: tuple[int, int]
    sd: int
    ring: int
    items: int
    blocks: int
    threads: int
    smem_bytes: int
    cin_pad: int
    cout_pad: int


def _cout_pad(cout: int) -> int:
    return 16 if cout <= 16 else 32 if cout <= 32 else 64


def _halo_rows(mode: str, th: int, tw: int) -> int:
    """Input rows of one ring slot: the tile and its halo."""
    if mode == "s1":
        return (th + 2) * (tw + 2)
    if mode == "s2":
        return (2 * th + 1) * (2 * tw + 1)
    return (th + 1) * (tw + 1)


def _smem(mode: str, cin_pad: int, cout_pad: int, ring: int) -> int:
    rows = _halo_rows(mode, *_TILE[mode])
    return _BAR_BYTES + 27 * cin_pad * cout_pad * 2 + ring * rows * cin_pad * 2


def conv_route(mode: str, dtype: torch.dtype, cin: int, cout: int) -> str:
    """``"tensor_cores"`` for bf16 with Cin % 8 == 0, Cin <= 64 and Cout <=
    64 where the weights and the smallest ring fit in a block's shared
    memory; else ``"cuda_cores"``."""
    if dtype != torch.bfloat16 or cin % 8 or cin > 64 or not 1 <= cout <= 64:
        return "cuda_cores"
    cin_pad = -(-cin // 16) * 16
    if _smem(mode, cin_pad, _cout_pad(cout), _NEED[mode]) > SMEM_PER_BLOCK:
        return "cuda_cores"
    return "tensor_cores"


@functools.lru_cache(maxsize=256)
def conv_plan(
    mode: str, dtype: torch.dtype, b: int, d: int, h: int, w: int, cin: int, cout: int,
    sms: int = H100_SMS,
) -> ConvPlan:
    """The route and tiling of one conv kernel call: ``mode`` "s1", "s2"
    (stride 2) or "transposed", x ``[b, d, h, w, cin]``. The ring takes as
    many slots as fit, up to two more than one step reads; the D slab ``sd``
    minimises the rounds of ``blocks`` (at most one per SM) times the planes
    an item computes (plus one for its pipeline fill)."""
    if mode not in _TILE:
        raise ValueError(f"mode {mode!r} is not one of {sorted(_TILE)}")
    route = conv_route(mode, dtype, cin, cout)
    if mode == "s2":
        do, ho, wo = (d - 1) // 2 + 1, (h - 1) // 2 + 1, (w - 1) // 2 + 1
    elif mode == "s1":
        do, ho, wo = d, h, w
    else:
        do, ho, wo = 2 * d, 2 * h, 2 * w
    if route == "cuda_cores":
        groups = b * do * ho * -(-wo // _VX)
        blocks = -(-groups // 128) * -(-cout // _CO)
        return ConvPlan(route, (1, _VX), 1, 0, blocks, blocks, 128, 0, cin, -(-cout // _CO) * _CO)
    th, tw = _TILE[mode]
    steps, tiled = (d, (h, w)) if mode == "transposed" else (do, (ho, wo))
    tiles = b * -(-tiled[0] // th) * -(-tiled[1] // tw)
    best = None
    for sd in sorted({-(-steps // n) for n in range(1, steps + 1)}, reverse=True):
        items = tiles * -(-steps // sd)
        blocks = min(items, sms)
        cost = -(-items // blocks) * (sd + 1)
        if best is None or cost < best[0]:
            best = (cost, sd, items, blocks)
    _, sd, items, blocks = best
    cin_pad, cout_pad = -(-cin // 16) * 16, _cout_pad(cout)
    ring = max(r for r in range(_NEED[mode], min(_NEED[mode] + 2, _MAX_RING) + 1)
               if _smem(mode, cin_pad, cout_pad, r) <= SMEM_PER_BLOCK)
    return ConvPlan(route, (th, tw), sd, ring, items, blocks, 128 * (th + 1),
                    _smem(mode, cin_pad, cout_pad, ring), cin_pad, cout_pad)


def pack_taps(k: torch.Tensor, dtype: torch.dtype, pad_to: int) -> torch.Tensor:
    """Conv weight ``[O, I, 3, 3, 3]`` -> f32 ``[27, I, O padded to pad_to]``
    (tap = (kd * 3 + kh) * 3 + kw), rounded to ``dtype`` first: the kernels
    multiply in the input type's precision and accumulate in f32."""
    o, i = k.shape[:2]
    kp = k.to(dtype).float().permute(2, 3, 4, 1, 0).reshape(27, i, o)
    return F.pad(kp, (0, -(-o // pad_to) * pad_to - o)).contiguous()


def conv3d_bn_torch(x, weight, scale, bias, add=None, *, stride=1, relu=True):
    """Plain PyTorch version (CPU path and the kernel's reference)."""
    dt = x.dtype
    y = F.conv3d(x.movedim(-1, 1), weight.to(dt), stride=stride, padding=1).movedim(1, -1)
    y = y.float() * scale.float() + bias.float()
    if relu:
        y = y.clamp_min(0.0)
    if add is not None:
        y = y + add.float()
    return y.to(dt)


def _check(x, weight, scale, bias, add, stride):
    if x.ndim != 5:
        raise ValueError(f"x must be [B, D, H, W, Cin], got {tuple(x.shape)}")
    b, d, h, w, cin = x.shape
    cout = weight.shape[0]
    if tuple(weight.shape) != (cout, cin, 3, 3, 3):
        raise ValueError(f"weight {tuple(weight.shape)} is not [Cout, {cin}, 3, 3, 3]")
    if scale is not None and (scale.numel() != cout or bias.numel() != cout):
        raise ValueError(f"scale/bias of {scale.numel()}/{bias.numel()} for {cout} channels")
    if add is not None:
        if stride != 1:
            raise ValueError("add is taken only by the stride-1 conv")
        if add.ndim != 5 or add.shape[1] not in (1, d) or tuple(add.shape) != (b, add.shape[1], h, w, cout):
            raise ValueError(f"add {tuple(add.shape)} is not [B, D or 1, H, W, Cout] for {tuple(x.shape)}")
        if add.dtype != x.dtype or add.device != x.device:
            raise ValueError(f"add is {add.dtype} on {add.device}, x is {x.dtype} on {x.device}")


@functools.cache
def _kernel(tensor_cores: bool):
    vp, i = ctypes.c_void_p, ctypes.c_int
    if tensor_cores:
        fn = library("conv3d_bn").ecm_conv3d_bn_mma
        fn.argtypes = [i] + [vp] * 6 + [i] * 11 + [ctypes.c_longlong, vp]
    else:
        fn = library("conv3d_bn").ecm_conv3d_bn
        fn.argtypes = [i, i] + [vp] * 6 + [i] * 8 + [vp]
    fn.restype = ctypes.c_int
    return fn


def pack_conv_wgmma(weight: torch.Tensor, cout_pad: int | None = None) -> torch.Tensor:
    """Conv weight ``[O, I, 3, 3, 3]`` -> the tensor-core core's B operand,
    bf16 ``[27, I_pad / 16, O_pad / 8, 2, 8, 8]``: per tap and 16 input
    channels, wgmma's K-major 8 x 8 core matrices ``[o // 8][(i % 16) // 8]
    [o % 8][i % 8]`` (I_pad = I rounded up to 16, O_pad ``cout_pad`` or else
    16, 32 or 64; zero in the pads)."""
    o, i = weight.shape[:2]
    cin_pad, cout_pad = -(-i // 16) * 16, cout_pad or _cout_pad(o)
    kp = weight.to(torch.bfloat16).permute(2, 3, 4, 1, 0).reshape(27, i, o)
    kp = F.pad(kp, (0, cout_pad - o, 0, cin_pad - i))
    return kp.reshape(27, cin_pad // 16, 2, 8, cout_pad // 8, 8).permute(0, 1, 4, 2, 5, 3).contiguous()


def _launch(x, weight, scale, bias, add, stride, relu, what, *, flip=False):
    """The kernel on CUDA tensors. ``flip``: convolve with ``weight`` flipped
    in (d, h, w) and transposed in (in, out) (the input gradient)."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what} takes float32 or bfloat16, got {x.dtype}")
    for t in (x, add):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{what}: x/add must be contiguous and 16-byte aligned")
    dev = x.device
    b, d, h, w, cin = x.shape
    cout = weight.shape[1] if flip else weight.shape[0]
    plan = conv_plan("s1" if stride == 1 else "s2", x.dtype, b, d, h, w, cin, cout,
                     torch.cuda.get_device_properties(dev).multi_processor_count)
    tensor_cores = plan.route == "tensor_cores"
    wt = weight.flip(2, 3, 4).transpose(0, 1) if flip else weight
    wp = (pack_conv_wgmma(wt) if tensor_cores else pack_taps(wt, x.dtype, _CO)).to(dev)
    s, bb = (v.to(dev, torch.float32).contiguous() for v in (scale, bias))
    out = torch.empty(
        b, (d - 1) // stride + 1, (h - 1) // stride + 1, (w - 1) // stride + 1, cout,
        dtype=x.dtype, device=dev,
    )
    args = (
        x.data_ptr(), wp.data_ptr(), s.data_ptr(), bb.data_ptr(),
        None if add is None else add.data_ptr(), out.data_ptr(),
        b, d, h, w, cin, cout, 0 if add is None else add.shape[1], int(relu),
    )
    stream = torch.cuda.current_stream(dev).cuda_stream
    if tensor_cores:
        status = _kernel(True)(stride, *args, plan.sd, plan.ring, plan.blocks, plan.smem_bytes, stream)
    else:
        status = _kernel(False)(1 if x.dtype == torch.bfloat16 else 0, stride, *args, stream)
    check(status, what)
    return out


def conv3d_bn_s1(x, weight, scale, bias, add=None, *, relu=True):
    """Stride-1 conv + affine [+ ReLU] [+ add] through the CUDA kernel for
    CUDA tensors; the plain version for CPU tensors. Counts its launches in
    ``.launches``."""
    _check(x, weight, scale, bias, add, 1)
    if x.device.type == "cpu":
        return conv3d_bn_torch(x, weight, scale, bias, add, stride=1, relu=relu)
    out = _launch(x, weight, scale, bias, add, 1, relu, "conv3d_bn_s1")
    conv3d_bn_s1.launches += 1
    return out


def conv3d_bn_down(x, weight, scale, bias, *, relu=True):
    """Stride-2 conv + affine [+ ReLU] through the CUDA kernel for CUDA
    tensors; the plain version for CPU tensors. Counts its launches in
    ``.launches``."""
    _check(x, weight, scale, bias, None, 2)
    if x.device.type == "cpu":
        return conv3d_bn_torch(x, weight, scale, bias, stride=2, relu=relu)
    out = _launch(x, weight, scale, bias, None, 2, relu, "conv3d_bn_down")
    conv3d_bn_down.launches += 1
    return out


conv3d_bn_s1.launches = 0
conv3d_bn_down.launches = 0


def gband_conv_s1_torch(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gband_conv_s1`'s forward: the NDHWC 3x3x3 conv,
    stride 1, zero padding 1, weight cast to x's dtype."""
    return F.conv3d(x.movedim(-1, 1), weight.to(x.dtype), padding=1).movedim(1, -1)


@functools.cache
def unit_affine(cout: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """A scale of ones and a bias of zeros, f32, made once per (cout, device)
    and never evicted: a captured CUDA graph reads them by address."""
    with torch.inference_mode(False):
        return torch.ones(cout, device=device), torch.zeros(cout, device=device)


def _conv_s1(x: torch.Tensor, weight: torch.Tensor, what: str, flip: bool = False) -> torch.Tensor:
    """The conv on x's device: the kernel (scale 1, bias 0, no ReLU) for a
    CUDA tensor, the plain version for a CPU one. ``flip``: with the weight
    flipped in (d, h, w) and transposed in (in, out)."""
    if x.device.type == "cpu":
        return gband_conv_s1_torch(x, weight.flip(2, 3, 4).transpose(0, 1) if flip else weight)
    ones, zeros = unit_affine(weight.shape[1] if flip else weight.shape[0], x.device)
    return _launch(x, weight, ones, zeros, None, 1, False, what, flip=flip)


def gband_conv_s1_input_grad(dy: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The input gradient of :func:`gband_conv_s1` (``pallas_gband.py:988-991``):
    the same conv of dy ``[B, D, H, W, Cout]`` with the kernel flipped in
    (d, h, w) and transposed in (in, out). The kernel for a contiguous CUDA
    dy (counted in ``gband_conv_s1.backward_launches``), the plain version
    for a CPU one."""
    dx = _conv_s1(dy, weight, "gband_conv_s1 input grad", flip=True)
    if dy.is_cuda:
        gband_conv_s1.backward_launches += 1
    return dx


def _contiguous(t: torch.Tensor) -> torch.Tensor:
    """The kernel reads whole channel rows: a strided x or dy is copied once
    (counted in ``gband_conv_s1.copies``)."""
    if t.is_contiguous():
        return t
    gband_conv_s1.copies += 1
    return t.contiguous()


class _GbandConvS1(torch.autograd.Function):
    """Stride-1 conv with the VJP of ``pallas_gband.py:979-1018``: dx is the
    same conv of dy with the kernel flipped in (d, h, w) and transposed in
    (in, out); dw is cuDNN's weight gradient (XLA's in JAX)."""

    @staticmethod
    def forward(ctx, x, weight):
        x = _contiguous(x)
        ctx.save_for_backward(x, weight)
        out = _conv_s1(x, weight, "gband_conv_s1")
        if x.is_cuda:
            gband_conv_s1.launches += 1
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dy = _contiguous(dy)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = gband_conv_s1_input_grad(dy, weight)
        if ctx.needs_input_grad[1]:
            dw = torch.ops.aten.convolution_backward(
                dy.movedim(-1, 1), x.movedim(-1, 1), weight, None, [1, 1, 1], [1, 1, 1],
                [1, 1, 1], False, [0, 0, 0], 1, [False, True, False],
            )[1]
        return dx, dw


def gband_conv_s1(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Differentiable NDHWC 3x3x3 conv, stride 1, pad 1, no BN and no ReLU:
    x ``[B, D, H, W, Cin]``, weight ``[Cout, Cin, 3, 3, 3]`` (cast to x's
    dtype, so its gradient comes back in the weight's dtype). A CUDA tensor
    runs the kernel forward (``.launches``) and for the input gradient
    (``.backward_launches``); a CPU tensor the plain version both ways.
    ``.copies`` counts the copies of a strided x or dy."""
    _check(x, weight, None, None, None, 1)
    return _GbandConvS1.apply(x, weight.to(x.dtype))


gband_conv_s1.launches = 0
gband_conv_s1.backward_launches = 0
gband_conv_s1.copies = 0
