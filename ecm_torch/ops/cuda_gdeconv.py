"""ConvTranspose3d (kernel 3, stride 2, padding 1, output padding 1: every
dim doubles) with a folded-BN affine, optional ReLU and an optional add: the
plain version and the wrapper of its CUDA kernel
(``ecm_torch/csrc/deconv3d_bn.cu``; replaces
``ecm_tpu/ops/pallas_gdeconv.py::gdeconv4_bn``, whose NDHWC function this is).

    out = relu?(conv_transpose(x, weight * scale) + bias) [+ add]

x ``[B, D, H, W, Cin]``; weight ``[Cin, Cout, 3, 3, 3]`` (torch's
ConvTranspose3d layout, as the weight bridge writes it); scale/bias
``[Cout]``. The scale is folded into the weight in x's dtype before the
product, as the TPU kernel folds it (``pallas_gdeconv.py:175``), so bf16
results agree; bias, ReLU and ``add`` (``[B, 2D, 2H, 2W, Cout]`` in x's
dtype) are applied in f32. Returns ``[B, 2D, 2H, 2W, Cout]`` in x's dtype.

On the card, bf16 with Cin a multiple of 8 (up to 64) and Cout up to 64 runs
on the tensor cores (``csrc/conv_wgmma.cuh`` in its transposed mode: a block
writes all eight output parity classes of an input tile, each over its legal
taps; f32 accumulation), tiled by ``cuda_gband.conv_plan``; f32, or another
Cin, on the CUDA cores. Every call folds and packs the weight anew.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ecm_torch.kernels.build import check, library
from ecm_torch.ops.cuda_gband import conv_plan, pack_conv_wgmma, pack_taps

_CO = 16  # output channels per thread in the kernel: weights are padded to it


def _fold(weight: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return weight.to(dtype) * scale.to(dtype).view(1, -1, 1, 1, 1)


def deconv3d_bn_torch(x, weight, scale, bias, add=None, *, relu=False):
    """Plain PyTorch version (CPU path and the kernel's reference)."""
    dt = x.dtype
    y = F.conv_transpose3d(
        x.movedim(-1, 1), _fold(weight, scale, dt), stride=2, padding=1, output_padding=1
    ).movedim(1, -1)
    y = y.float() + bias.float()
    if relu:
        y = y.clamp_min(0.0)
    if add is not None:
        y = y + add.float()
    return y.to(dt)


@functools.cache
def _kernel(tensor_cores: bool):
    vp, i = ctypes.c_void_p, ctypes.c_int
    if tensor_cores:
        fn = library("deconv3d_bn").ecm_deconv3d_bn_mma
        fn.argtypes = [vp] * 5 + [i] * 10 + [ctypes.c_longlong, vp]
    else:
        fn = library("deconv3d_bn").ecm_deconv3d_bn
        fn.argtypes = [i] + [vp] * 5 + [i] * 7 + [vp]
    fn.restype = ctypes.c_int
    return fn


def deconv3d_bn(x, weight, scale, bias, add=None, *, relu=False):
    """The transposed conv + affine [+ ReLU] [+ add] through the CUDA kernel
    for CUDA tensors; the plain version for CPU tensors. Counts its launches
    in ``.launches``."""
    if x.ndim != 5:
        raise ValueError(f"x must be [B, D, H, W, Cin], got {tuple(x.shape)}")
    b, d, h, w, cin = x.shape
    cout = weight.shape[1]
    if tuple(weight.shape) != (cin, cout, 3, 3, 3):
        raise ValueError(f"weight {tuple(weight.shape)} is not [{cin}, Cout, 3, 3, 3]")
    if scale.numel() != cout or bias.numel() != cout:
        raise ValueError(f"scale/bias of {scale.numel()}/{bias.numel()} for {cout} channels")
    if add is not None and (
        tuple(add.shape) != (b, 2 * d, 2 * h, 2 * w, cout) or add.dtype != x.dtype or add.device != x.device
    ):
        raise ValueError(
            f"add {tuple(add.shape)} {add.dtype} on {add.device} is not [B, 2D, 2H, 2W, Cout] "
            f"{x.dtype} on {x.device}"
        )
    if x.device.type == "cpu":
        return deconv3d_bn_torch(x, weight, scale, bias, add, relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"deconv3d_bn takes float32 or bfloat16, got {x.dtype}")
    for t in (x, add):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError("deconv3d_bn: x/add must be contiguous and 16-byte aligned")
    dev = x.device
    plan = conv_plan("transposed", x.dtype, b, d, h, w, cin, cout,
                     torch.cuda.get_device_properties(dev).multi_processor_count)
    tensor_cores = plan.route == "tensor_cores"
    # [Cin, Cout, k] -> the conv layout [Cout, Cin, k] that the packers read
    wf = _fold(weight, scale, x.dtype).transpose(0, 1)
    wp = (pack_conv_wgmma(wf) if tensor_cores else pack_taps(wf, x.dtype, _CO)).to(dev)
    bb = bias.to(dev, torch.float32).contiguous()
    out = torch.empty(b, 2 * d, 2 * h, 2 * w, cout, dtype=x.dtype, device=dev)
    args = (
        x.data_ptr(), wp.data_ptr(), bb.data_ptr(),
        None if add is None else add.data_ptr(), out.data_ptr(),
        b, d, h, w, cin, cout, int(relu),
    )
    stream = torch.cuda.current_stream(dev).cuda_stream
    if tensor_cores:
        status = _kernel(True)(*args, plan.sd, plan.ring, plan.blocks, plan.smem_bytes, stream)
    else:
        status = _kernel(False)(1 if x.dtype == torch.bfloat16 else 0, *args, stream)
    check(status, "deconv3d_bn")
    deconv3d_bn.launches += 1
    return out


deconv3d_bn.launches = 0
