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
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ecm_torch.kernels.build import check, library

# one block per output tile; the stage-1 intermediate over the tile and its
# one-voxel halo lives in shared memory, at most this many bytes
_TILE = (4, 8, 16)
_SMEM_LIMIT = 200 * 1024


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
def _kernel():
    fn = library("fused_conv3d_pair").ecm_fused_conv3d_pair
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i] + [vp] * 9 + [i] * 13 + [vp]
    fn.restype = ctypes.c_int
    return fn


def _pack(k: torch.Tensor, dtype: torch.dtype, pad_to: int) -> torch.Tensor:
    """[O, I, 3, 3, 3] -> f32 [27, I, O padded to pad_to], rounded to dtype
    first (the convs multiply in the input type's precision)."""
    o, i = k.shape[:2]
    kp = k.to(dtype).float().permute(2, 3, 4, 1, 0).reshape(27, i, o)
    return F.pad(kp, (0, -(-o // pad_to) * pad_to - o)).contiguous()


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
    """The fused pair through the CUDA kernel for CUDA tensors; the plain
    version for CPU tensors. Counts its launches in ``.launches``."""
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
    k1p = _pack(k1, x.dtype, 32).to(dev)
    k2p = _pack(k2, x.dtype, 1 if cout == 1 else 32).to(dev)
    s1, b1, s2, b2 = (v.to(dev, torch.float32).contiguous() for v in (scale1, bias1, scale2, bias2))
    td, th, tw = _tile(d, h, w, cm, x.element_size())
    out = torch.empty(b, d, h, w, cout, dtype=x.dtype, device=dev)
    status = _kernel()(
        1 if x.dtype == torch.bfloat16 else 0,
        x.data_ptr(), k1p.data_ptr(), s1.data_ptr(), b1.data_ptr(),
        k2p.data_ptr(), s2.data_ptr(), b2.data_ptr(),
        None if ctx is None else ctx.data_ptr(), out.data_ptr(),
        b, d, h, w, cin, cm, cout, int(relu1), int(relu2), int(residual),
        td, th, tw, torch.cuda.current_stream(dev).cuda_stream,
    )
    check(status, "fused_conv3d_pair")
    fused_conv3d_pair.launches += 1
    return out


fused_conv3d_pair.launches = 0
