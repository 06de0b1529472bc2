"""Eval BatchNorm as one epilogue pass over a convolution's fresh
channels-last output: the convolution's bias, the BatchNorm, the
activation and a residual sum (IGEV-Stereo's MobileNetV2 and ``BasicConv``,
and the BatchNorm ``MultiBasicEncoder``, ``cnet``, that RAFT-Stereo and
IGEV-Stereo share). The plain version and, for CUDA tensors, a Triton
kernel (``ops/_bn_act_triton.py``).

The pass computes, in float32,

    y <- post(res + act(((y + conv_bias) - running_mean) * weight * rsqrt(running_var + eps) + bias))

and rounds once to ``y``'s dtype, writing ``y`` in place; ``act`` is none,
ReLU, ReLU6 or LeakyReLU(0.01) (``ACTS``), ``res`` optional, ``post`` none
or ReLU. It reads the BatchNorm's four tensors and its ``eps`` at every call
and keeps no scale or shift, so a CUDA graph's replay sees a change to any
of them. :func:`norm_act` and :func:`conv_norm` are the models' sites: the
epilogue where the norm is an eval BatchNorm (:func:`is_eval_bn`), else the
module and torch's activation as published (instance norm, training mode).

Why a kernel: the library ran each site as two to five passes over the map
(the convolution's bias, cuDNN's NHWC ``bn_fw_inf`` at ~14 % of the card's
bandwidth, the activation, the sum, a second ReLU). The work is a few
operations an element, so the pass is bound by its bytes: the map read
once and written once, and ``res`` read once. No TPU kernel has this
function (the JAX package has neither model). Triton is imported only on
the CUDA branch: a machine without a GPU may have none.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

DTYPES = (torch.float16, torch.bfloat16, torch.float32)
SLOPE = 0.01  # LeakyReLU's, IGEV-Stereo's BasicConv
ACTS = {None: lambda t: t, "relu": F.relu, "relu6": F.relu6, "leaky_relu": lambda t: F.leaky_relu(t, SLOPE)}
POSTS = (None, "relu")
LAYOUTS = {4: torch.channels_last, 5: torch.channels_last_3d}
TILE = 4096  # elements of a program
LANES = 64  # widest run of channels a row of a program's tile takes


def is_eval_bn(norm: nn.Module) -> bool:
    """The switch of every site: a BatchNorm that is not training."""
    return isinstance(norm, (nn.BatchNorm2d, nn.BatchNorm3d)) and not norm.training


def lanes(channels: int) -> int:
    """The channels of a row of a program's tile: the largest power of two
    (at most ``LANES``) that divides ``channels``, so that a row is one
    pixel's run of consecutive channels. A program takes ``TILE // lanes``
    rows."""
    return min(channels & -channels, LANES)


def bn_act_torch(y: torch.Tensor, norm: nn.Module, conv_bias: torch.Tensor | None = None, act: str | None = None,
                 res: torch.Tensor | None = None, post: str | None = None) -> torch.Tensor:
    """Plain version: the same float32 expression, rounded once into ``y``."""
    shape = (1, -1) + (1,) * (y.ndim - 2)
    v = y.float()
    if conv_bias is not None:
        v = v + conv_bias.float().view(shape)
    scale = norm.weight.float() * torch.rsqrt(norm.running_var.float() + norm.eps)
    v = (v - norm.running_mean.float().view(shape)) * scale.view(shape) + norm.bias.float().view(shape)
    v = ACTS[act](v)
    if res is not None:
        v = res.float() + v
    return y.copy_(ACTS[post](v))


def _check(y, norm, conv_bias, act, res, post) -> None:
    if act not in ACTS or post not in POSTS:
        raise ValueError(f"bn_act: act {act!r} not one of {list(ACTS)}, or post {post!r} not one of {POSTS}")
    if not is_eval_bn(norm) or norm.running_mean is None or norm.weight is None:
        raise ValueError(f"bn_act takes an affine BatchNorm in eval with running statistics, not {norm}")
    if y.dtype not in DTYPES:
        raise ValueError(f"bn_act: y is {y.dtype}, not one of {DTYPES}")
    if y.ndim not in LAYOUTS or not y.is_contiguous(memory_format=LAYOUTS[y.ndim]):
        raise ValueError(f"bn_act takes a channels-last [B, C, H, W] or [B, C, D, H, W] map, not {tuple(y.shape)} "
                         f"of strides {y.stride()}")
    vectors = [norm.running_mean, norm.running_var, norm.weight, norm.bias] + [conv_bias] * (conv_bias is not None)
    for t in [*vectors, res]:
        if t is not None and t.device != y.device:
            raise ValueError(f"bn_act: a tensor on {t.device}, y on {y.device}")
    if any(t.shape != (y.shape[1],) or not t.is_contiguous() for t in vectors):
        raise ValueError(f"bn_act: the BatchNorm's and the bias's vectors must be contiguous of {y.shape[1]}")
    if res is not None and (res.shape != y.shape or res.dtype != y.dtype
                            or not res.is_contiguous(memory_format=LAYOUTS[y.ndim])):
        raise ValueError(f"bn_act: res {tuple(res.shape)} {res.dtype} of strides {res.stride()} is not y's shape, "
                         f"dtype and layout ({tuple(y.shape)} {y.dtype})")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in [y, *vectors, res]):
        raise RuntimeError("bn_act: the kernel has no backward (these models' training is not ported); call it "
                           "under torch.inference_mode or torch.no_grad")


def bn_act(y: torch.Tensor, norm: nn.Module, conv_bias: torch.Tensor | None = None, act: str | None = None,
           res: torch.Tensor | None = None, post: str | None = None) -> torch.Tensor:
    """The epilogue on ``y``, in place, returned: the kernel for a CUDA
    tensor, the plain version for a CPU (or ``meta``) one. Counts its
    launches in ``.launches``."""
    if y.device.type != "cuda":
        return bn_act_torch(y, norm, conv_bias, act, res, post)
    _check(y, norm, conv_bias, act, res, post)
    from ecm_torch.ops import _bn_act_triton as k

    c, n = y.shape[1], y.numel()
    run = lanes(c)
    if n // run >= 2**31:
        raise ValueError(f"bn_act: {n} elements in runs of {run}: more runs than int32 counts")
    k.bn_act_kernel[(-(-n // TILE),)](
        y, y if res is None else res, y if conv_bias is None else conv_bias, norm.running_mean, norm.running_var,
        norm.weight, norm.bias, norm.eps, n // run, c // run,
        ACT=list(ACTS).index(act), HAS_RES=res is not None, POST=POSTS.index(post), HAS_BIAS=conv_bias is not None,
        ROWS=TILE // run, LANES=run, num_warps=4)
    bn_act.launches += 1
    return y


bn_act.launches = 0


def norm_act(y: torch.Tensor, norm: nn.Module, act: str | None = None, res: torch.Tensor | None = None,
             post: str | None = None, conv_bias: torch.Tensor | None = None) -> torch.Tensor:
    """``post(res + act(norm(y + conv_bias)))``: one :func:`bn_act` where
    ``norm`` is an eval BatchNorm, else the module and torch's ops as
    published, where the convolution has added its own bias
    (``conv_bias`` None)."""
    if is_eval_bn(norm):
        return bn_act(y, norm, conv_bias, act, res, post)
    if conv_bias is not None:
        raise ValueError("norm_act: a norm other than an eval BatchNorm leaves the bias to its convolution")
    y = ACTS[act](norm(y))
    return ACTS[post](y if res is None else res + y)


def conv_norm(m: nn.Conv2d, norm: nn.Module, x: torch.Tensor, act: str | None = None,
              res: torch.Tensor | None = None, post: str | None = None) -> torch.Tensor:
    """The 2-D convolution ``m`` of ``x``, then :func:`norm_act`: bias-free
    where the epilogue takes ``m``'s bias (an eval BatchNorm), biased
    where the norm runs as published."""
    fused = is_eval_bn(norm)
    y = F.conv2d(x, m.weight, None if fused else m.bias, m.stride, m.padding)
    return norm_act(y, norm, act, res, post, m.bias if fused else None)
