"""Conv/BN building blocks (port of ``ecm_tpu/models/layers.py``).

Every module takes and returns channels-last tensors (NHWC for 2D, NDHWC for
3D) and runs torch's channels-first ops on a permuted view. Parameters stay
f32; convolutions cast their weights to the activation dtype (bf16 on the
serving path), and BatchNorm computes in f32 from f32 statistics, as the JAX
modules do. Padding is explicit, ``dilation * (k // 2)``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# single source of truth for the BatchNorm epsilon (torch default), shared by
# the BN modules and the eval-time BN folds of the fused aggregation path
BN_EPS = 1e-5

_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def _trunc_normal_(t: torch.Tensor, fan: int, scale: float, gen: torch.Generator) -> None:
    std = math.sqrt(scale / fan) / _TRUNC_STD
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initialisation, drawn from ``generator``: He-normal
    fan_out (truncated) for convolutions, LeCun-normal fan_in for linear
    layers, zero biases, identity BatchNorm."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d)):
            _trunc_normal_(m.weight, m.out_channels * math.prod(m.kernel_size), 2.0, generator)
        elif isinstance(m, nn.Linear):
            _trunc_normal_(m.weight, m.in_features, 1.0, generator)
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
            continue
        else:
            continue
        if m.bias is not None:
            m.bias.zero_()


def _w(p: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor | None:
    return None if p is None else p.to(dtype)


def conv(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply conv module ``m`` to channels-first ``x`` with its weights cast
    to ``x``'s dtype."""
    w, b = _w(m.weight, x.dtype), _w(m.bias, x.dtype)
    if isinstance(m, nn.ConvTranspose3d):
        return F.conv_transpose3d(
            x, w, b, m.stride, m.padding, m.output_padding, m.groups, m.dilation
        )
    fn = F.conv3d if isinstance(m, nn.Conv3d) else F.conv2d
    return fn(x, w, b, m.stride, m.padding, m.dilation, m.groups)


def linear(m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, _w(m.weight, x.dtype), _w(m.bias, x.dtype))


def fold_bn(bn: nn.modules.batchnorm._BatchNorm) -> tuple[torch.Tensor, torch.Tensor]:
    """Inference-fold a BatchNorm into per-channel f32 (scale, bias)."""
    scale = bn.weight / torch.sqrt(bn.running_var + BN_EPS)
    return scale, bn.bias - bn.running_mean * scale


class ConvBN(nn.Module):
    """Bias-free conv (2D or 3D) + BatchNorm, optional ReLU."""

    def __init__(
        self, cin: int, cout: int, kernel_size: int = 3, stride: int = 1,
        dilation: int = 1, relu: bool = True, ndim: int = 2,
    ):
        super().__init__()
        conv_cls = nn.Conv2d if ndim == 2 else nn.Conv3d
        bn_cls = nn.BatchNorm2d if ndim == 2 else nn.BatchNorm3d
        self.conv = conv_cls(
            cin, cout, kernel_size, stride=stride, padding=dilation * (kernel_size // 2),
            dilation=dilation, bias=False,
        )
        self.bn = bn_cls(cout, eps=BN_EPS, momentum=0.1)
        self.relu = relu

    def forward_cf(self, x: torch.Tensor) -> torch.Tensor:
        """Channels-first in, channels-first out."""
        y = self.bn(conv(self.conv, x))
        return F.relu(y) if self.relu else y

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_cf(x.movedim(-1, 1)).movedim(1, -1)


class ConvTransposeBN(nn.Module):
    """ConvTranspose3d(k=3, s=2, p=1, op=1), which doubles each dim, + BN."""

    def __init__(self, cin: int, cout: int, relu: bool = False):
        super().__init__()
        self.deconv = nn.ConvTranspose3d(
            cin, cout, 3, stride=2, padding=1, output_padding=1, bias=False
        )
        self.bn = nn.BatchNorm3d(cout, eps=BN_EPS, momentum=0.1)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn(conv(self.deconv, x.movedim(-1, 1)))
        return (F.relu(y) if self.relu else y).movedim(1, -1)


class BasicBlock(nn.Module):
    """Residual block: convbn-ReLU, convbn, plus the identity or a strided
    1x1-conv shortcut; no final ReLU (the PSMNet-family quirk)."""

    def __init__(self, cin: int, cout: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        self.conv1 = ConvBN(cin, cout, stride=stride, dilation=dilation, relu=True)
        self.conv2 = ConvBN(cout, cout, stride=1, dilation=dilation, relu=False)
        self.downsample = (
            nn.Conv2d(cin, cout, 1, stride=stride, bias=False)
            if stride != 1 or cin != cout
            else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xc = x.movedim(-1, 1)
        out = self.conv2.forward_cf(self.conv1.forward_cf(xc))
        if self.downsample is not None:
            xc = conv(self.downsample, xc)
        return (out + xc).movedim(1, -1)
