"""Stacked-hourglass 3D cost aggregation with explicit context mapping
(port of ``ecm_tpu/models/aggregation.py``, standard NDHWC layout).

    cost0 = dres1(dres0(vol) [+ context0]) + dres0(vol) [+ context0]
    out_i, pre_i, post_i = hourglass_i(out_{i-1} [+ context_i], pre_1, post_{i-1}, cost0)
    cost = classif_last(out_last)              (eval: only the last head runs)

With ``fused`` on (or "auto" on a CUDA tensor), the stride-1 pairs run
through the fused CUDA kernel with inference-folded BN: dres0 with the
context0 map added in its epilogue, dres1 with its residual, and the last
classifier head. Parameters are the same in both modes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ecm_torch.models.context import ContextMapping
from ecm_torch.models.layers import ConvBN, ConvTransposeBN, conv, fold_bn
from ecm_torch.ops.cuda_fused_agg import fused_conv3d_pair


def _conv3(cin: int, cout: int, stride: int = 1, relu: bool = True) -> ConvBN:
    return ConvBN(cin, cout, 3, stride=stride, relu=relu, ndim=3)


class Hourglass(nn.Module):
    """One 3D encoder-decoder stage: (x, presqu, postsqu, residual) ->
    (out, pre, post); the internal width is 2C."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = _conv3(c, 2 * c, stride=2)
        self.conv2 = _conv3(2 * c, 2 * c, relu=False)
        self.conv3 = _conv3(2 * c, 2 * c, stride=2)
        self.conv4 = _conv3(2 * c, 2 * c)
        self.conv5 = ConvTransposeBN(2 * c, 2 * c)
        self.conv6 = ConvTransposeBN(2 * c, c)

    def forward(self, x, presqu=None, postsqu=None, residual=None):
        out = self.conv1(x)
        pre = self.conv2(out)
        pre = F.relu(pre + postsqu) if postsqu is not None else F.relu(pre)
        out = self.conv4(self.conv3(pre))
        post = F.relu(self.conv5(out) + (presqu if presqu is not None else pre))
        out = self.conv6(post)
        if residual is not None:
            out = out + residual
        return out, pre, post


class ClassifHead(nn.Module):
    """3D convbn-ReLU C -> C, then a 3D conv C -> 1 with bias: ``[B, D, H, W, 1]``."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = _conv3(c, c)
        self.conv2 = nn.Conv3d(c, 1, 3, padding=1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1.forward_cf(x.movedim(-1, 1))
        return conv(self.conv2, y).movedim(1, -1)


class ECMAggregation(nn.Module):
    """Volume ``[B, D, H, W, Cin]`` + context features ``[B, H, W, C]`` ->
    list of cost maps ``[B, D, H, W]`` (at eval, the last head only)."""

    def __init__(
        self,
        channels: int = 32,
        in_channels: int | None = None,
        num_hourglass: int = 3,
        context_fusion: str = "add",
        context_stages: tuple[int, ...] = (0, 1, 2, 3),
        layout: str = "standard",
        fused: str = "off",
    ):
        super().__init__()
        if layout != "standard":
            raise NotImplementedError(
                f"agg layout {layout!r}: only 'standard' (NDHWC) is ported; the "
                "grouped layout exists for the TPU's 128-lane tiles (ROADMAP)"
            )
        if fused not in ("off", "on", "auto"):
            raise ValueError(f"fused must be off|on|auto, got {fused!r}")
        c = channels
        self.fused = fused
        self.num_hourglass = num_hourglass
        self.context_fusion = context_fusion
        self.context_stages = tuple(context_stages)
        self.dres0_1 = _conv3(in_channels or 2 * c, c)
        self.dres0_2 = _conv3(c, c)
        self.dres1_1 = _conv3(c, c)
        self.dres1_2 = _conv3(c, c, relu=False)
        for stage in range(num_hourglass + 1):
            if context_fusion != "none" and stage in self.context_stages:
                self.add_module(
                    f"context{stage}",
                    ContextMapping(c, c, fusion=context_fusion),
                )
        for i in range(1, num_hourglass + 1):
            self.add_module(f"hourglass{i}", Hourglass(c))
        for i in range(1, num_hourglass + 1):
            self.add_module(f"classif{i}", ClassifHead(c))

    def _context(self, stage: int) -> ContextMapping | None:
        return getattr(self, f"context{stage}", None)

    def use_fused(self, volume: torch.Tensor) -> bool:
        return self.context_fusion in ("add", "none") and (
            self.fused == "on" or (self.fused == "auto" and volume.is_cuda)
        )

    def forward(self, volume: torch.Tensor, ctx2d: torch.Tensor) -> list[torch.Tensor]:
        if self.training:
            raise NotImplementedError("the training forward is not ported yet (ROADMAP queue 1)")
        fused = self.use_fused(volume)
        cm0 = self._context(0)
        if fused:
            ctx_map = cm0(ctx2d, return_map=True) if cm0 is not None else None
            x = fused_conv3d_pair(
                volume, *self._fold(self.dres0_1), *self._fold(self.dres0_2), ctx=ctx_map
            )
            cost0 = fused_conv3d_pair(
                x, *self._fold(self.dres1_1), *self._fold(self.dres1_2),
                relu2=False, residual=True,
            )
        else:
            x = self.dres0_2(self.dres0_1(volume))
            if cm0 is not None:
                x = cm0(ctx2d, x)
            cost0 = self.dres1_2(self.dres1_1(x)) + x

        inp, pre1, post = cost0, None, None
        for i in range(1, self.num_hourglass + 1):
            cmi = self._context(i)
            if cmi is not None:
                inp = cmi(ctx2d, inp)
            inp, pre, post = getattr(self, f"hourglass{i}")(
                inp, pre1, post if i > 1 else None, cost0
            )
            if i == 1:
                pre1 = pre

        head = getattr(self, f"classif{self.num_hourglass}")
        if fused:
            cost = fused_conv3d_pair(
                inp, *self._fold(head.conv1), head.conv2.weight,
                torch.ones(1, device=inp.device), head.conv2.bias, relu2=False,
            )
        else:
            cost = head(inp)
        return [cost.squeeze(-1)]

    @staticmethod
    def _fold(m: ConvBN) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return (m.conv.weight, *fold_bn(m.bn))
