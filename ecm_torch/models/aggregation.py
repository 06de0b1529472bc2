"""Stacked-hourglass 3D cost aggregation with explicit context mapping
(port of ``ecm_tpu/models/aggregation.py``; every volume is NDHWC).

    cost0 = dres1(dres0(vol) [+ context0]) + dres0(vol) [+ context0]
    out_i, pre_i, post_i = hourglass_i(out_{i-1} [+ context_i], pre_1, post_{i-1}, cost0)
    cost = classif_last(out_last)              (eval: only the last head runs)
    cost_i = classif_i(out_i) + cost_{i-1}     (training: every head, chained)

Training (JAX's non-fused branch, ``aggregation.py:343-415``) runs the
module chain with batch-statistics BatchNorm and every hourglass plain (under
``remat`` when it is on). In the "grouped" layout the stride-1 convs of the
full-resolution stack (the four dres convs and each head's conv1) go through
``gband_conv_s1``, forward and input gradient, as ``GConv3D`` routes them in
JAX; no eval kernel runs.

Three eval paths, one set of parameters, BN folded for inference where a
kernel runs:

- ``layout="standard"``, ``fused`` off: cuDNN convolutions throughout.
- ``layout="standard"`` with ``fused`` on (or "auto" on a CUDA tensor): the
  stride-1 pairs run through the fused pair kernel: dres0 with the context0
  map in its epilogue, dres1 with its residual, and the last classifier.
- ``layout="grouped"``: the JAX package's grouped eval dispatch, computed on
  NDHWC tensors (the disparity-folded layout itself exists for the TPU's
  lanes): the four dres convs one by one through ``conv3d_bn_s1`` (context0
  map fused into dres0_2, the residual into dres1_2), each hourglass's conv1
  through ``conv3d_bn_down`` and conv6 with its ``+ cost0`` through
  ``deconv3d_bn``, and the last classifier through the fused pair kernel.
  ``fused`` is ignored, as in JAX.

Under a mesh with a disparity axis every 3D conv form runs on this rank's
slab of the disparities, at each level of the hourglasses, in training as
at eval: the modules through ``ConvBN``/``ConvTransposeBN``, the eval
kernels here through the
``ecm_torch.parallel.halo`` form of their D arithmetic (``slab_s1`` with a
halo of 1 for a conv, 2 for a fused pair; ``slab_down``; ``slab_up``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ecm_torch.models.context import ContextMapping
from ecm_torch.models.layers import ConvBN, ConvTransposeBN, conv, fold_bn, remat
from ecm_torch.ops.cuda_fused_agg import fused_conv3d_pair
from ecm_torch.ops.cuda_gband import conv3d_bn_down, conv3d_bn_s1, unit_affine
from ecm_torch.ops.cuda_gdeconv import deconv3d_bn
from ecm_torch.parallel.halo import slab_down, slab_s1, slab_up

LAYOUTS = ("standard", "grouped")


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

    def forward(self, x, presqu=None, postsqu=None, residual=None, kernels=False):
        """``kernels``: conv1 through ``conv3d_bn_down`` and conv6 with the
        residual through ``deconv3d_bn`` (the grouped layout's dispatch);
        conv2 to conv5 stay on cuDNN, as they stay on XLA in JAX."""
        if kernels:
            c1 = self.conv1
            out = slab_down(lambda v: conv3d_bn_down(v, c1.conv.weight, *fold_bn(c1.bn), relu=c1.relu), x)
        else:
            out = self.conv1(x)
        pre = self.conv2(out)
        pre = F.relu(pre + postsqu) if postsqu is not None else F.relu(pre)
        out = self.conv4(self.conv3(pre))
        post = F.relu(self.conv5(out) + (presqu if presqu is not None else pre))
        if kernels:
            c6 = self.conv6

            def conv6(v, add=None):
                return deconv3d_bn(v, c6.deconv.weight, *fold_bn(c6.bn), add, relu=c6.relu)

            return slab_up(conv6, post, residual), pre, post
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

    def forward(self, x: torch.Tensor, gband: bool = False) -> torch.Tensor:
        """``gband``: conv1 through ``gband_conv_s1`` (training, grouped)."""
        y = self.conv1(x, gband=gband)
        return slab_s1(lambda v: conv(self.conv2, v.movedim(-1, 1)).movedim(1, -1), y)


class ECMAggregation(nn.Module):
    """Volume ``[B, D, H, W, Cin]`` + context features ``[B, H, W, C]`` ->
    list of cost maps ``[B, D, H, W]`` (at eval, the last head only; in
    training, one per head). ``remat``: each hourglass under activation
    checkpointing in training, as ``nn.remat`` wraps it in JAX."""

    def __init__(
        self,
        channels: int = 32,
        in_channels: int | None = None,
        num_hourglass: int = 3,
        context_fusion: str = "add",
        context_stages: tuple[int, ...] = (0, 1, 2, 3),
        fused: str = "off",
        remat: bool = True,
    ):
        super().__init__()
        if fused not in ("off", "on", "auto"):
            raise ValueError(f"fused must be off|on|auto, got {fused!r}")
        c = channels
        self.fused = fused
        self.remat = remat
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

    def forward(
        self, volume: torch.Tensor, ctx2d: torch.Tensor, layout: str = "standard"
    ) -> list[torch.Tensor]:
        if layout not in LAYOUTS:
            raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
        train = self.training
        kernels = layout == "grouped"
        fused = not train and not kernels and self.use_fused(volume)
        cm0 = self._context(0)
        if kernels and not train:
            cost0 = self._dres_kernels(volume, ctx2d)
        elif fused:
            ctx_map = cm0(ctx2d, return_map=True) if cm0 is not None else None
            x = slab_s1(lambda v: fused_conv3d_pair(
                v, *self._fold(self.dres0_1), *self._fold(self.dres0_2), ctx=ctx_map
            ), volume, halo=2)
            cost0 = slab_s1(lambda v: fused_conv3d_pair(
                v, *self._fold(self.dres1_1), *self._fold(self.dres1_2),
                relu2=False, residual=True,
            ), x, halo=2)
        else:  # the module chain: eval "standard", or training on either layout
            x = self.dres0_2(self.dres0_1(volume, gband=kernels), gband=kernels)
            if cm0 is not None:
                x = cm0(ctx2d, x)
            cost0 = self.dres1_2(self.dres1_1(x, gband=kernels), gband=kernels) + x

        checkpointed = train and self.remat and torch.is_grad_enabled()
        outs, inp, pre1, post = [], cost0, None, None
        for i in range(1, self.num_hourglass + 1):
            cmi = self._context(i)
            if cmi is not None:
                inp = cmi(ctx2d, inp)
            hg = getattr(self, f"hourglass{i}")
            args = (inp, pre1, post if i > 1 else None, cost0)
            if checkpointed:
                inp, pre, post = remat(hg, *args)
            else:
                inp, pre, post = hg(*args, kernels=kernels and not train)
            if i == 1:
                pre1 = pre
            outs.append(inp)

        if train:
            costs, prev = [], None
            for i, out in enumerate(outs, 1):
                cost = getattr(self, f"classif{i}")(out, gband=kernels)
                if prev is not None:
                    cost = cost + prev
                prev = cost
                costs.append(cost.squeeze(-1))
            return costs
        head = getattr(self, f"classif{self.num_hourglass}")
        if fused or kernels:
            cost = slab_s1(lambda v: fused_conv3d_pair(
                v, *self._fold(head.conv1), head.conv2.weight,
                unit_affine(1, v.device)[0], head.conv2.bias, relu2=False,
            ), inp, halo=2)
        else:
            cost = head(inp)
        return [cost.squeeze(-1)]

    def _dres_kernels(self, volume: torch.Tensor, ctx2d: torch.Tensor) -> torch.Tensor:
        """dres0 and dres1 conv by conv through ``conv3d_bn_s1`` (JAX
        ``aggregation.py:300-342``): the context0 map ("add" fusion) in
        dres0_2's epilogue, the dres1 residual in dres1_2's. Another fusion
        applies context0 after dres0_2, as the module does."""
        cm0 = self._context(0)
        ctx_map = None
        if cm0 is not None and self.context_fusion == "add":
            ctx_map = cm0(ctx2d, return_map=True)[:, None]  # [B, 1, H, W, C]
        x = slab_s1(lambda v: conv3d_bn_s1(v, *self._fold(self.dres0_1)), volume)
        x = slab_s1(lambda v, add=None: conv3d_bn_s1(v, *self._fold(self.dres0_2), add), x, add=ctx_map)
        if cm0 is not None and ctx_map is None:
            x = cm0(ctx2d, x)
        y = slab_s1(lambda v: conv3d_bn_s1(v, *self._fold(self.dres1_1)), x)
        # the residual is padded with zero planes, whose outputs are cropped
        return slab_s1(lambda v, add: conv3d_bn_s1(v, *self._fold(self.dres1_2), add, relu=False), y, add=x)

    @staticmethod
    def _fold(m: ConvBN) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return (m.conv.weight, *fold_bn(m.bn))
