"""Siamese feature extractor (port of ``ecm_tpu/models/features.py``):
images ``[B, H, W, 3]`` -> features ``[B, H/4, W/4, C]``."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ecm_torch.models.layers import BasicBlock, ConvBN, conv
from ecm_torch.ops.upsample import upsample_bilinear
from ecm_torch.parallel.sharding import constrain_features


class SPPBranch(nn.Module):
    """Avg-pool (window clipped to the input, VALID) -> 1x1 convbn-ReLU ->
    bilinear upsample back to the input size."""

    def __init__(self, pool: int, cin: int = 128, features: int = 32):
        super().__init__()
        self.pool = pool
        self.conv = ConvBN(cin, features, kernel_size=1, relu=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        win = (min(self.pool, h), min(self.pool, w))
        y = F.avg_pool2d(x.movedim(-1, 1), win, win).movedim(1, -1)
        return upsample_bilinear(self.conv(y), (h, w))


class FeatureExtraction(nn.Module):
    """Stem (3x convbn, first stride 2), residual stages 32x3, 64x16 (s2),
    128x3 (dil 2), 128x3 (dil 4), four SPP branches, then a 320 -> 128 convbn
    and a 1x1 conv to ``out_channels`` with no BN and no ReLU."""

    def __init__(self, out_channels: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.firstconv1 = ConvBN(3, 32, stride=2)
        self.firstconv2 = ConvBN(32, 32)
        self.firstconv3 = ConvBN(32, 32)
        for i in range(3):
            self.add_module(f"layer1_{i}", BasicBlock(32, 32))
        self.add_module("layer2_0", BasicBlock(32, 64, stride=2))
        for i in range(1, 16):
            self.add_module(f"layer2_{i}", BasicBlock(64, 64))
        for i in range(3):
            self.add_module(f"layer3_{i}", BasicBlock(64 if i == 0 else 128, 128, dilation=2))
        for i in range(3):
            self.add_module(f"layer4_{i}", BasicBlock(128, 128, dilation=4))
        self.pools = (64, 32, 16, 8)
        for p in self.pools:
            self.add_module(f"branch{p}", SPPBranch(p))
        self.lastconv1 = ConvBN(64 + 128 + 4 * 32, 128)
        self.lastconv2 = nn.Conv2d(128, out_channels, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        x = constrain_features(self.firstconv3(self.firstconv2(self.firstconv1(x))))
        for i in range(3):
            x = getattr(self, f"layer1_{i}")(x)
        for i in range(16):
            x = getattr(self, f"layer2_{i}")(x)
        raw = x
        for stage in ("layer3", "layer4"):
            for i in range(3):
                x = getattr(self, f"{stage}_{i}")(x)
        branches = [getattr(self, f"branch{p}")(x) for p in self.pools]
        fused = self.lastconv1(torch.cat([raw, x, *branches], dim=-1))
        return conv(self.lastconv2, fused.movedim(-1, 1)).movedim(1, -1)
