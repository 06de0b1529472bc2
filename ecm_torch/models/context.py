"""Explicit context mapping (port of ``ecm_tpu/models/context.py``).

Maps 2D context features ``[B, H, W, C2]`` into a cost-aggregation volume
``[B, D, H, W, C3]``:

- ``"add"``: 3x3 convbn-ReLU -> 1x1 conv (bias) -> broadcast over D -> add;
- ``"film"``: global mean -> linear-ReLU -> linear -> per-channel
  ``(1 + tanh(scale))`` and shift;
- ``"both"``: add, then FiLM; ``"none"``: the volume unchanged.

``return_map=True`` (``"add"`` only) returns the 2D map ``[B, H, W, C3]``
instead of applying it, for the fused aggregation kernel's epilogue.
"""

from __future__ import annotations

import torch
from torch import nn

from ecm_torch.models.layers import ConvBN, conv, linear

FUSIONS = ("add", "film", "both", "none")
HIDDEN = 128


class ContextMapping(nn.Module):
    def __init__(self, channels2d: int, channels3d: int, fusion: str = "add"):
        super().__init__()
        if fusion not in FUSIONS:
            raise ValueError(f"unknown context fusion {fusion!r}; expected one of {FUSIONS}")
        self.fusion = fusion
        self.channels3d = channels3d
        if fusion in ("add", "both"):
            self.map_conv = ConvBN(channels2d, HIDDEN, kernel_size=3)
            self.map_proj = nn.Conv2d(HIDDEN, channels3d, 1, bias=True)
        if fusion in ("film", "both"):
            self.film_h = nn.Linear(channels2d, HIDDEN)
            self.film_out = nn.Linear(HIDDEN, 2 * channels3d)

    def context_map(self, ctx2d: torch.Tensor) -> torch.Tensor:
        """The 2D context map ``[B, H, W, C3]``."""
        m = self.map_conv(ctx2d).movedim(-1, 1)
        return conv(self.map_proj, m).movedim(1, -1)

    def forward(
        self, ctx2d: torch.Tensor, volume: torch.Tensor | None = None, return_map: bool = False
    ) -> torch.Tensor:
        if return_map:
            if self.fusion != "add":
                raise ValueError(f"return_map needs fusion='add', got {self.fusion!r}")
            return self.context_map(ctx2d)
        if self.fusion == "none":
            return volume
        if volume.shape[-1] != self.channels3d:
            raise ValueError(f"volume has {volume.shape[-1]} channels, expected {self.channels3d}")
        out = volume
        if self.fusion in ("add", "both"):
            out = out + self.context_map(ctx2d)[:, None].to(out.dtype)
        if self.fusion in ("film", "both"):
            g = ctx2d.float().mean(dim=(1, 2)).to(ctx2d.dtype)
            g = torch.relu(linear(self.film_h, g))
            scale, shift = linear(self.film_out, g).chunk(2, dim=-1)
            scale = (1.0 + torch.tanh(scale))[:, None, None, None, :]
            shift = shift[:, None, None, None, :]
            out = out * scale.to(out.dtype) + shift.to(out.dtype)
        return out
