"""End-to-end ECM stereo model, eval forward (port of
``ecm_tpu/models/ecm.py``): left/right ``[B, H, W, 3]`` -> siamese features
-> cost volume ``[B, D/4, H/4, W/4, 2C]`` -> context-mapped stacked-hourglass
aggregation -> cost map ``[B, D/4, H/4, W/4]`` -> x4 trilinear upsample and
soft-argmin -> disparity ``[B, H, W]``.

H and W must be multiples of 16 (the /4 features meet two stride-2
hourglass levels); ``max_disp`` a multiple of 4.
"""

from __future__ import annotations

import torch
from torch import nn

from ecm_torch.models.aggregation import ECMAggregation
from ecm_torch.models.features import FeatureExtraction
from ecm_torch.models.layers import init_weights
from ecm_torch.ops.cost_volume import cost_volume
from ecm_torch.ops.cuda_regression import fused_upsample_softargmin
from ecm_torch.ops.softargmin import disparity_regression
from ecm_torch.ops.upsample import upsample_bilinear, upsample_trilinear

REGRESS_MODES = ("auto", "fullres", "fused", "lowres")


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as given, else ``cuda``. Raises when no device was asked
    for and no GPU is present: the port never falls back to the CPU quietly."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: ecm_torch runs on the GPU; pass device='cpu' to "
            "run it on the CPU"
        )
    return torch.device("cuda")


def regress_disparity(cost4: torch.Tensor, max_disp: int, h: int, w: int, mode: str) -> torch.Tensor:
    """Quarter-resolution cost ``[B, D/4, H/4, W/4]`` -> disparity ``[B, H, W]``.

    - "fullres": upsample the cost to ``[B, D, H, W]``, then soft-argmin;
    - "fused": the same numbers through the CUDA kernel, without the
      full-resolution volume (the plain version for a CPU tensor);
    - "lowres": upsample only D, soft-argmin at 1/4 resolution, then
      bilinear-upsample the disparity (approximate);
    - "auto": "fused" on a CUDA tensor, else "fullres".
    """
    if mode not in REGRESS_MODES:
        raise ValueError(f"unknown regress_mode {mode!r}; expected one of {REGRESS_MODES}")
    if mode == "auto":
        mode = "fused" if cost4.is_cuda else "fullres"
    if mode == "lowres":
        _, _, h4, w4 = cost4.shape
        d_low = disparity_regression(upsample_trilinear(cost4, (max_disp, h4, w4)), max_disp)
        return upsample_bilinear(d_low[..., None], (h, w))[..., 0]
    if mode == "fused":
        return fused_upsample_softargmin(cost4, max_disp)
    return disparity_regression(upsample_trilinear(cost4, (max_disp, h, w)), max_disp)


class ECMStereo(nn.Module):
    """Flagship stacked-hourglass ECM model (eval forward).

    ``use_pallas`` keeps its JAX name: in the port it selects the CUDA cost-
    volume kernel. ``agg_fused`` routes the stride-1 conv pairs through the
    fused CUDA kernel ("auto": on CUDA). ``agg_layout`` "auto" resolves to
    "standard"; "grouped" is not ported."""

    def __init__(
        self,
        max_disp: int = 192,
        feature_channels: int = 32,
        cost_mode: str = "concat",
        context_fusion: str = "add",
        use_pallas: bool = False,
        agg_fused: str = "off",
        agg_layout: str = "auto",
        regress_mode: str = "auto",
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if max_disp % 4:
            raise ValueError(f"max_disp must be a multiple of 4, got {max_disp}")
        if regress_mode not in REGRESS_MODES:
            raise ValueError(f"unknown regress_mode {regress_mode!r}")
        self.max_disp = max_disp
        self.cost_mode = cost_mode
        self.use_pallas = use_pallas
        self.regress_mode = regress_mode
        c = feature_channels
        self.feature = FeatureExtraction(c, dtype=dtype)
        self.aggregation = ECMAggregation(
            channels=c,
            in_channels=2 * c if cost_mode == "concat" else 1,
            context_fusion=context_fusion,
            layout="standard" if agg_layout == "auto" else agg_layout,
            fused=agg_fused,
        )

    def cost_maps(self, left: torch.Tensor, right: torch.Tensor) -> list[torch.Tensor]:
        """The quarter-resolution cost maps ``[B, D/4, H/4, W/4]`` that the
        soft-argmin reads (at eval, one)."""
        if self.training:
            raise NotImplementedError("the training forward is not ported yet (ROADMAP queue 1)")
        _, h, w, _ = left.shape
        if h % 16 or w % 16:
            raise ValueError(f"ECMStereo needs H, W multiples of 16, got {h}x{w}")
        fl = self.feature(left)
        fr = self.feature(right)
        vol = cost_volume(fl, fr, self.max_disp // 4, mode=self.cost_mode, use_pallas=self.use_pallas)
        return self.aggregation(vol, fl)

    def forward(self, left: torch.Tensor, right: torch.Tensor) -> list[torch.Tensor]:
        _, h, w, _ = left.shape
        return [
            regress_disparity(c4, self.max_disp, h, w, self.regress_mode)
            for c4 in self.cost_maps(left, right)
        ]


def build_model(
    name: str = "stackhourglass",
    device: str | torch.device | None = None,
    generator: torch.Generator | None = None,
    **kwargs,
) -> nn.Module:
    """Build a model in eval mode on ``device`` (default ``cuda``; raises when
    there is no GPU and no device was given), initialised from ``generator``
    (default: seed 0)."""
    dev = resolve_device(device)
    if name in ("stackhourglass", "ecm"):
        model = ECMStereo(**kwargs)
    elif name == "basic":
        raise NotImplementedError("ECMBasic is not ported yet (ROADMAP: next slice)")
    else:
        raise ValueError(f"unknown model {name!r}; expected stackhourglass|ecm|basic")
    init_weights(model, generator if generator is not None else torch.Generator().manual_seed(0))
    return model.to(dev).eval()
