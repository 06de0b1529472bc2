"""End-to-end ECM stereo models (port of ``ecm_tpu/models/ecm.py``):
left/right ``[B, H, W, 3]`` -> siamese features -> cost volume
``[B, D/4, H/4, W/4, 2C]`` -> 3D aggregation -> cost maps
``[B, D/4, H/4, W/4]`` -> x4 trilinear upsample and soft-argmin ->
disparities ``[B, H, W]``: one at eval; in training (``model.train()``)
three for ``ECMStereo`` and one for ``ECMBasic``.

``ECMStereo`` aggregates with context-mapped stacked hourglasses and needs H
and W multiples of 16 (the /4 features meet two stride-2 hourglass levels);
``ECMBasic`` with residual blocks and needs multiples of 4. ``max_disp`` is a
multiple of 4.

Under a mesh with a disparity axis (``ecm_torch.parallel.use_mesh``) every
rank of a disp group computes the features, builds the volume over its own
range of disparities and aggregates its slab at every level; the
quarter-resolution cost maps are then gathered over the group
(``halo.gather_d``) and every rank regresses the whole maps, as GSPMD
gathers the input of the Pallas regression in ``ecm_tpu`` (a
``pallas_call`` cannot be partitioned). In training each rank computes the
same loss from the gathered maps, and the gather's backward hands each rank
its own slab's gradient. The slabs must be equal and split every level into
even planes: ``(max_disp / 16) % disp == 0`` for ``ECMStereo``,
``(max_disp / 4) % disp == 0`` for ``ECMBasic`` (GSPMD pads uneven shards;
the port raises).
"""

from __future__ import annotations

import torch
from torch import nn

from ecm_torch.models.aggregation import LAYOUTS, ClassifHead, ECMAggregation
from ecm_torch.models.context import ContextMapping
from ecm_torch.models.features import FeatureExtraction
from ecm_torch.models.layers import ConvBN, init_weights, remat
from ecm_torch.parallel.halo import gather_d
from ecm_torch.parallel.sharding import constrain_volume, disp_mesh
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


def regress_disparity(
    cost4: torch.Tensor, max_disp: int, h: int, w: int, mode: str, train: bool = False
) -> torch.Tensor:
    """Quarter-resolution cost ``[B, D/4, H/4, W/4]`` -> disparity ``[B, H, W]``.

    - "fullres": upsample the cost to ``[B, D, H, W]``, then soft-argmin;
    - "fused": the same numbers through the CUDA kernel, without the
      full-resolution volume (the plain version for a CPU tensor);
    - "lowres": upsample only D, soft-argmin at 1/4 resolution, then
      bilinear-upsample the disparity (approximate);
    - "auto": "fused" on a CUDA tensor, else "fullres".

    ``train``: "auto" and "fused" become "fullres" (the kernel is forward
    only), as in JAX; "lowres" stays.
    """
    if mode not in REGRESS_MODES:
        raise ValueError(f"unknown regress_mode {mode!r}; expected one of {REGRESS_MODES}")
    if train and mode in ("auto", "fused"):
        mode = "fullres"
    if mode == "auto":
        mode = "fused" if cost4.is_cuda else "fullres"
    if mode == "lowres":
        _, _, h4, w4 = cost4.shape
        d_low = disparity_regression(upsample_trilinear(cost4, (max_disp, h4, w4)), max_disp)
        return upsample_bilinear(d_low[..., None], (h, w))[..., 0]
    if mode == "fused":
        return fused_upsample_softargmin(cost4, max_disp)
    return disparity_regression(upsample_trilinear(cost4, (max_disp, h, w)), max_disp)


class _StereoModel(nn.Module):
    """What both models share: the checks of ``max_disp`` and
    ``regress_mode``, and the forward, which regresses each cost map of
    ``cost_maps`` to a disparity ``[B, H, W]``. ``remat`` (training only):
    activation checkpointing of the 3D blocks, as ``nn.remat`` in JAX."""

    # under a disp mesh each rank's slab of the max_disp/4 planes is a
    # multiple of this many planes (ECMStereo's two stride-2 levels need 4:
    # even slabs at D/8, whole ones at D/16)
    disp_split = 1

    def __init__(
        self, max_disp: int, cost_mode: str, use_pallas: bool, regress_mode: str, remat: bool
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
        self.remat = remat

    def forward(self, left: torch.Tensor, right: torch.Tensor) -> list[torch.Tensor]:
        _, h, w, _ = left.shape
        return [
            regress_disparity(c4, self.max_disp, h, w, self.regress_mode, self.training)
            for c4 in self.cost_maps(left, right)
        ]

    def _volume(self, fl: torch.Tensor, fr: torch.Tensor) -> torch.Tensor:
        """The NDHWC cost volume of the features: the whole range of
        ``max_disp / 4`` planes, or under a disp mesh this rank's slab."""
        d4, d_start, planes = self.max_disp // 4, 0, self.max_disp // 4
        mesh = disp_mesh()
        if mesh is not None:
            if d4 % (self.disp_split * mesh.disp):
                need = 4 * self.disp_split
                raise ValueError(
                    f"{type(self).__name__} on a disp axis of {mesh.disp} ranks needs (max_disp / {need}) % disp "
                    f"== 0 (equal slabs of even planes at every level), got max_disp {self.max_disp}"
                )
            d_start, planes = mesh.disp_range(d4)
        vol = cost_volume(fl, fr, planes, mode=self.cost_mode, use_pallas=self.use_pallas, d_start=d_start)
        return constrain_volume(vol)

    @staticmethod
    def _gathered(costs: list[torch.Tensor]) -> list[torch.Tensor]:
        """The cost maps ``[B, D/4, H/4, W/4]``: each rank's slabs gathered
        over its disp group under a disp mesh."""
        mesh = disp_mesh()
        return costs if mesh is None else [gather_d(c, mesh) for c in costs]


class ECMStereo(_StereoModel):
    """Flagship stacked-hourglass ECM model.

    ``use_pallas`` keeps its JAX name: in the port it selects the CUDA cost-
    volume kernel. ``agg_layout`` keeps the JAX names of the aggregation's
    eval dispatch, on NDHWC volumes in both: "standard" runs cuDNN or, with
    ``agg_fused`` ("auto": on CUDA), the fused pair kernel; "grouped" runs
    the layer kernels (``ECMAggregation``); "auto" resolves per forward
    (:meth:`resolve_layout`). ``context_stages`` (0 = after dres0, i = at
    hourglass i's input) and ``num_hourglass`` are JAX's, passed to the
    aggregation."""

    disp_split = 4

    def __init__(
        self,
        max_disp: int = 192,
        feature_channels: int = 32,
        cost_mode: str = "concat",
        context_fusion: str = "add",
        context_stages: tuple[int, ...] = (0, 1, 2, 3),
        num_hourglass: int = 3,
        use_pallas: bool = False,
        agg_fused: str = "off",
        agg_layout: str = "auto",
        regress_mode: str = "auto",
        remat: bool = True,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__(max_disp, cost_mode, use_pallas, regress_mode, remat)
        if agg_layout not in (*LAYOUTS, "auto"):
            raise ValueError(f"agg_layout must be auto|standard|grouped, got {agg_layout!r}")
        if agg_layout == "grouped" and (max_disp // 4) % 16:
            raise ValueError(f"agg_layout='grouped' needs max_disp/4 % 16 == 0, got {max_disp // 4}")
        self.agg_layout = agg_layout
        c = feature_channels
        self.feature = FeatureExtraction(c, dtype=dtype)
        self.aggregation = ECMAggregation(
            channels=c,
            in_channels=2 * c if cost_mode == "concat" else 1,
            num_hourglass=num_hourglass,
            context_fusion=context_fusion,
            context_stages=context_stages,
            fused=agg_fused,
            remat=remat,
        )

    def resolve_layout(self, device: torch.device) -> str:
        """``agg_layout`` for a forward on ``device``, resolved as
        ``ecm_tpu/models/ecm.py:133-145`` resolves it on a TPU: "auto" is
        "grouped" on CUDA when max_disp/4 % 16 == 0, else "standard"."""
        if self.agg_layout != "auto":
            return self.agg_layout
        return "grouped" if device.type == "cuda" and (self.max_disp // 4) % 16 == 0 else "standard"

    def cost_maps(self, left: torch.Tensor, right: torch.Tensor) -> list[torch.Tensor]:
        """The quarter-resolution cost maps ``[B, D/4, H/4, W/4]`` that the
        soft-argmin reads (at eval, one; in training, three)."""
        _, h, w, _ = left.shape
        if h % 16 or w % 16:
            raise ValueError(f"ECMStereo needs H, W multiples of 16, got {h}x{w}")
        fl = self.feature(left)
        fr = self.feature(right)
        vol = self._volume(fl, fr)
        return self._gathered(self.aggregation(vol, fl, self.resolve_layout(vol.device)))


class ResBlock3d(nn.Module):
    """``ECMBasic``'s residual block: convbn-ReLU, convbn, plus the identity."""

    def __init__(self, c: int):
        super().__init__()
        self.c1 = ConvBN(c, c, 3, ndim=3)
        self.c2 = ConvBN(c, c, 3, relu=False, ndim=3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.c2(self.c1(x))


class ECMBasic(_StereoModel):
    """Basic (non-stacked) variant (port of ``ecm_tpu``'s ``ECMBasic``): dres0
    (two convbn-ReLU), context0, four residual blocks ``dres1..4`` (each under
    ``remat`` in training), one classifier. Its 3D convs run on cuDNN, as
    they run on XLA in JAX; ``use_pallas`` and ``regress_mode`` act as in
    ``ECMStereo``."""

    def __init__(
        self,
        max_disp: int = 192,
        feature_channels: int = 32,
        cost_mode: str = "concat",
        context_fusion: str = "add",
        use_pallas: bool = False,
        regress_mode: str = "auto",
        remat: bool = True,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__(max_disp, cost_mode, use_pallas, regress_mode, remat)
        c = feature_channels
        self.feature = FeatureExtraction(c, dtype=dtype)
        self.dres0_1 = ConvBN(2 * c if cost_mode == "concat" else 1, c, 3, ndim=3)
        self.dres0_2 = ConvBN(c, c, 3, ndim=3)
        if context_fusion != "none":
            self.context0 = ContextMapping(c, c, fusion=context_fusion)
        for i in range(1, 5):
            self.add_module(f"dres{i}", ResBlock3d(c))
        self.classif = ClassifHead(c)

    def cost_maps(self, left: torch.Tensor, right: torch.Tensor) -> list[torch.Tensor]:
        """The quarter-resolution cost map ``[B, D/4, H/4, W/4]``, in a list."""
        _, h, w, _ = left.shape
        if h % 4 or w % 4:
            raise ValueError(f"ECMBasic needs H, W multiples of 4, got {h}x{w}")
        fl = self.feature(left)
        fr = self.feature(right)
        return self._gathered(self.aggregate(self._volume(fl, fr), fl))

    def aggregate(self, vol: torch.Tensor, fl: torch.Tensor) -> list[torch.Tensor]:
        """The cost map of the NDHWC volume ``vol`` (left features ``fl``
        for the context), in a list."""
        x = self.dres0_2(self.dres0_1(vol))
        if hasattr(self, "context0"):
            x = self.context0(fl, x)
        checkpointed = self.training and self.remat and torch.is_grad_enabled()
        for i in range(1, 5):
            block = getattr(self, f"dres{i}")
            x = remat(block, x) if checkpointed else block(x)
        return [self.classif(x).squeeze(-1)]


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
        model = ECMBasic(**kwargs)
    else:
        raise ValueError(f"unknown model {name!r}; expected stackhourglass|ecm|basic")
    init_weights(model, generator if generator is not None else torch.Generator().manual_seed(0))
    return model.to(dev).eval()
