"""IGEV-Stereo (Xu, Wang, Ding and Yang, CVPR 2023; github.com/gangweiX/IGEV,
``IGEV-Stereo/core``), for serving: a MobileNetV2 feature trunk with an
instance-norm decoder, a group-wise correlation volume regularised once by a
3-D hourglass into the geometry encoding volume (GEV), whose soft-argmin
seeds ``iters`` updates of RAFT-Stereo's three ConvGRU levels, each reading
a combined lookup of the GEV and of the all-pairs correlation, and context
upsampling of the last disparity.

The module tree and its state-dict names are the published code's
(``feature.*``, ``stem_2.*``, ``stem_4.*``, ``conv.*``, ``desc.*``,
``corr_stem.*``, ``corr_feature_att.*``, ``cost_agg.*``, ``classifier.*``,
``cnet.*``, ``context_zqr_convs.*``, ``update_block.*``, ``spx_2_gru.*``,
``spx_gru.*``), MobileNetV2 with timm's ``mobilenetv2_100`` names
(``feature.block0.0.0.conv_dw.weight``, ...). ``cnet`` is RAFT-Stereo's
``MultiBasicEncoder``, whose heads are named by RAFT's scales
(``outputs08/16/32``) where IGEV's are ``outputs04/08/16``:
``load_state_dict`` takes either. A published ``BasicConv`` registers its
BatchNorm also where it does not apply it (``cost_agg.conv1_up.bn``), and so
does this one. Defaults are the published evaluation's: ``max_disp 192``,
three GRU levels of 128, ``n_downsample 2``, ``corr_levels 2``,
``corr_radius 4``, ``valid_iters 32``. This module has 12,513,817 parameters:
12,513,801 of the convolutions, BatchNorms and biases the forward applies,
and the 16 of ``cost_agg.conv1_up.bn``. With the training-only ``spx``,
``spx_2`` and ``spx_4`` branch (84,297 parameters), which the eval forward
does not run and this module leaves out, the published model has 12,598,114
(the paper's 12.60 M).

Layout. As ``RAFTStereo``: activations channels-last (``channels_last_3d``
for the volumes), every convolution's weight held channels-last in
``dtype``, instance norm by ``ops/instance_norm.py``. The group-wise volume
comes from ``ops/cuda_cost_volume.cost_volume_correlation`` (``groups`` 8)
as ``[B, D, H, W, G]``, the channels-last view of ``[B, G, D, H, W]``. The
lookup (``ops/cuda_geo_lookup.py``) writes channels-last.

Precision. ``dtype`` float16 is the published ``--mixed_precision``, written
as explicit casts where autocast casts: every convolution in ``dtype``, the
BatchNorms' parameters and statistics float32. The volume's products and
means are float32, rounded once (published: float16 products under
autocast). The classifier's logits are widened to float32 for the softmax
and the regression; the GEV and the correlation pyramids, the disparity and
the lookup's arithmetic are float32, the lookup writes ``dtype``
(published: float32, then autocast's cast at ``convc1``), the disparity
enters the motion encoder in ``dtype``, and the update is added in float32.
The ConvGRUs are RAFT-Stereo's (``ops/conv_gru.py``). The upsampling's
softmax and sum are float32. ``dtype`` float32 computes everything in
float32.

Departures from the published code:

- the forward takes the port's channels-last ImageNet-normalised
  ``[B, H, W, 3]`` images (H, W multiples of 32, the published padding) and
  maps them to ``2 p / 255 - 1`` as ``RAFTStereo`` does; the feature trunk
  and the stems run both images as one batch;
- ``cnet`` and the ``zqr`` convolutions run before the volume (nothing in
  the volume reads them), so the device's work from the volume kernel to
  the first lookup is the geometry stage alone;
- ``Conv2x`` does not resize (at multiples of 32 its shapes match);
- nothing reads a value on the host: the taps, the pixel grid and the
  disparity range are made on the card, so a forward is one CUDA graph;
- the ConvGRUs stack ``convz`` and ``convr`` as ``RAFTStereo`` does;
- the result is the disparity ``[B, H, W]`` float32, the last (and only)
  entry of the returned list;
- weights are initialised as the port's other models are
  (``layers.init_weights``). Training is not ported.
"""

from __future__ import annotations

import re

import torch
import torch.nn.functional as F
from torch import nn

from ecm_torch.models.raft_stereo import CL, ConvGRU, InstanceNorm, MultiBasicEncoder, RAFTStereo, interp, pool2x
from ecm_torch.ops.cuda_corr1d import corr_pyramid
from ecm_torch.ops.cuda_cost_volume import cost_volume_correlation
from ecm_torch.ops.cuda_geo_lookup import geo_lookup, geo_pyramid
from ecm_torch.utils.profiling import span

CL3 = torch.channels_last_3d
SLOPE = 0.01  # nn.LeakyReLU()'s default, the published BasicConv's
GROUPS = 8  # the group-wise volume's groups, and the GEV's channels
# timm's mobilenetv2_100 stages: (blocks, width, stride, expansion), grouped
# into IGEV's block0..block4 (layers [1, 2, 3, 5, 6])
STAGES = ((1, 16, 1, 1), (2, 24, 2, 6), (3, 32, 2, 6), (4, 64, 2, 6), (3, 96, 1, 6), (3, 160, 2, 6))
BLOCKS = ((0,), (1,), (2,), (3, 4), (5,))
# IGEV's cnet heads, by the scale they serve, and RAFT-Stereo's names of them
CNET_HEADS = {"outputs04": "outputs08", "outputs08": "outputs16", "outputs16": "outputs32"}


def _conv_class(deconv: bool, is_3d: bool) -> type[nn.Module]:
    return {(False, False): nn.Conv2d, (True, False): nn.ConvTranspose2d,
            (False, True): nn.Conv3d, (True, True): nn.ConvTranspose3d}[deconv, is_3d]


class BasicConv(nn.Module):
    """A bias-free convolution (2-D or 3-D, plain or transposed), BatchNorm
    where ``bn``, LeakyReLU where ``relu``."""

    def __init__(self, cin: int, cout: int, deconv: bool = False, is_3d: bool = False, bn: bool = True,
                 relu: bool = True, **kw):
        super().__init__()
        self.use_bn, self.relu = bn, relu
        self.conv = _conv_class(deconv, is_3d)(cin, cout, bias=False, **kw)
        self.bn = (nn.BatchNorm3d if is_3d else nn.BatchNorm2d)(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.use_bn:
            x = self.bn(x)
        return F.leaky_relu(x, SLOPE) if self.relu else x


class BasicConvIN(nn.Module):
    """The published ``BasicConv_IN`` (2-D): a bias-free convolution, an
    instance norm without affine, LeakyReLU."""

    def __init__(self, cin: int, cout: int, deconv: bool = False, **kw):
        super().__init__()
        self.conv = _conv_class(deconv, False)(cin, cout, bias=False, **kw)
        self.IN = InstanceNorm()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.IN(self.conv(x)), SLOPE)


class Conv2x(nn.Module):
    """The published ``Conv2x[_IN](cin, cout, deconv=True)``: a 4x4 stride-2
    transposed ``cin -> cout``, the skip input concatenated, a 3x3
    ``2 cout -> 2 cout``; BatchNorm, or instance norm where ``norm`` is
    "instance"."""

    def __init__(self, cin: int, cout: int, norm: str = "batch"):
        super().__init__()
        block = BasicConvIN if norm == "instance" else BasicConv
        self.conv1 = block(cin, cout, deconv=True, kernel_size=4, stride=2, padding=1)
        self.conv2 = block(2 * cout, 2 * cout, kernel_size=3, stride=1, padding=1)

    def forward(self, x: torch.Tensor, rem: torch.Tensor) -> torch.Tensor:
        return self.conv2(torch.cat([self.conv1(x), rem], 1))


class DepthwiseSeparable(nn.Module):
    """timm's ``DepthwiseSeparableConv`` (``blocks.0``): depthwise 3x3, BN,
    ReLU6, pointwise, BN."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv_dw = nn.Conv2d(cin, cin, 3, stride, 1, groups=cin, bias=False)
        self.bn1 = nn.BatchNorm2d(cin)
        self.conv_pw = nn.Conv2d(cin, cout, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        self.skip = stride == 1 and cin == cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn2(self.conv_pw(F.relu6(self.bn1(self.conv_dw(x)))))
        return x + y if self.skip else y


class InvertedResidual(nn.Module):
    """timm's ``InvertedResidual``: pointwise expansion, BN, ReLU6, depthwise
    3x3, BN, ReLU6, pointwise projection, BN; the input added where the
    stride is 1 and the widths match."""

    def __init__(self, cin: int, cout: int, stride: int, expansion: int):
        super().__init__()
        mid = cin * expansion
        self.conv_pw = nn.Conv2d(cin, mid, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(mid)
        self.conv_dw = nn.Conv2d(mid, mid, 3, stride, 1, groups=mid, bias=False)
        self.bn2 = nn.BatchNorm2d(mid)
        self.conv_pwl = nn.Conv2d(mid, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        self.skip = stride == 1 and cin == cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu6(self.bn1(self.conv_pw(x)))
        y = self.bn3(self.conv_pwl(F.relu6(self.bn2(self.conv_dw(y)))))
        return x + y if self.skip else y


def _stage(cin: int, blocks: int, cout: int, stride: int, expansion: int) -> nn.Sequential:
    if expansion == 1:
        return nn.Sequential(DepthwiseSeparable(cin, cout, stride))
    return nn.Sequential(*(InvertedResidual(cin if i == 0 else cout, cout, stride if i == 0 else 1, expansion)
                           for i in range(blocks)))


class Feature(nn.Module):
    """MobileNetV2's stem and first six stages (1/2 .. 1/32) and the
    instance-norm decoder: ``[f4 (48), f8 (64), f16 (192), f32 (160)]``."""

    def __init__(self):
        super().__init__()
        self.conv_stem = nn.Conv2d(3, 32, 3, 2, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(32)
        stages, cin = [], 32
        for blocks, cout, stride, expansion in STAGES:
            stages.append(_stage(cin, blocks, cout, stride, expansion))
            cin = cout
        for i, group in enumerate(BLOCKS):
            setattr(self, f"block{i}", nn.Sequential(*(stages[k] for k in group)))
        self.deconv32_16 = Conv2x(160, 96, "instance")
        self.deconv16_8 = Conv2x(192, 32, "instance")
        self.deconv8_4 = Conv2x(64, 24, "instance")
        self.conv4 = BasicConvIN(48, 48, kernel_size=3, stride=1, padding=1)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x2 = self.block0(F.relu6(self.bn1(self.conv_stem(x))))
        x4 = self.block1(x2)
        x8 = self.block2(x4)
        x16 = self.block3(x8)
        x32 = self.block4(x16)
        x16 = self.deconv32_16(x32, x16)
        x8 = self.deconv16_8(x16, x8)
        x4 = self.conv4(self.deconv8_4(x8, x4))
        return [x4, x8, x16, x32]


def _stem(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(BasicConvIN(cin, cout, kernel_size=3, stride=2, padding=1),
                         nn.Conv2d(cout, cout, 3, 1, 1, bias=False), InstanceNorm(), nn.ReLU())


class FeatureAtt(nn.Module):
    """A volume scaled by the sigmoid of a 2-D feature map's excitation,
    broadcast over the disparities."""

    def __init__(self, cv: int, feat: int):
        super().__init__()
        self.feat_att = nn.Sequential(BasicConv(feat, feat // 2, kernel_size=1, stride=1, padding=0),
                                      nn.Conv2d(feat // 2, cv, 1))

    def forward(self, cv: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        # into a tensor of cv's layout: a broadcast product may choose NCDHW
        return torch.mul(cv, torch.sigmoid(self.feat_att(feat)).unsqueeze(2), out=torch.empty_like(cv))


def _conv3(cin: int, cout: int, k: int = 3, stride: int = 1, **kw) -> BasicConv:
    return BasicConv(cin, cout, is_3d=True, kernel_size=k, stride=stride, padding=k // 2, **kw)


def _up3(cin: int, cout: int, **kw) -> BasicConv:
    return BasicConv(cin, cout, deconv=True, is_3d=True, kernel_size=4, stride=2, padding=1, **kw)


class Hourglass(nn.Module):
    """``cost_agg``: three stride-2 3-D stages with feature excitation at
    1/8, 1/16, 1/32, and back up with skip aggregation; the last transposed
    convolution (no BN, no activation) gives the 8-channel GEV."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Sequential(_conv3(c, 2 * c, stride=2), _conv3(2 * c, 2 * c))
        self.conv2 = nn.Sequential(_conv3(2 * c, 4 * c, stride=2), _conv3(4 * c, 4 * c))
        self.conv3 = nn.Sequential(_conv3(4 * c, 6 * c, stride=2), _conv3(6 * c, 6 * c))
        self.conv3_up = _up3(6 * c, 4 * c)
        self.conv2_up = _up3(4 * c, 2 * c)
        self.conv1_up = _up3(2 * c, GROUPS, bn=False, relu=False)
        self.agg_0 = nn.Sequential(_conv3(8 * c, 4 * c, k=1), _conv3(4 * c, 4 * c), _conv3(4 * c, 4 * c))
        self.agg_1 = nn.Sequential(_conv3(4 * c, 2 * c, k=1), _conv3(2 * c, 2 * c), _conv3(2 * c, 2 * c))
        self.feature_att_8 = FeatureAtt(2 * c, 64)
        self.feature_att_16 = FeatureAtt(4 * c, 192)
        self.feature_att_32 = FeatureAtt(6 * c, 160)
        self.feature_att_up_16 = FeatureAtt(4 * c, 192)
        self.feature_att_up_8 = FeatureAtt(2 * c, 64)

    def forward(self, x: torch.Tensor, features: list[torch.Tensor]) -> torch.Tensor:
        conv1 = self.feature_att_8(self.conv1(x), features[1])
        conv2 = self.feature_att_16(self.conv2(conv1), features[2])
        conv3 = self.feature_att_32(self.conv3(conv2), features[3])
        conv2 = self.agg_0(torch.cat([self.conv3_up(conv3), conv2], 1))
        conv2 = self.feature_att_up_16(conv2, features[2])
        conv1 = self.agg_1(torch.cat([self.conv2_up(conv2), conv1], 1))
        conv1 = self.feature_att_up_8(conv1, features[1])
        return self.conv1_up(conv1)


class MotionEncoder(nn.Module):
    """The published ``BasicMotionEncoder``: the lookup's channels and the
    disparity to 127 channels, with the disparity appended."""

    def __init__(self, corr_channels: int):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_channels, 64, 1)
        self.convc2 = nn.Conv2d(64, 64, 3, padding=1)
        self.convd1 = nn.Conv2d(1, 64, 7, padding=3)
        self.convd2 = nn.Conv2d(64, 64, 3, padding=1)
        self.conv = nn.Conv2d(128, 127, 3, padding=1)

    def forward(self, disp: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        d = F.relu(self.convd2(F.relu(self.convd1(disp))))
        return torch.cat([F.relu(self.conv(torch.cat([c, d], 1))), disp], 1)


class DispHead(nn.Module):
    def __init__(self, hidden: int = 128):
        super().__init__()
        self.conv1 = nn.Conv2d(hidden, 256, 3, padding=1)
        self.conv2 = nn.Conv2d(256, 1, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(x)))


class UpdateBlock(nn.Module):
    """The three GRU levels (``gru04`` at 1/4, ``gru08``, ``gru16``), the
    motion encoder, the disparity head and ``mask_feat_4`` (published
    names)."""

    def __init__(self, hidden_dims: tuple[int, ...], corr_channels: int):
        super().__init__()
        self.encoder = MotionEncoder(corr_channels)
        self.gru04 = ConvGRU(hidden_dims[2], 128 + hidden_dims[1])
        self.gru08 = ConvGRU(hidden_dims[1], hidden_dims[0] + hidden_dims[2])
        self.gru16 = ConvGRU(hidden_dims[0], hidden_dims[1])
        self.disp_head = DispHead(hidden_dims[2])
        self.mask_feat_4 = nn.Sequential(nn.Conv2d(hidden_dims[2], 32, 3, padding=1), nn.ReLU())

    def forward(self, net: list[torch.Tensor], inp: list[tuple], corr: torch.Tensor, disp: torch.Tensor,
                w_zr: tuple[torch.Tensor, ...]):
        """``w_zr``: each level's ``ConvGRU.zr_weight``, in ``net``'s order."""
        net04, net08, net16 = net
        net16 = self.gru16(net16, w_zr[2], *inp[2], pool2x(net08))
        net08 = self.gru08(net08, w_zr[1], *inp[1], pool2x(net04), interp(net16, net08))
        motion = self.encoder(disp, corr)
        net04 = self.gru04(net04, w_zr[0], *inp[0], motion, interp(net08, net04))
        return [net04, net08, net16], self.mask_feat_4(net04), self.disp_head(net04)


def context_upsample(disp: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Each full-resolution pixel the ``weights``-weighted sum (over 9) of its
    1/4-scale pixel's 3x3 neighbourhood of ``disp`` ``[B, 1, h, w]``:
    ``[B, 4h, 4w]``."""
    b, _, h, w = disp.shape
    up = F.interpolate(F.unfold(disp, 3, padding=1).view(b, 9, h, w), (4 * h, 4 * w), mode="nearest")
    return (up * weights).sum(1)


def _published_names(state_dict, prefix, *args) -> None:
    """A load pre-hook: IGEV's ``cnet`` head names to RAFT-Stereo's."""
    heads = re.compile(rf"^{re.escape(prefix)}cnet\.(outputs0[48]|outputs16)\.")
    if any(k.startswith(f"{prefix}cnet.outputs04.") for k in state_dict):
        moved = {k: state_dict.pop(k) for k in [k for k in state_dict if heads.match(k)]}
        for k, v in moved.items():
            head = heads.match(k).group(1)
            state_dict[k.replace(f"cnet.{head}.", f"cnet.{CNET_HEADS[head]}.", 1)] = v


class IGEVStereo(nn.Module):
    """``forward(left, right)``: channels-last ImageNet-normalised
    ``[B, H, W, 3]`` images (H, W multiples of ``input_multiple``) ->
    ``[disparity [B, H, W]]`` after ``iters`` updates."""

    input_multiple = 32  # the published InputPadder's: 1/32 features, three halvings at 1/4

    def __init__(self, max_disp: int = 192, hidden_dims: tuple[int, ...] = (128, 128, 128), corr_levels: int = 2,
                 corr_radius: int = 4, n_downsample: int = 2, iters: int = 32, dtype: torch.dtype = torch.float16):
        super().__init__()
        self.hidden_dims = tuple(hidden_dims)
        if len(self.hidden_dims) != 3 or n_downsample != 2:
            raise ValueError("the port's IGEV-Stereo has three GRU levels at 1/4, 1/8, 1/16 (n_downsample 2)")
        if max_disp % 32:
            raise ValueError(f"max_disp {max_disp}: the hourglass halves max_disp / 4 three times")
        self.max_disp, self.corr_levels, self.corr_radius = max_disp, corr_levels, corr_radius
        self.n_downsample, self.iters, self.dtype = n_downsample, iters, dtype
        self.cnet = MultiBasicEncoder(self.hidden_dims, n_downsample)
        self.context_zqr_convs = nn.ModuleList(nn.Conv2d(d, 3 * d, 3, padding=1) for d in self.hidden_dims)
        self.update_block = UpdateBlock(self.hidden_dims, corr_levels * (2 * corr_radius + 1) * (GROUPS + 1))
        self.feature = Feature()
        self.stem_2 = _stem(3, 32)
        self.stem_4 = _stem(32, 48)
        self.spx_2_gru = Conv2x(32, 32)
        self.spx_gru = nn.Sequential(nn.ConvTranspose2d(64, 9, 4, 2, 1))
        self.conv = BasicConvIN(96, 96, kernel_size=3, padding=1, stride=1)
        self.desc = nn.Conv2d(96, 96, 1)
        self.corr_stem = _conv3(GROUPS, GROUPS)
        self.corr_feature_att = FeatureAtt(GROUPS, 96)
        self.cost_agg = Hourglass(GROUPS)
        self.classifier = nn.Conv3d(GROUPS, 1, 3, 1, 1, bias=False)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                m.to(dtype, memory_format=CL)
            elif isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
                m.to(dtype, memory_format=CL3)
        self._register_load_state_dict_pre_hook(_published_names)

    _image = RAFTStereo._image

    def forward(self, left: torch.Tensor, right: torch.Tensor) -> list[torch.Tensor]:
        dt, b, d4 = self.dtype, left.shape[0], self.max_disp // 4
        with span("ecm.igev.encode"):
            img = torch.cat([self._image(left), self._image(right)]).to(dt)
            feats = self.feature(img)
            stem_2x = self.stem_2(img)
            f4 = torch.cat([feats[0], self.stem_4(stem_2x)], 1)
            match_l, match_r = self.desc(self.conv(f4)).split(b)
            feat_l = [f[:b] for f in (f4, *feats[1:])]
        with span("ecm.igev.context"):
            levels = self.cnet(img[:b])
            net = [torch.tanh(h) for h, _ in levels]
            # each third dense once, not a strided view in 32 iterations' gate sums
            inp = [tuple(t.contiguous(memory_format=CL) for t in c(F.relu(x)).split(c.out_channels // 3, 1))
                   for c, (_, x) in zip(self.context_zqr_convs, levels)]
        with span("ecm.igev.geometry"):
            # [B, D, H, W, G]: the channels-last view of [B, G, D, H, W]
            volume = cost_volume_correlation(match_l.permute(0, 2, 3, 1), match_r.permute(0, 2, 3, 1), d4,
                                             groups=GROUPS).permute(0, 4, 1, 2, 3)
            volume = self.corr_feature_att(self.corr_stem(volume), feat_l[0])
            gev = self.cost_agg(volume, feat_l)
            prob = self.classifier(gev)[:, 0].float().softmax(1)
            planes = torch.arange(d4, dtype=torch.float32, device=prob.device).view(1, d4, 1, 1)
            disp = (prob * planes).sum(1, keepdim=True)
            geo = geo_pyramid(gev, self.corr_levels)
            corr = corr_pyramid(match_l.float(), match_r.float(), self.corr_levels, scaled=False)
        ub = self.update_block
        w_zr = tuple(g.zr_weight() for g in (ub.gru04, ub.gru08, ub.gru16))
        for _ in range(self.iters):
            with span("ecm.igev.update"):
                lookup = geo_lookup(geo, corr, disp, self.corr_radius, dt)
                net, mask_feat, delta = ub(net, inp, lookup, disp.to(dt, memory_format=CL), w_zr)
                disp = disp + delta.float()
        with span("ecm.igev.upsample"):
            weights = self.spx_gru(self.spx_2_gru(mask_feat, stem_2x[:b])).float().softmax(1)
            return [context_upsample(4 * disp, weights)]
