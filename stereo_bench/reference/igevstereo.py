"""Plain PyTorch reference of IGEV-Stereo's eval forward (Xu, Wang, Ding and
Yang, CVPR 2023; github.com/gangweiX/IGEV, ``IGEV-Stereo/core``), in float32
on channels-first tensors, with ``torch.nn.functional`` ops alone.

It imports nothing of the program under test: it reads a state dict by the
published names (``feature.block1.0.0.conv_pw.weight``,
``cost_agg.conv1.0.bn.running_mean``, ``update_block.gru04.convz.weight``,
...), made by the benchmark, and reuses RAFT-Stereo's plain reference
(``reference/raftstereo.py``) for ``cnet``, the ConvGRU, the pools and the
resizes: ``cnet``'s heads are read by RAFT's names (``cnet.outputs08`` at
1/4, ``outputs16``, ``outputs32``), which the benchmark's state dict has,
where a published IGEV checkpoint names them ``outputs04/08/16``. The
published evaluation's settings: MobileNetV2 (timm's ``mobilenetv2_100``,
its first six stages) with an instance-norm decoder, ``max_disp 192``, a
group-wise volume of 8 groups by a loop over the disparities, the 3-D
hourglass, ``n_downsample 2``, three GRU levels, ``corr_levels 2``,
``corr_radius 4``, both lookups by ``grid_sample`` as published, the
all-pairs correlation not scaled.

Departures from the published code:

- the images come in as the benchmark makes them, channels-last and
  ImageNet-normalised, and are mapped to ``2 p / 255 - 1`` as
  ``2 (x std + mean) - 1``;
- ``Conv2x`` does not resize (the shapes match at multiples of 32);
- :meth:`Net.forward` also returns the classifier's logits, each
  iteration's update and the upsampling's logits, and in ``train`` mode
  every BatchNorm uses its batch statistics, which it records at their first
  use (the left image's, for the feature trunk): the benchmark's weights
  recipe reads all four.

``precision`` says where values are rounded, as in ``reference/ecm.py``:
:data:`EXACT` nowhere; :data:`FP8`, the control, where the program under
test rounds to float16: every convolution's weights and biases and every
activation it stores (each convolution's, norm's, activation's, sum's,
product's, pool's and resize's output, the volume, the lookup's output and
the disparity the motion encoder reads). The classifier's softmax and
regression, the two pyramids, the disparity and the upsampling's softmax
and sums stay float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import raftstereo as R
from .ecm import EXACT, FP8, strict_f32

__all__ = ["EXACT", "FP8", "Net", "infer", "strict_f32"]

IN_EPS = 1e-5
SLOPE = 0.01
GROUPS = 8
# timm's mobilenetv2_100 stages (blocks, width, stride), grouped into IGEV's
# feature.block0 .. block4
STAGES = ((1, 16, 1), (2, 24, 2), (3, 32, 2), (4, 64, 2), (3, 96, 1), (3, 160, 2))
BLOCKS = ((0,), (1,), (2,), (3, 4), (5,))


class Net(R.Net):
    """The network over the parameters ``p`` (name -> float32 tensor),
    ``max_disp``, ``levels`` pyramid levels of radius ``radius`` and
    ``iters`` updates; ``train``: every BatchNorm on batch statistics."""

    def __init__(self, p: dict[str, torch.Tensor], iters: int, max_disp: int = 192, levels: int = 2,
                 radius: int = 4, train: bool = False, precision=EXACT):
        super().__init__(p, iters, levels, radius, 2, train, precision)
        self.max_disp = max_disp

    # -- building blocks ---------------------------------------------------
    def conv(self, x: torch.Tensor, name: str, stride: int = 1, groups: int = 1) -> torch.Tensor:
        """A 2-D or 3-D convolution, padded by half its kernel."""
        w, b = self.p[f"{name}.weight"], self.p.get(f"{name}.bias")
        fn = F.conv3d if w.ndim == 5 else F.conv2d
        return self.s(fn(x, self.w(w), None if b is None else self.w(b), stride, w.shape[-1] // 2, 1, groups))

    def deconv(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """A 4-tap stride-2 transposed convolution, 2-D or 3-D (padding 1)."""
        w, b = self.p[f"{name}.weight"], self.p.get(f"{name}.bias")
        fn = F.conv_transpose3d if w.ndim == 5 else F.conv_transpose2d
        return self.s(fn(x, self.w(w), None if b is None else self.w(b), 2, 1))

    def norm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """BatchNorm (2-D or 3-D) where ``name`` has a scale, else instance
        norm."""
        v = lambda t: t.view(1, -1, *[1] * (x.ndim - 2))  # noqa: E731
        if f"{name}.weight" not in self.p:
            dims = tuple(range(2, x.ndim))
            mean = x.mean(dims, keepdim=True)
            var = (x - mean).square().mean(dims, keepdim=True)
            return self.s((x - mean) * torch.rsqrt(var + IN_EPS))
        if self.train:
            dims = (0, *range(2, x.ndim))
            mean = x.mean(dims)
            var = (x - v(mean)).square().mean(dims)
            if name not in {n for n, _, _ in self.stats}:
                self.stats.append((name, mean, var))
        else:
            mean, var = self.p[f"{name}.running_mean"], self.p[f"{name}.running_var"]
        y = (x - v(mean)) * torch.rsqrt(v(var) + R.BN_EPS) * v(self.p[f"{name}.weight"]) + v(self.p[f"{name}.bias"])
        return self.s(y)

    def leaky(self, x: torch.Tensor) -> torch.Tensor:
        return self.s(F.leaky_relu(x, SLOPE))

    def basic(self, x: torch.Tensor, name: str, stride: int = 1, deconv: bool = False) -> torch.Tensor:
        """``BasicConv`` (BatchNorm: ``name.bn``) or ``BasicConv_IN``, with
        LeakyReLU."""
        y = self.deconv(x, f"{name}.conv") if deconv else self.conv(x, f"{name}.conv", stride)
        return self.leaky(self.norm(y, f"{name}.bn" if f"{name}.bn.weight" in self.p else f"{name}.IN"))

    def conv2x(self, x: torch.Tensor, rem: torch.Tensor, name: str) -> torch.Tensor:
        return self.basic(torch.cat([self.basic(x, f"{name}.conv1", deconv=True), rem], 1), f"{name}.conv2")

    def relu6(self, x: torch.Tensor) -> torch.Tensor:
        return self.s(F.relu6(x))

    # -- the network -------------------------------------------------------
    def mobile_block(self, x: torch.Tensor, name: str, stride: int) -> torch.Tensor:
        if f"{name}.conv_pwl.weight" in self.p:  # inverted residual
            y = self.relu6(self.norm(self.conv(x, f"{name}.conv_pw"), f"{name}.bn1"))
            y = self.relu6(self.norm(self.conv(y, f"{name}.conv_dw", stride, y.shape[1]), f"{name}.bn2"))
            y = self.norm(self.conv(y, f"{name}.conv_pwl"), f"{name}.bn3")
        else:  # depthwise separable
            y = self.relu6(self.norm(self.conv(x, f"{name}.conv_dw", stride, x.shape[1]), f"{name}.bn1"))
            y = self.norm(self.conv(y, f"{name}.conv_pw"), f"{name}.bn2")
        return self.s(x + y) if stride == 1 and x.shape[1] == y.shape[1] else y

    def feature(self, img: torch.Tensor) -> list[torch.Tensor]:
        """``[f4 (48), f8 (64), f16 (192), f32 (160)]``."""
        x = self.relu6(self.norm(self.conv(img, "feature.conv_stem", 2), "feature.bn1"))
        scales = []
        for i, group in enumerate(BLOCKS):
            for j, stage in enumerate(group):
                blocks, _, stride = STAGES[stage]
                for k in range(blocks):
                    x = self.mobile_block(x, f"feature.block{i}.{j}.{k}", stride if k == 0 else 1)
            scales.append(x)
        _, x4, x8, x16, x32 = scales
        x16 = self.conv2x(x32, x16, "feature.deconv32_16")
        x8 = self.conv2x(x16, x8, "feature.deconv16_8")
        x4 = self.basic(self.conv2x(x8, x4, "feature.deconv8_4"), "feature.conv4")
        return [x4, x8, x16, x32]

    def stem(self, x: torch.Tensor, name: str) -> torch.Tensor:
        y = self.conv(self.basic(x, f"{name}.0", 2), f"{name}.1")
        return F.relu(self.norm(y, f"{name}.2"))

    def att(self, cv: torch.Tensor, feat: torch.Tensor, name: str) -> torch.Tensor:
        a = self.conv(self.basic(feat, f"{name}.feat_att.0"), f"{name}.feat_att.1")
        return self.s(cv * self.s(torch.sigmoid(a)).unsqueeze(2))

    def gwc_volume(self, fl: torch.Tensor, fr: torch.Tensor) -> torch.Tensor:
        """``[B, G, D, H, W]``: each group's mean over its channels of
        ``fl[w] fr[w - d]``, zero for ``w < d`` (published
        ``build_gwc_volume``)."""
        b, c, h, w = fl.shape
        vol = fl.new_zeros(b, GROUPS, self.max_disp // 4, h, w)
        for d in range(self.max_disp // 4):
            prod = fl[..., d:] * fr[..., : w - d]
            vol[:, :, d, :, d:] = prod.view(b, GROUPS, c // GROUPS, h, w - d).mean(2)
        return self.s(vol)

    def hourglass(self, x: torch.Tensor, feats: list[torch.Tensor]) -> torch.Tensor:
        a = "cost_agg"
        conv1 = self.basic(self.basic(x, f"{a}.conv1.0", 2), f"{a}.conv1.1")
        conv1 = self.att(conv1, feats[1], f"{a}.feature_att_8")
        conv2 = self.basic(self.basic(conv1, f"{a}.conv2.0", 2), f"{a}.conv2.1")
        conv2 = self.att(conv2, feats[2], f"{a}.feature_att_16")
        conv3 = self.basic(self.basic(conv2, f"{a}.conv3.0", 2), f"{a}.conv3.1")
        conv3 = self.att(conv3, feats[3], f"{a}.feature_att_32")
        conv2 = torch.cat([self.basic(conv3, f"{a}.conv3_up", deconv=True), conv2], 1)
        for i in range(3):
            conv2 = self.basic(conv2, f"{a}.agg_0.{i}")
        conv2 = self.att(conv2, feats[2], f"{a}.feature_att_up_16")
        conv1 = torch.cat([self.basic(conv2, f"{a}.conv2_up", deconv=True), conv1], 1)
        for i in range(3):
            conv1 = self.basic(conv1, f"{a}.agg_1.{i}")
        conv1 = self.att(conv1, feats[1], f"{a}.feature_att_up_8")
        return self.deconv(conv1, f"{a}.conv1_up.conv")  # no BatchNorm, no activation

    def features(self, img1: torch.Tensor, img2: torch.Tensor):
        """The left features at 1/4 (with the stem, 96) to 1/32, both
        images' matching descriptors, and the left image's 1/2 stem."""
        sides = []
        for img in (img1, img2):
            f = self.feature(img)
            stem_2x = self.stem(img, "stem_2")
            f[0] = torch.cat([f[0], self.stem(stem_2x, "stem_4")], 1)
            match = self.conv(self.basic(f[0], "conv"), "desc")
            sides.append((f, match, stem_2x))
        (feats, match_l, stem_2x), (_, match_r, _) = sides
        return feats, match_l, match_r, stem_2x

    def geometry(self, feats, match_l: torch.Tensor, match_r: torch.Tensor):
        """The GEV ``[B, 8, D, H, W]``, the classifier's logits
        ``[B, D, H, W]`` and the initial disparity ``[B, 1, H, W]``."""
        volume = self.basic(self.gwc_volume(match_l, match_r), "corr_stem")
        volume = self.att(volume, feats[0], "corr_feature_att")
        gev = self.hourglass(volume, feats)
        logits = self.conv(gev, "classifier")[:, 0]
        planes = torch.arange(logits.shape[1], dtype=torch.float32, device=logits.device).view(1, -1, 1, 1)
        return gev, logits, (F.softmax(logits, 1) * planes).sum(1, keepdim=True)

    def pyramids(self, gev: torch.Tensor, match_l: torch.Tensor, match_r: torch.Tensor):
        """The published ``Combined_Geo_Encoding_Volume``'s two pyramids:
        ``[B*H*W, C, 1, D >> i]`` and ``[B*H*W, 1, 1, W >> i]``, float32."""
        b, c, d, h, w = gev.shape
        geo = [gev.permute(0, 3, 4, 1, 2).reshape(b * h * w, c, 1, d)]
        corr = [torch.einsum("aijk,aijh->ajkh", match_l, match_r).reshape(b * h * w, 1, 1, w)]
        for _ in range(self.levels - 1):
            geo.append(F.avg_pool2d(geo[-1], [1, 2], stride=[1, 2]))
            corr.append(F.avg_pool2d(corr[-1], [1, 2], stride=[1, 2]))
        return geo, corr

    def lookup(self, geo, corr, disp: torch.Tensor) -> torch.Tensor:
        r = self.radius
        b, _, h, w = disp.shape
        dx = torch.arange(-r, r + 1, dtype=torch.float32, device=disp.device).view(1, 1, 2 * r + 1, 1)
        d = disp.reshape(b * h * w, 1, 1, 1)
        x = torch.arange(w, dtype=torch.float32, device=disp.device).view(1, 1, w, 1).repeat(b, h, 1, 1)
        out = []
        for i, (g, c) in enumerate(zip(geo, corr)):
            for vol, x0 in ((g, dx + d / 2**i), (c, x.reshape(b * h * w, 1, 1, 1) / 2**i - d / 2**i + dx)):
                size = vol.shape[-1]
                grid = torch.cat([2 * x0 / (size - 1) - 1, torch.zeros_like(x0)], -1)
                out.append(F.grid_sample(vol, grid, align_corners=True).view(b, h, w, -1))
        return self.s(torch.cat(out, -1).permute(0, 3, 1, 2))

    def update(self, net, inp, corr: torch.Tensor, disp: torch.Tensor):
        u = "update_block"
        net04, net08, net16 = net
        net16 = self.gru(f"{u}.gru16", net16, *inp[2], self.pool2x(net08))
        net08 = self.gru(f"{u}.gru08", net08, *inp[1], self.pool2x(net04), self.interp(net16, net08))
        e = f"{u}.encoder"
        c = F.relu(self.conv(F.relu(self.conv(corr, f"{e}.convc1")), f"{e}.convc2"))
        d = F.relu(self.conv(F.relu(self.conv(disp, f"{e}.convd1")), f"{e}.convd2"))
        motion = torch.cat([F.relu(self.conv(torch.cat([c, d], 1), f"{e}.conv")), disp], 1)
        net04 = self.gru(f"{u}.gru04", net04, *inp[0], motion, self.interp(net08, net04))
        delta = self.conv(F.relu(self.conv(net04, f"{u}.disp_head.conv1")), f"{u}.disp_head.conv2")
        mask_feat = F.relu(self.conv(net04, f"{u}.mask_feat_4.0"))
        return [net04, net08, net16], mask_feat, delta

    def forward(self, left: torch.Tensor, right: torch.Tensor) -> dict:
        """Channels-last images -> ``disparity`` ``[B, H, W]``, the
        classifier's ``logits``, each iteration's update ``deltas``
        (``[B, H/4, W/4]``) and the upsampling's ``upsampling_logits``
        (``[B, 9, H, W]``)."""
        img1, img2 = self.image(left), self.image(right)
        feats, match_l, match_r, stem_2x = self.features(img1, img2)
        gev, logits, disp = self.geometry(feats, match_l, match_r)
        levels = self.context(img1)
        net = [self.s(torch.tanh(h)) for h, _ in levels]
        inp = []
        for i, (_, x) in enumerate(levels):
            zqr = self.conv(F.relu(x), f"context_zqr_convs.{i}")
            inp.append(zqr.split(zqr.shape[1] // 3, 1))
        geo, corr = self.pyramids(gev, match_l, match_r)
        deltas, mask_feat = [], None
        for _ in range(self.iters):
            net, mask_feat, delta = self.update(net, inp, self.lookup(geo, corr, disp), self.s(disp))
            disp = disp + delta
            deltas.append(delta[:, 0])
        out = {"logits": logits, "deltas": deltas, "disparity": None}
        if mask_feat is not None:
            out["upsampling_logits"] = self.deconv(self.conv2x(mask_feat, stem_2x, "spx_2_gru"), "spx_gru.0")
            weights = F.softmax(out["upsampling_logits"], 1)
            b, _, h, w = disp.shape
            up = F.unfold(4 * disp, 3, padding=1).view(b, 9, h, w)
            up = F.interpolate(up, (4 * h, 4 * w), mode="nearest")
            out["disparity"] = (up * weights).sum(1)
        return out


@torch.inference_mode()
def infer(p: dict[str, torch.Tensor], iters: int, left: torch.Tensor, right: torch.Tensor, precision=EXACT,
          max_disp: int = 192, levels: int = 2, radius: int = 4) -> torch.Tensor:
    """Eval disparities ``[B, H, W]`` of channels-last images."""
    with strict_f32():
        return Net(p, iters, max_disp, levels, radius, precision=precision).forward(left, right)["disparity"]
