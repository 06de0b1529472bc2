"""RAFT-Stereo (Lipson, Teed and Deng, 3DV 2021; github.com/princeton-vl/
RAFT-Stereo), for serving: the instance-norm feature encoder, the BatchNorm
multi-level context encoder, the 1-D all-pairs correlation pyramid, three
ConvGRU levels at 1/4, 1/8 and 1/16 of the image updated ``iters`` times,
and convex upsampling of the last flow.

The module tree and its state-dict names are the published code's
(``fnet.*``, ``cnet.*``, ``context_zqr_convs.*``, ``update_block.*``; a
``ResidualBlock`` with a shortcut registers its third norm both as
``norm3`` and as ``downsample.1``), so a published checkpoint loads with
``load_state_dict`` once its ``module.`` prefix is stripped. Defaults are
the published evaluation's: ``n_downsample 2``, three GRU levels of 128,
``corr_levels 4``, ``corr_radius 4``, ``valid_iters 32``, no shared backbone
and no slow-fast GRU.

Layout. Activations are channels-last inside, as the port's other models
keep them (``ecm_torch/__init__.py``): every tensor that reaches a
convolution is the channels-first view of an NHWC tensor, and the model
holds every convolution's weight channels-last, so cuDNN reads and writes
NHWC directly and transposes nothing. Instance norm is
``ops/instance_norm.py``, since ``F.instance_norm`` returns NCHW. The
lookup writes NCHW and its coordinates are NCHW ``[B, 2, H, W]`` float32:
its output is made channels-last once an iteration, the flow update
``delta`` channels-first once an iteration, the mask once a forward.

Precision. ``dtype`` float16 is the published ``--mixed_precision``,
written as explicit casts where autocast casts. The model holds every
convolution's weight and bias in ``dtype`` (``load_state_dict`` of a
float32 checkpoint rounds them, as autocast does at each call), so every
convolution runs in ``dtype``; the BatchNorms' parameters and statistics
stay float32, as cuDNN's NHWC kernel takes them. The GRUs' gates and state
updates (``ops/conv_gru.py``) add the biases and the context sums to the
convolutions' ``dtype`` outputs in float32, apply the sigmoids, the tanh
and the products in float32 and round once where they store (``z``,
``r h``, the new state), where the published rounds each step under
autocast. The hidden states and the normalisations stay in ``dtype``, and
the features are widened to float32 for the correlation volume, its pyramid
and the coordinates, which stay float32. The lookup writes ``dtype``
(published: float32, then autocast's cast at ``convc1``). The flow enters
the motion encoder in ``dtype``, where autocast's cast would round it.
``dtype`` float32 computes everything in float32.

Departures from the published code:

- the forward takes the port's channels-last ImageNet-normalised
  ``[B, H, W, 3]`` images and maps them to the published ``2 (p / 255) - 1``
  as ``2 (x std + mean) - 1``, per channel, on the card;
- the pyramid has ``corr_levels`` levels (the published builds a fifth,
  which no lookup reads), and the lookup is one CUDA launch for all levels
  (``ops/cuda_corr1d.py``) where the published calls ``grid_sample`` a level;
- nothing reads a value on the host or copies from it: the tap offsets and
  the pixel grid are made on the card (the published ``linspace`` is built
  on the host each call) and there is no ``torch.unique`` assert, so a
  forward is one CUDA graph (``train/graphs.py``);
- each ConvGRU computes ``convz`` and ``convr`` as one convolution of
  stacked weights, made once a forward, and runs its biases, context sums,
  gates and update in three kernels (``ops/conv_gru.py``); the state dict
  keeps the published convolutions;
- only the x channel of the last flow is upsampled (the published upsamples
  both and keeps x); the result is the disparity ``-flow_x``, ``[B, H, W]``
  float32, the last (and only) entry of the returned list;
- weights are initialised as the port's other models are
  (``layers.init_weights``); the published uses kaiming-normal encoders
  and torch's defaults elsewhere. Training is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ecm_torch.ops.conv_gru import conv_gru_gate, conv_gru_pack, conv_gru_update
from ecm_torch.ops.cuda_corr1d import corr1d_lookup, corr_pyramid
from ecm_torch.ops.instance_norm import instance_norm
from ecm_torch.utils.profiling import span

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CL = torch.channels_last


def conv(m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``m`` on the channels-last ``x``, in the model's dtype."""
    return F.conv2d(x, m.weight, m.bias, m.stride, m.padding)


class InstanceNorm(nn.Module):
    """The published ``nn.InstanceNorm2d(c)``, which has no parameters and no
    state, in the channels-last layout (``ops/instance_norm.py``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x)


def _norm(kind: str, channels: int) -> nn.Module:
    return nn.BatchNorm2d(channels) if kind == "batch" else InstanceNorm()


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, cout: int, norm: str, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1, stride=stride)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.norm1 = _norm(norm, cout)
        self.norm2 = _norm(norm, cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.norm3 = _norm(norm, cout)
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride=stride), self.norm3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(conv(self.conv1, x)))
        y = F.relu(self.norm2(conv(self.conv2, y)))
        if self.downsample is not None:
            x = self.norm3(conv(self.downsample[0], x))
        return F.relu(x + y)


def _layer(cin: int, cout: int, norm: str, stride: int) -> nn.Sequential:
    return nn.Sequential(ResidualBlock(cin, cout, norm, stride), ResidualBlock(cout, cout, norm, 1))


class _Trunk(nn.Module):
    """The 7x7 stem and ``layer1``-``layer3`` shared by both encoders' layouts."""

    def __init__(self, norm: str, downsample: int):
        super().__init__()
        self.norm1 = _norm(norm, 64)
        self.conv1 = nn.Conv2d(3, 64, 7, stride=1 + (downsample > 2), padding=3)
        self.layer1 = _layer(64, 64, norm, 1)
        self.layer2 = _layer(64, 96, norm, 1 + (downsample > 1))
        self.layer3 = _layer(96, 128, norm, 1 + (downsample > 0))

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.norm1(conv(self.conv1, x)))
        return self.layer3(self.layer2(self.layer1(x)))


class BasicEncoder(_Trunk):
    """``fnet``: instance norm, one ``output_dim`` map at 1/2**downsample."""

    def __init__(self, output_dim: int = 256, downsample: int = 2):
        super().__init__("instance", downsample)
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(self.conv2, self.trunk(x))


class MultiBasicEncoder(_Trunk):
    """``cnet``: BatchNorm; for each GRU level (1/4, 1/8, 1/16 at downsample
    2) a hidden and a context map."""

    def __init__(self, hidden_dims: tuple[int, ...], downsample: int = 2):
        super().__init__("batch", downsample)
        self.layer4 = _layer(128, 128, "batch", 2)
        self.layer5 = _layer(128, 128, "batch", 2)
        self.outputs08 = nn.ModuleList(
            nn.Sequential(ResidualBlock(128, 128, "batch"), nn.Conv2d(128, hidden_dims[2], 3, padding=1))
            for _ in range(2))
        self.outputs16 = nn.ModuleList(
            nn.Sequential(ResidualBlock(128, 128, "batch"), nn.Conv2d(128, hidden_dims[1], 3, padding=1))
            for _ in range(2))
        self.outputs32 = nn.ModuleList(nn.Conv2d(128, hidden_dims[0], 3, padding=1) for _ in range(2))

    def forward(self, x: torch.Tensor) -> list[tuple[torch.Tensor, torch.Tensor]]:
        x = self.trunk(x)
        y = self.layer4(x)
        z = self.layer5(y)
        head = lambda f, v: conv(f[1], f[0](v))  # noqa: E731
        return [tuple(head(f, x) for f in self.outputs08), tuple(head(f, y) for f in self.outputs16),
                tuple(conv(f, z) for f in self.outputs32)]


class ConvGRU(nn.Module):
    def __init__(self, hidden: int, inputs: int):
        super().__init__()
        self.convz = nn.Conv2d(hidden + inputs, hidden, 3, padding=1)
        self.convr = nn.Conv2d(hidden + inputs, hidden, 3, padding=1)
        self.convq = nn.Conv2d(hidden + inputs, hidden, 3, padding=1)

    def zr_weight(self) -> torch.Tensor:
        """``convz``'s and ``convr``'s weights stacked, channels-last: one
        convolution computes both gates' sums (made once a forward)."""
        return torch.cat([self.convz.weight, self.convr.weight])

    def forward(self, h, w_zr, cz, cr, cq, *xs):
        """The published cell (``ops/conv_gru.py``) as five device
        operations: ``hx = [h | xs]``; one bias-free convolution of ``hx``
        by ``w_zr`` (:meth:`zr_weight`); the gates, which store ``z`` and
        leave ``hx = [r h | xs]``; a bias-free ``convq`` of ``hx``; the
        update. The biases and context sums are added in the gates' and the
        update's float32."""
        hx = conv_gru_pack(h, xs)
        z = conv_gru_gate(F.conv2d(hx, w_zr, None, 1, 1), self.convz.bias, self.convr.bias, cz, cr, h, hx)
        return conv_gru_update(F.conv2d(hx, self.convq.weight, None, 1, 1), self.convq.bias, cq, z, h)


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_channels: int):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_channels, 64, 1)
        self.convc2 = nn.Conv2d(64, 64, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 64, 7, padding=3)
        self.convf2 = nn.Conv2d(64, 64, 3, padding=1)
        self.conv = nn.Conv2d(128, 126, 3, padding=1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        c = F.relu(conv(self.convc2, F.relu(conv(self.convc1, corr))))
        f = F.relu(conv(self.convf2, F.relu(conv(self.convf1, flow))))
        return torch.cat([F.relu(conv(self.conv, torch.cat([c, f], 1))), flow], 1)


class FlowHead(nn.Module):
    def __init__(self, hidden: int = 128):
        super().__init__()
        self.conv1 = nn.Conv2d(hidden, 256, 3, padding=1)
        self.conv2 = nn.Conv2d(256, 2, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(self.conv2, F.relu(conv(self.conv1, x)))


def pool2x(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=2, padding=1)


def interp(x: torch.Tensor, dest: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, dest.shape[2:], mode="bilinear", align_corners=True)


class BasicMultiUpdateBlock(nn.Module):
    """The three GRU levels (``gru08`` at 1/4, ``gru16``, ``gru32``), the
    motion encoder, the flow head and the mask head (published names)."""

    def __init__(self, hidden_dims: tuple[int, ...], corr_channels: int, factor: int):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_channels)
        self.gru08 = ConvGRU(hidden_dims[2], 128 + hidden_dims[1])
        self.gru16 = ConvGRU(hidden_dims[1], hidden_dims[0] + hidden_dims[2])
        self.gru32 = ConvGRU(hidden_dims[0], hidden_dims[1])
        self.flow_head = FlowHead(hidden_dims[2])
        self.mask = nn.Sequential(nn.Conv2d(hidden_dims[2], 256, 3, padding=1), nn.ReLU(),
                                  nn.Conv2d(256, factor**2 * 9, 1))

    def forward(self, net: list[torch.Tensor], inp: list[tuple], corr: torch.Tensor, flow: torch.Tensor,
                w_zr: tuple[torch.Tensor, ...]):
        """``w_zr``: each level's ``ConvGRU.zr_weight``, in ``inp``'s order."""
        net08, net16, net32 = net
        net32 = self.gru32(net32, w_zr[2], *inp[2], pool2x(net16))
        net16 = self.gru16(net16, w_zr[1], *inp[1], pool2x(net08), interp(net32, net16))
        motion = self.encoder(flow, corr)
        net08 = self.gru08(net08, w_zr[0], *inp[0], motion, interp(net16, net08))
        delta = self.flow_head(net08)
        mask = 0.25 * conv(self.mask[2], F.relu(conv(self.mask[0], net08)))
        return [net08, net16, net32], mask, delta


def upsample_flow(flow: torch.Tensor, mask: torch.Tensor, factor: int) -> torch.Tensor:
    """Convex upsampling: each fine pixel a softmax-weighted sum of its coarse
    3x3 neighbourhood of ``factor * flow``."""
    n, d, h, w = flow.shape
    mask = mask.reshape(n, 1, 9, factor, factor, h, w).softmax(2)
    up = F.unfold(factor * flow, [3, 3], padding=1).view(n, d, 9, 1, 1, h, w)
    up = (mask * up).sum(2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(n, d, factor * h, factor * w)


class RAFTStereo(nn.Module):
    """``forward(left, right)``: channels-last ImageNet-normalised
    ``[B, H, W, 3]`` images (H, W multiples of 2**(n_downsample + 2)) ->
    ``[disparity [B, H, W]]`` after ``iters`` updates."""

    def __init__(self, hidden_dims: tuple[int, ...] = (128, 128, 128), corr_levels: int = 4,
                 corr_radius: int = 4, n_downsample: int = 2, iters: int = 32,
                 dtype: torch.dtype = torch.float16):
        super().__init__()
        self.hidden_dims = tuple(hidden_dims)
        if len(self.hidden_dims) != 3:
            raise ValueError("the port's RAFT-Stereo has three GRU levels (n_gru_layers 3)")
        self.corr_levels, self.corr_radius = corr_levels, corr_radius
        self.n_downsample, self.iters, self.dtype = n_downsample, iters, dtype
        self.cnet = MultiBasicEncoder(self.hidden_dims, n_downsample)
        self.update_block = BasicMultiUpdateBlock(self.hidden_dims, corr_levels * (2 * corr_radius + 1),
                                                  2**n_downsample)
        self.context_zqr_convs = nn.ModuleList(nn.Conv2d(d, 3 * d, 3, padding=1) for d in self.hidden_dims)
        self.fnet = BasicEncoder(256, n_downsample)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.to(dtype, memory_format=CL)

    def _image(self, x: torch.Tensor) -> torch.Tensor:
        """ImageNet-normalised ``[B, H, W, 3]`` -> ``2 p / 255 - 1``, the
        channels-first view of a channels-last tensor."""
        x = x.float()
        channels = [2 * (x[..., c] * s + m) - 1 for c, (m, s) in enumerate(zip(IMAGENET_MEAN, IMAGENET_STD))]
        return torch.stack(channels, -1).permute(0, 3, 1, 2)

    def forward(self, left: torch.Tensor, right: torch.Tensor) -> list[torch.Tensor]:
        dt = self.dtype
        with span("ecm.raft.encode"):
            img1, img2 = self._image(left).to(dt), self._image(right).to(dt)
            levels = self.cnet(img1)
            fmap1, fmap2 = self.fnet(torch.cat([img1, img2])).float().split(img1.shape[0])
            net = [torch.tanh(h) for h, _ in levels]
            # each third dense once, not a strided view in 32 iterations' gate sums
            inp = [tuple(t.contiguous(memory_format=CL) for t in conv(c, F.relu(x)).split(c.out_channels // 3, 1))
                   for c, (_, x) in zip(self.context_zqr_convs, levels)]
        with span("ecm.raft.volume"):
            pyramid = corr_pyramid(fmap1, fmap2, self.corr_levels)
        b, _, h, w = fmap1.shape
        xs = torch.arange(w, dtype=torch.float32, device=fmap1.device).view(1, 1, 1, w).expand(b, 1, h, w)
        ys = torch.arange(h, dtype=torch.float32, device=fmap1.device).view(1, 1, h, 1).expand(b, 1, h, w)
        coords0 = torch.cat([xs, ys], 1)
        coords1 = coords0.clone()
        ub = self.update_block
        w_zr = tuple(g.zr_weight() for g in (ub.gru08, ub.gru16, ub.gru32))
        for _ in range(self.iters):
            with span("ecm.raft.update"):
                corr = corr1d_lookup(pyramid, coords1, self.corr_radius, dt).contiguous(memory_format=CL)
                flow = (coords1 - coords0).to(dt, memory_format=CL)
                net, mask, delta = self.update_block(net, inp, corr, flow, w_zr)
                delta[:, 1] = 0
                coords1 = coords1 + delta.contiguous()
        with span("ecm.raft.upsample"):
            flow_up = upsample_flow((coords1 - coords0)[:, :1], mask, 2**self.n_downsample)
        return [-flow_up[:, 0]]
