"""Plain PyTorch reference of RAFT-Stereo's eval forward (Lipson, Teed and
Deng, 3DV 2021; github.com/princeton-vl/RAFT-Stereo), in float32 on
channels-first tensors, with ``torch.nn.functional`` ops alone.

It imports nothing of the program under test: it reads a state dict by the
published names (``fnet.layer1.0.conv1.weight``, ``cnet.outputs08.0.1.bias``,
``update_block.gru08.convz.weight``, ...), made by the benchmark, and takes
the sizes (hidden widths, pyramid levels) from the weights' shapes. The
published evaluation's settings: ``n_downsample 2`` (a 7x7 stem at full
resolution), instance norm in ``fnet``, BatchNorm in ``cnet``, three GRU
levels, ``corr_radius 4``, the lookup by ``grid_sample`` a level.

Departures from the published code:

- the images come in as the benchmark makes them, channels-last and
  ImageNet-normalised, and are mapped to the published ``2 p / 255 - 1`` as
  ``2 (x std + mean) - 1``;
- the pyramid has the levels the lookup reads (the published builds a
  fifth, which none reads);
- there is no ``torch.unique`` assert on the sampling grid (its rows are 0
  by construction), and the tap offsets are made with ``arange`` on the
  images' device;
- only the x channel of the last flow is upsampled (the published
  upsamples both and keeps x), and the disparity is ``-flow_x``;
- :meth:`Net.forward` also returns each iteration's flow update, and in
  ``train`` mode ``cnet``'s BatchNorms use batch statistics, which it
  records (the benchmark's weights recipe reads both).

``precision`` says where values are rounded, as in ``reference/ecm.py``:
:data:`EXACT` nowhere; :data:`FP8`, the control, as a program computing in
float8 e4m3 under a per-tensor scale would round where the program under
test rounds to float16: every convolution's weights and biases, and every
activation the encoders and the update block store (the images, each
convolution's, norm's, sum's, product's, gate's, pool's and resize's
output, the lookup's output and the flow the motion encoder reads). The
features are widened to float32 for the correlation, and the correlation,
its pyramid, the coordinates and the upsampling's sums stay float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .ecm import EXACT, FP8, strict_f32

__all__ = ["EXACT", "FP8", "Net", "infer", "strict_f32"]

BN_EPS = 1e-5
IN_EPS = 1e-5
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


class Net:
    """The network over the parameters ``p`` (name -> float32 tensor) with
    ``levels`` pyramid levels of radius ``radius``, ``n_downsample``, and
    ``iters`` updates; ``train``: ``cnet``'s BatchNorms on batch statistics."""

    def __init__(self, p: dict[str, torch.Tensor], iters: int, levels: int = 4, radius: int = 4,
                 n_downsample: int = 2, train: bool = False, precision=EXACT):
        self.p, self.iters, self.levels, self.radius = p, iters, levels, radius
        self.ds, self.train = n_downsample, train
        self.w, self.s = precision
        self.stats: list[tuple[str, torch.Tensor, torch.Tensor]] = []

    # -- building blocks ---------------------------------------------------
    def conv(self, x: torch.Tensor, name: str, stride: int = 1) -> torch.Tensor:
        w, b = self.p[f"{name}.weight"], self.p.get(f"{name}.bias")
        y = F.conv2d(x, self.w(w), None if b is None else self.w(b), stride, w.shape[-1] // 2)
        return self.s(y)

    def norm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """BatchNorm where ``name`` has a scale, else instance norm."""
        if f"{name}.weight" not in self.p:
            mean = x.mean((2, 3), keepdim=True)
            var = (x - mean).square().mean((2, 3), keepdim=True)
            return self.s((x - mean) * torch.rsqrt(var + IN_EPS))
        if self.train:
            mean = x.mean((0, 2, 3))
            var = (x - mean.view(1, -1, 1, 1)).square().mean((0, 2, 3))
            self.stats.append((name, mean, var))
        else:
            mean, var = self.p[f"{name}.running_mean"], self.p[f"{name}.running_var"]
        v = lambda t: t.view(1, -1, 1, 1)  # noqa: E731
        y = (x - v(mean)) * torch.rsqrt(v(var) + BN_EPS) * v(self.p[f"{name}.weight"]) + v(self.p[f"{name}.bias"])
        return self.s(y)

    def block(self, x: torch.Tensor, name: str, stride: int = 1) -> torch.Tensor:
        y = F.relu(self.norm(self.conv(x, f"{name}.conv1", stride), f"{name}.norm1"))
        y = F.relu(self.norm(self.conv(y, f"{name}.conv2"), f"{name}.norm2"))
        if f"{name}.downsample.0.weight" in self.p:
            x = self.norm(self.conv(x, f"{name}.downsample.0", stride), f"{name}.downsample.1")
        return F.relu(self.s(x + y))

    def layer(self, x: torch.Tensor, name: str, stride: int) -> torch.Tensor:
        return self.block(self.block(x, f"{name}.0", stride), f"{name}.1")

    def trunk(self, x: torch.Tensor, enc: str) -> torch.Tensor:
        x = F.relu(self.norm(self.conv(x, f"{enc}.conv1", 1 + (self.ds > 2)), f"{enc}.norm1"))
        x = self.layer(x, f"{enc}.layer1", 1)
        x = self.layer(x, f"{enc}.layer2", 1 + (self.ds > 1))
        return self.layer(x, f"{enc}.layer3", 1 + (self.ds > 0))

    def gru(self, name: str, h, cz, cr, cq, *xs) -> torch.Tensor:
        x = torch.cat(xs, 1)
        hx = torch.cat([h, x], 1)
        z = self.s(torch.sigmoid(self.s(self.conv(hx, f"{name}.convz") + cz)))
        r = self.s(torch.sigmoid(self.s(self.conv(hx, f"{name}.convr") + cr)))
        q = self.s(torch.tanh(self.s(self.conv(torch.cat([self.s(r * h), x], 1), f"{name}.convq") + cq)))
        return self.s(self.s(self.s(1 - z) * h) + self.s(z * q))

    def pool2x(self, x: torch.Tensor) -> torch.Tensor:
        return self.s(F.avg_pool2d(x, 3, stride=2, padding=1))

    def interp(self, x: torch.Tensor, dest: torch.Tensor) -> torch.Tensor:
        return self.s(F.interpolate(x, dest.shape[2:], mode="bilinear", align_corners=True))

    # -- the network -------------------------------------------------------
    def image(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return self.s(torch.stack([2 * (x[..., c] * s + m) - 1 for c, (m, s) in enumerate(zip(MEAN, STD))], 1))

    def context(self, img: torch.Tensor):
        """``cnet``: (hidden, context) at 1/4, 1/8, 1/16."""
        x = self.trunk(img, "cnet")
        y = self.layer(x, "cnet.layer4", 2)
        z = self.layer(y, "cnet.layer5", 2)
        heads = lambda lvl, v: tuple(self.conv(self.block(v, f"cnet.{lvl}.{i}.0"), f"cnet.{lvl}.{i}.1")  # noqa: E731
                                     for i in range(2))
        return [heads("outputs08", x), heads("outputs16", y),
                tuple(self.conv(z, f"cnet.outputs32.{i}") for i in range(2))]

    def pyramid(self, f1: torch.Tensor, f2: torch.Tensor) -> list[torch.Tensor]:
        """The float32 correlation ``[B*H*W1, 1, 1, W2 >> i]`` of each level."""
        b, c, h, w1 = f1.shape
        corr = torch.einsum("aijk,aijh->ajkh", f1, f2) / torch.sqrt(torch.tensor(float(c)))
        out = [corr.reshape(b * h * w1, 1, 1, -1)]
        for _ in range(self.levels - 1):
            out.append(F.avg_pool2d(out[-1], [1, 2], stride=[1, 2]))
        return out

    def lookup(self, pyramid: list[torch.Tensor], coords: torch.Tensor) -> torch.Tensor:
        r = self.radius
        b, _, h, w1 = coords.shape
        dx = torch.arange(-r, r + 1, dtype=torch.float32, device=coords.device).view(2 * r + 1, 1)
        out = []
        for i, corr in enumerate(pyramid):
            x0 = dx + coords[:, :1].permute(0, 2, 3, 1).reshape(b * h * w1, 1, 1, 1) / 2**i
            w = corr.shape[-1]
            grid = torch.cat([2 * x0 / (w - 1) - 1, torch.zeros_like(x0)], -1)
            out.append(F.grid_sample(corr, grid, align_corners=True).view(b, h, w1, -1))
        return self.s(torch.cat(out, -1).permute(0, 3, 1, 2))

    def update(self, net, inp, corr, flow):
        u = "update_block"
        net08, net16, net32 = net
        net32 = self.gru(f"{u}.gru32", net32, *inp[2], self.pool2x(net16))
        net16 = self.gru(f"{u}.gru16", net16, *inp[1], self.pool2x(net08), self.interp(net32, net16))
        e = f"{u}.encoder"
        c = F.relu(self.conv(F.relu(self.conv(corr, f"{e}.convc1")), f"{e}.convc2"))
        f = F.relu(self.conv(F.relu(self.conv(flow, f"{e}.convf1")), f"{e}.convf2"))
        motion = torch.cat([F.relu(self.conv(torch.cat([c, f], 1), f"{e}.conv")), flow], 1)
        net08 = self.gru(f"{u}.gru08", net08, *inp[0], motion, self.interp(net16, net08))
        delta = self.conv(F.relu(self.conv(net08, f"{u}.flow_head.conv1")), f"{u}.flow_head.conv2")
        mask = self.s(0.25 * self.conv(F.relu(self.conv(net08, f"{u}.mask.0")), f"{u}.mask.2"))
        return [net08, net16, net32], mask, delta

    def forward(self, left: torch.Tensor, right: torch.Tensor) -> dict:
        """Channels-last images -> ``disparity`` ``[B, H, W]`` and each
        iteration's flow update ``deltas`` (x channel, ``[B, H/4, W/4]``)."""
        img1, img2 = self.image(left), self.image(right)
        levels = self.context(img1)
        fmaps = self.conv(self.trunk(torch.cat([img1, img2]), "fnet"), "fnet.conv2")
        f1, f2 = fmaps.float().split(img1.shape[0])
        net = [self.s(torch.tanh(h)) for h, _ in levels]
        inp = []
        for i, (_, x) in enumerate(levels):
            zqr = self.conv(F.relu(x), f"context_zqr_convs.{i}")
            inp.append(zqr.split(zqr.shape[1] // 3, 1))
        pyramid = self.pyramid(f1, f2)
        b, _, h, w = f1.shape
        ys, xs = torch.meshgrid(torch.arange(h, device=f1.device), torch.arange(w, device=f1.device), indexing="ij")
        coords0 = torch.stack([xs, ys]).float()[None].repeat(b, 1, 1, 1)
        coords1, deltas, mask = coords0.clone(), [], None
        for _ in range(self.iters):
            corr = self.lookup(pyramid, coords1)
            flow = coords1 - coords0
            net, mask, delta = self.update(net, inp, corr, self.s(flow))
            delta = torch.cat([delta[:, :1], torch.zeros_like(delta[:, 1:])], 1)
            coords1 = coords1 + delta
            deltas.append(delta[:, 0])
        factor = 2**self.ds
        flow = (coords1 - coords0)[:, :1]
        mask = mask.view(b, 1, 9, factor, factor, h, w).softmax(2)
        up = F.unfold(factor * flow, [3, 3], padding=1).view(b, 1, 9, 1, 1, h, w)
        up = (mask * up).sum(2).permute(0, 1, 4, 2, 5, 3).reshape(b, 1, factor * h, factor * w)
        return {"disparity": -up[:, 0], "deltas": deltas}


@torch.inference_mode()
def infer(p: dict[str, torch.Tensor], iters: int, left: torch.Tensor, right: torch.Tensor, precision=EXACT,
          levels: int = 4, radius: int = 4, n_downsample: int = 2) -> torch.Tensor:
    """Eval disparities ``[B, H, W]`` of channels-last images."""
    with strict_f32():
        return Net(p, iters, levels, radius, n_downsample, precision=precision).forward(left, right)["disparity"]
