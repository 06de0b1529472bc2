"""Plain PyTorch reference of the ECM stereo network, its loss and Adam.

Written from the model's description (PSMNet-style feature extractor with
SPP, concat cost volume at 1/4 resolution, three stacked 3D hourglasses with
explicit context maps added before dres1 and before each hourglass, the
classification heads, trilinear upsampling and soft-argmin), in float32 on
channels-first tensors, with plain ``torch.nn.functional`` ops and autograd.
It imports nothing of the program under test: it reads a state dict whose
names follow the model's module tree (``feature.firstconv1.conv.weight``,
``aggregation.hourglass1.conv5.deconv.weight``, ...), made by the benchmark.

``precision`` says where values are rounded: :data:`EXACT`, nowhere (the
float32 reference); :data:`FP8`, the lower-precision control, as a program
computing in float8 e4m3 would round them where the program under test
rounds to bfloat16: every convolution's weights, and every activation the
network stores (the images, each convolution's, BatchNorm's, sum's, pool's
and resize's output) in the forward, each gradient reaching a stored
activation in the backward, each under a per-tensor scale; products are
summed, and the regression and the loss computed, in float32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
STAGE_WEIGHTS = (0.5, 0.7, 1.0)
SPP_POOLS = (64, 32, 16, 8)
FP8_MAX = 448.0  # largest finite float8 e4m3fn
RUNNING = ("running_mean", "running_var")


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to the format's largest value, and back."""
    scale = FP8_MAX / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


def fp8(x: torch.Tensor) -> torch.Tensor:
    """A weight in float8; its gradient passes straight through."""
    return x + (_round_fp8(x.detach()) - x).detach()


class _Fp8Store(torch.autograd.Function):
    """An activation stored in float8: rounded in the forward, its gradient
    rounded in the backward."""

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g)


EXACT = (exact, exact)  # (weights, stored activations)
FP8 = (fp8, _Fp8Store.apply)


@contextlib.contextmanager
def strict_f32():
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Net:
    """The network over the parameters ``p`` (name -> float32 tensor).
    ``train``: BatchNorm on batch statistics and all three heads; else the
    running statistics and the last head."""

    def __init__(self, p: dict[str, torch.Tensor], max_disp: int, train: bool, precision=EXACT):
        self.p, self.max_disp, self.train = p, max_disp, train
        self.w, self.s = precision
        # train: each BatchNorm call's batch mean and variance, in call order
        # (the siamese feature net calls each of its BatchNorms twice a step)
        self.stats: list[tuple[str, torch.Tensor, torch.Tensor]] = []

    # -- building blocks ---------------------------------------------------
    def bn(self, x: torch.Tensor, name: str) -> torch.Tensor:
        p = self.p
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if self.train:
            dims = [0, *range(2, x.ndim)]
            mean = x.mean(dims, keepdim=True)
            var = (x - mean).square().mean(dims, keepdim=True)
            self.stats.append((name, mean.detach().flatten(), var.detach().flatten()))
        else:
            mean, var = p[f"{name}.running_mean"].view(shape), p[f"{name}.running_var"].view(shape)
        y = (x - mean) * torch.rsqrt(var + BN_EPS) * p[f"{name}.weight"].view(shape) + p[f"{name}.bias"].view(shape)
        return self.s(y)

    def conv(self, x, w, bias=None, stride=1, dilation=1, transposed=False):
        k = w.shape[-1]
        if transposed:  # kernel 3, stride 2, padding 1, output padding 1: doubles each dim
            return self.s(F.conv_transpose3d(x, self.w(w), bias, 2, 1, 1))
        fn = F.conv2d if x.ndim == 4 else F.conv3d
        return self.s(fn(x, self.w(w), bias, stride, dilation * (k // 2), dilation))

    def convbn(self, x, name, stride=1, dilation=1, relu=True):
        y = self.bn(self.conv(x, self.p[f"{name}.conv.weight"], stride=stride, dilation=dilation), f"{name}.bn")
        return F.relu(y) if relu else y

    def deconvbn(self, x, name):
        return self.bn(self.conv(x, self.p[f"{name}.deconv.weight"], transposed=True), f"{name}.bn")

    def block(self, x, name, stride=1, dilation=1):
        """Residual block without a final ReLU; a strided 1x1 shortcut where
        the shape changes."""
        out = self.convbn(self.convbn(x, f"{name}.conv1", stride, dilation), f"{name}.conv2", 1, dilation, relu=False)
        short = self.p.get(f"{name}.downsample.weight")
        if short is not None:
            x = self.conv(x, short, stride=stride)
        return self.s(out + x)

    # -- the network -------------------------------------------------------
    def features(self, img: torch.Tensor) -> torch.Tensor:
        """[B, 3, H, W] -> [B, C, H/4, W/4]."""
        f = "feature"
        x = self.convbn(self.s(img), f"{f}.firstconv1", stride=2)
        x = self.convbn(self.convbn(x, f"{f}.firstconv2"), f"{f}.firstconv3")
        for i in range(3):
            x = self.block(x, f"{f}.layer1_{i}")
        x = self.block(x, f"{f}.layer2_0", stride=2)
        for i in range(1, 16):
            x = self.block(x, f"{f}.layer2_{i}")
        raw = x
        for i in range(3):
            x = self.block(x, f"{f}.layer3_{i}", dilation=2)
        for i in range(3):
            x = self.block(x, f"{f}.layer4_{i}", dilation=4)
        h, w = x.shape[-2:]
        branches = []
        for pool in SPP_POOLS:
            win = (min(pool, h), min(pool, w))
            y = self.convbn(self.s(F.avg_pool2d(x, win, win)), f"{f}.branch{pool}.conv")
            branches.append(self.s(F.interpolate(y, size=(h, w), mode="bilinear", align_corners=False)))
        fused = self.convbn(torch.cat([raw, x, *branches], 1), f"{f}.lastconv1")
        return self.conv(fused, self.p[f"{f}.lastconv2.weight"])

    def context(self, fl: torch.Tensor, stage: int) -> torch.Tensor:
        """The 2D context map of ``stage``, [B, C, 1, H, W] (broadcast over D)."""
        a = f"aggregation.context{stage}"
        m = self.convbn(fl, f"{a}.map_conv")
        return self.conv(m, self.p[f"{a}.map_proj.weight"], self.p[f"{a}.map_proj.bias"])[:, :, None]

    def volume(self, fl: torch.Tensor, fr: torch.Tensor) -> torch.Tensor:
        """Concat volume [B, 2C, D/4, H/4, W/4]: left features at x, right at
        x - d, zero where x < d."""
        w = fl.shape[-1]
        both = torch.cat([fl, fr], 1)
        planes = [torch.cat([F.pad(fl[..., d:], (d, 0)), F.pad(fr[..., : w - d], (d, 0))], 1) if d < w
                  else torch.zeros_like(both) for d in range(self.max_disp // 4)]
        return torch.stack(planes, 2)

    def hourglass(self, x, i, presqu, postsqu, residual):
        h = f"aggregation.hourglass{i}"
        out = self.convbn(x, f"{h}.conv1", stride=2)
        pre = self.convbn(out, f"{h}.conv2", relu=False)
        pre = F.relu(self.s(pre + postsqu)) if postsqu is not None else F.relu(pre)
        out = self.convbn(self.convbn(pre, f"{h}.conv3", stride=2), f"{h}.conv4")
        post = F.relu(self.s(self.deconvbn(out, f"{h}.conv5") + (presqu if presqu is not None else pre)))
        return self.s(self.deconvbn(post, f"{h}.conv6") + residual), pre, post

    def head(self, x, i):
        c = f"aggregation.classif{i}"
        y = self.convbn(x, f"{c}.conv1")
        return self.conv(y, self.p[f"{c}.conv2.weight"], self.p[f"{c}.conv2.bias"])[:, 0]

    def cost_maps(self, left: torch.Tensor, right: torch.Tensor) -> list[torch.Tensor]:
        """Channels-last images [B, H, W, 3] -> cost maps [B, D/4, H/4, W/4]
        (train: three, chained; eval: the last)."""
        fl = self.features(left.movedim(-1, 1).float())
        fr = self.features(right.movedim(-1, 1).float())
        a = "aggregation"
        x = self.convbn(self.convbn(self.volume(fl, fr), f"{a}.dres0_1"), f"{a}.dres0_2")
        x = self.s(x + self.context(fl, 0))
        cost0 = self.s(self.convbn(self.convbn(x, f"{a}.dres1_1"), f"{a}.dres1_2", relu=False) + x)
        outs, inp, pre1, post = [], cost0, None, None
        for i in (1, 2, 3):
            inp, pre, post = self.hourglass(self.s(inp + self.context(fl, i)), i, pre1, post if i > 1 else None, cost0)
            pre1 = pre if i == 1 else pre1
            outs.append(inp)
        if not self.train:
            return [self.head(outs[-1], 3)]
        costs, prev = [], None
        for i, out in enumerate(outs, 1):
            cost = self.head(out, i)
            prev = cost if prev is None else self.s(cost + prev)
            costs.append(prev)
        return costs

    def regress(self, cost4: torch.Tensor, h: int, w: int) -> torch.Tensor:
        """Trilinear upsampling to [B, D, H, W], then the soft-argmin over D."""
        cost = F.interpolate(cost4[:, None], size=(self.max_disp, h, w), mode="trilinear", align_corners=False)[:, 0]
        prob = torch.softmax(-cost, dim=1)
        idx = torch.arange(self.max_disp, dtype=prob.dtype, device=prob.device).view(1, -1, 1, 1)
        return (prob * idx).sum(1)

    def __call__(self, left: torch.Tensor, right: torch.Tensor) -> list[torch.Tensor]:
        h, w = left.shape[1:3]
        return [self.regress(c, h, w) for c in self.cost_maps(left, right)]


def loss(preds: list[torch.Tensor], gt: torch.Tensor, max_disp: int) -> torch.Tensor:
    """Smooth-L1 (beta 1) over the pixels with 0 < gt < max_disp, averaged,
    the stages weighted 0.5, 0.7, 1.0."""
    mask = ((gt > 0) & (gt < max_disp)).float()
    n = mask.sum().clamp_min(1.0)
    total = 0.0
    weights = STAGE_WEIGHTS if len(preds) == len(STAGE_WEIGHTS) else (1.0,)
    for wgt, pred in zip(weights, preds, strict=True):
        total = total + wgt * (F.smooth_l1_loss(pred, gt, reduction="none", beta=1.0) * mask).sum() / n
    return total


@torch.inference_mode()
def infer(p: dict[str, torch.Tensor], max_disp: int, left: torch.Tensor, right: torch.Tensor,
          precision=EXACT) -> torch.Tensor:
    """Eval disparities [B, H, W] of channels-last images."""
    with strict_f32():
        return Net(p, max_disp, train=False, precision=precision)(left, right)[-1]


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8) at a constant learning rate."""

    def __init__(self, params: dict[str, torch.Tensor], lr: float):
        self.lr, self.t = lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - 0.9 ** self.t, 1 - 0.999 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(0.9).add_(g, alpha=0.1)
            self.v[k].mul_(0.999).addcmul_(g, g, value=0.001)
            params[k].sub_(self.lr * (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + 1e-8))


def train_steps(state: dict[str, torch.Tensor], trainable: list[str], max_disp: int, lr: float,
                batches: list[dict[str, torch.Tensor]], precision=EXACT) -> dict:
    """Adam steps from ``state`` (parameters and BatchNorm statistics; the
    ``trainable`` names are the parameters), one a batch of channels-last
    ``left``, ``right`` and ``disparity``. Returns each step's loss, the
    first step's gradients, the parameters after the last step and the
    BatchNorm running statistics then (each call of a BatchNorm folds in its
    batch mean and biased batch variance at momentum 0.1)."""
    with strict_f32():
        p = {k: v.detach().clone().float() for k, v in state.items()}
        params = {k: p[k] for k in trainable}
        running = {k: v for k, v in p.items() if k.endswith(RUNNING)}
        opt, losses, first = Adam(params, lr), [], None
        for batch in batches:
            leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
            net = Net({**p, **leaves}, max_disp, train=True, precision=precision)
            value = loss(net(batch["left"], batch["right"]), batch["disparity"].float(), max_disp)
            grads = dict(zip(leaves, torch.autograd.grad(value, list(leaves.values()))))
            losses.append(value.item())
            first = grads if first is None else first
            opt.step(params, grads)
            for name, *stats in net.stats:
                for key, batch_stat in zip(RUNNING, stats):
                    running[f"{name}.{key}"].mul_(0.9).add_(batch_stat, alpha=0.1)
            del net, leaves, value
        return {"losses": losses, "first_grads": first, "params": params, "buffers": running}
