"""Conv/BN building blocks (port of ``ecm_tpu/models/layers.py``).

Every module takes and returns channels-last tensors (NHWC for 2D, NDHWC for
3D) and runs torch's channels-first ops on a permuted view. Parameters stay
f32; convolutions cast their weights to the activation dtype (bf16 on the
serving path), and BatchNorm computes in f32 from f32 statistics, as the JAX
modules do. Padding is explicit, ``dilation * (k // 2)``.

BatchNorm keeps flax's training semantics (``BatchNorm2d``/``BatchNorm3d``
below): the running variance folds in the *biased* batch variance, and
:func:`remat` recomputes a block without updating the running statistics a
second time, as ``nn.remat`` does. Under an active mesh
(``ecm_torch.parallel.use_mesh``) the statistics are the global batch's, as
flax's are under GSPMD's data sharding. Under a mesh with a disparity axis
the 3D modules run on this rank's slab of the disparities
(``ecm_torch.parallel.halo``): the convolution on the halo-padded slab, then
the crop to the planes this rank owns, then BatchNorm and ReLU, whose
training statistics are the whole grid's (data x disp); the 2D modules'
stay the data axis's, as every rank of a disp group computes them whole.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ecm_torch.ops.cuda_gband import gband_conv_s1
from ecm_torch.parallel.halo import slab_down, slab_s1, slab_up
from ecm_torch.parallel.sharding import active_mesh, reduction_mesh, use_mesh

# single source of truth for the BatchNorm epsilon (torch default), shared by
# the BN modules and the eval-time BN folds of the fused aggregation path
BN_EPS = 1e-5

_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def _trunc_normal_(t: torch.Tensor, fan: int, scale: float, gen: torch.Generator) -> None:
    """Drawn in f32 into a contiguous tensor and copied into ``t``: the same
    values, rounded to ``t``'s dtype, whatever its dtype and layout."""
    std = math.sqrt(scale / fan) / _TRUNC_STD
    draw = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    nn.init.trunc_normal_(draw, 0.0, std, -2 * std, 2 * std, generator=gen)
    t.copy_(draw)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initialisation, drawn from ``generator``: He-normal
    fan_out (truncated) for convolutions, LeCun-normal fan_in for linear
    layers, zero biases, identity BatchNorm."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.ConvTranspose3d)):
            _trunc_normal_(m.weight, m.out_channels * math.prod(m.kernel_size), 2.0, generator)
        elif isinstance(m, nn.Linear):
            _trunc_normal_(m.weight, m.in_features, 1.0, generator)
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
            continue
        else:
            continue
        if m.bias is not None:
            m.bias.zero_()


def _w(p: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor | None:
    return None if p is None else p.to(dtype)


def conv(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply conv module ``m`` to channels-first ``x`` with its weights cast
    to ``x``'s dtype."""
    w, b = _w(m.weight, x.dtype), _w(m.bias, x.dtype)
    if isinstance(m, nn.ConvTranspose3d):
        return F.conv_transpose3d(
            x, w, b, m.stride, m.padding, m.output_padding, m.groups, m.dilation
        )
    fn = F.conv3d if isinstance(m, nn.Conv3d) else F.conv2d
    return fn(x, w, b, m.stride, m.padding, m.dilation, m.groups)


def linear(m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, _w(m.weight, x.dtype), _w(m.bias, x.dtype))


_stats = threading.local()


@contextlib.contextmanager
def frozen_batch_stats():
    """Inside, BatchNorm in training normalises with batch statistics but
    leaves its running statistics alone (a recomputation under :func:`remat`)."""
    prev = getattr(_stats, "frozen", False)
    _stats.frozen = True
    try:
        yield
    finally:
        _stats.frozen = prev


@contextlib.contextmanager
def _recomputing(mesh):
    with frozen_batch_stats(), use_mesh(mesh):
        yield


def remat(fn, *args):
    """``fn(*args)`` under activation checkpointing (``nn.remat`` in JAX): the
    backward recomputes ``fn``'s activations, with the running statistics of
    its BatchNorms frozen, so they are updated once per step. The
    recomputation runs under the mesh of the forward: on a GPU autograd runs
    it on a thread of its own, which does not see the caller's mesh. The
    models draw no random numbers, so no generator state is saved for the
    recomputation (reading the CUDA generator's state would fail a CUDA
    graph's capture of the step)."""
    mesh = active_mesh()
    return checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(), _recomputing(mesh)),
    )


class _FlaxBatchNorm:
    """flax ``nn.BatchNorm`` in training (momentum 0.9, i.e. torch's 0.1):
    batch mean and biased variance in f32 over every dim but C, normalised in
    f32 and returned in the input's dtype; the running statistics fold in
    the biased variance (torch's own BatchNorm folds in the unbiased one).
    At eval, torch's BatchNorm with the running statistics.

    Under a mesh of more than one rank the batch is the group's: the count,
    the mean and then the sum of squared deviations from it (two passes, as
    on one process) are summed over the ranks through ``Mesh.sum``, whose
    backward sums the ranks' gradients, so forward and backward are those
    of one BatchNorm over the concatenated batch: over the data axis, or
    with ``over_grid`` (``BatchNorm3d``, whose input is this rank's slab of
    the disparities under a disp mesh) over the whole grid.
    ``nn.SyncBatchNorm`` is not used: it folds in the unbiased variance."""

    over_grid = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        self._check_input_dim(x)
        c = x.shape[1]
        n = x.numel() // c
        mesh = reduction_mesh(self.over_grid)
        if mesh is not None:
            # every rank holds at least one value a channel: the global
            # count is at least 2, so flax's one-value case cannot arise
            y, mean, var = _global_batch_norm(x, self.weight, self.bias, self.eps, mesh, self.over_grid)
        elif n > 1:
            # with momentum 1, batch_norm writes the batch mean and the
            # unbiased batch variance into these two buffers
            mean = torch.zeros_like(self.running_mean)
            var = torch.ones_like(self.running_var)
            y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
            var = var * ((n - 1) / n)
        else:
            # one value per channel (an SPP branch pooled to 1x1 at batch 1):
            # flax's mean is the value and its variance 0, so y is the bias
            shape = (1, c) + (1,) * (x.ndim - 2)
            xf = x.float()
            var = torch.zeros_like(self.running_var)
            y = (xf - xf).mul(torch.rsqrt(var + self.eps).mul(self.weight).view(shape))
            y = y.add(self.bias.view(shape)).to(x.dtype)
            mean = xf.detach().reshape(c)
        if not getattr(_stats, "frozen", False):
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                self.running_var.mul_(1.0 - m).add_(var, alpha=m)
                self.num_batches_tracked += 1
        return y


def _global_batch_norm(x, weight, bias, eps, mesh, grid=False):
    """``(y, mean, biased var)`` of channels-first ``x`` over every dim but C
    and over the ranks of ``mesh`` (``Mesh.sum(..., grid)``), in f32 (f64
    for f64 ``x``); ``y`` in ``x``'s dtype."""
    c = x.shape[1]
    dims = [0, *range(2, x.ndim)]
    shape = (1, c) + (1,) * (x.ndim - 2)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    sums = mesh.sum(torch.cat([xf.sum(dims), xf.new_full((1,), x.numel() // c)]), grid)
    count = sums[c:].detach()
    mean = sums[:c] / count
    dev = xf - mean.view(shape)
    var = mesh.sum(dev.square().sum(dims), grid) / count
    y = dev * (torch.rsqrt(var + eps) * weight).view(shape) + bias.view(shape)
    return y.to(x.dtype), mean.detach(), var.detach()


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    pass


class BatchNorm3d(_FlaxBatchNorm, nn.BatchNorm3d):
    over_grid = True


def fold_bn(bn: nn.modules.batchnorm._BatchNorm) -> tuple[torch.Tensor, torch.Tensor]:
    """Inference-fold a BatchNorm into per-channel f32 (scale, bias), made
    from its four tensors at every call."""
    return _fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var)


def _fold_bn(weight, bias, mean, var) -> tuple[torch.Tensor, torch.Tensor]:
    scale = weight / torch.sqrt(var + BN_EPS)
    return scale, bias - mean * scale


class ConvBN(nn.Module):
    """Bias-free conv (2D or 3D) + BatchNorm, optional ReLU."""

    def __init__(
        self, cin: int, cout: int, kernel_size: int = 3, stride: int = 1,
        dilation: int = 1, relu: bool = True, ndim: int = 2,
    ):
        super().__init__()
        conv_cls = nn.Conv2d if ndim == 2 else nn.Conv3d
        bn_cls = BatchNorm2d if ndim == 2 else BatchNorm3d
        self.conv = conv_cls(
            cin, cout, kernel_size, stride=stride, padding=dilation * (kernel_size // 2),
            dilation=dilation, bias=False,
        )
        self.bn = bn_cls(cout, eps=BN_EPS, momentum=0.1)
        self.relu = relu

    def _bn_relu(self, y: torch.Tensor) -> torch.Tensor:
        y = self.bn(y)
        return F.relu(y) if self.relu else y

    def forward_cf(self, x: torch.Tensor) -> torch.Tensor:
        """Channels-first in, channels-first out."""
        return self._bn_relu(conv(self.conv, x))

    def forward(self, x: torch.Tensor, gband: bool = False) -> torch.Tensor:
        """``gband``: the conv through ``gband_conv_s1`` (a 3D stride-1 conv
        of the full-resolution stack in training, JAX's ``GConv3D`` path). A
        3D conv runs on this rank's disparity slab under a disp mesh, and
        BatchNorm sees only the planes this rank owns."""
        if isinstance(self.conv, nn.Conv3d):
            if self.conv.stride[0] == 2:
                y = slab_down(self._conv, x)
            else:
                y = slab_s1(lambda v: self._conv(v, gband), x)
            return self._bn_relu(y.movedim(-1, 1)).movedim(1, -1)
        return self.forward_cf(x.movedim(-1, 1)).movedim(1, -1)

    def _conv(self, x: torch.Tensor, gband: bool = False) -> torch.Tensor:
        """The bias-free conv of NDHWC ``x``, NDHWC out."""
        if gband:
            return gband_conv_s1(x, self.conv.weight)
        return conv(self.conv, x.movedim(-1, 1)).movedim(1, -1)


class ConvTransposeBN(nn.Module):
    """ConvTranspose3d(k=3, s=2, p=1, op=1), which doubles each dim, + BN."""

    def __init__(self, cin: int, cout: int, relu: bool = False):
        super().__init__()
        self.deconv = nn.ConvTranspose3d(
            cin, cout, 3, stride=2, padding=1, output_padding=1, bias=False
        )
        self.bn = BatchNorm3d(cout, eps=BN_EPS, momentum=0.1)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """On this rank's disparity slab under a disp mesh, BatchNorm on the
        planes this rank owns."""
        y = self.bn(slab_up(lambda v: conv(self.deconv, v.movedim(-1, 1)).movedim(1, -1), x).movedim(-1, 1))
        return (F.relu(y) if self.relu else y).movedim(1, -1)


class BasicBlock(nn.Module):
    """Residual block: convbn-ReLU, convbn, plus the identity or a strided
    1x1-conv shortcut; no final ReLU (the PSMNet-family quirk)."""

    def __init__(self, cin: int, cout: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        self.conv1 = ConvBN(cin, cout, stride=stride, dilation=dilation, relu=True)
        self.conv2 = ConvBN(cout, cout, stride=1, dilation=dilation, relu=False)
        self.downsample = (
            nn.Conv2d(cin, cout, 1, stride=stride, bias=False)
            if stride != 1 or cin != cout
            else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xc = x.movedim(-1, 1)
        out = self.conv2.forward_cf(self.conv1.forward_cf(xc))
        if self.downsample is not None:
            xc = conv(self.downsample, xc)
        return (out + xc).movedim(1, -1)
