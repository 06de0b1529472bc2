"""The benchmark's own count of the work: floating-point operations of the
network, and the operations and bytes of each form the program runs through
its own kernels, from shapes alone; and the published peaks they are held
against.

The FLOP count is of the convolutions (2 a multiply-add), which is all the
arithmetic the network has in matrix form: 2D convolutions at k x k taps,
3D ones at 27, a transposed convolution at its *input* voxels (each scatters
to 27 outputs), dres0_1's input at 2 x width. In training every convolution
also computes its weight gradient and, except the first (whose input is the
image), its input gradient, each as many operations as the forward. The
upsampling and soft-argmin, BatchNorm, pooling and the cost volume are not
counted. ``stereo_bench/tests/test_counts.py`` holds these counts against
``torch.utils.flop_counter.FlopCounterMode`` over the plain reference.
"""

from __future__ import annotations

# NVIDIA H100 SXM (data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# the soft-argmin's exponentials on the special-function units: 16 a clock
# per SM, 132 SMs, 1980 MHz boost clock
PEAK_EXP_PER_S = 16 * 132 * 1.98e9

BF16, F32 = 2, 4
SPP_POOLS = (64, 32, 16, 8)


def _conv(cin: int, cout: int, taps: int, voxels: int) -> float:
    return 2.0 * cin * cout * taps * voxels


def feature_convs(h: int, w: int) -> list[tuple[float, bool]]:
    """(FLOPs, input needs a gradient) of each convolution of the feature
    extractor on one [H, W] image."""
    h2, w2, h4, w4 = h // 2, w // 2, h // 4, w // 4
    n2, n4 = h2 * w2, h4 * w4
    out = [(_conv(3, 32, 9, n2), False), (_conv(32, 32, 9, n2), True), (_conv(32, 32, 9, n2), True)]
    out += [(_conv(32, 32, 9, n2), True)] * 6  # layer1: 3 blocks of 2
    out += [(_conv(32, 64, 9, n4), True), (_conv(64, 64, 9, n4), True), (_conv(32, 64, 1, n4), True)]
    out += [(_conv(64, 64, 9, n4), True)] * 30  # layer2_1..15
    out += [(_conv(64, 128, 9, n4), True), (_conv(128, 128, 9, n4), True), (_conv(64, 128, 1, n4), True)]
    out += [(_conv(128, 128, 9, n4), True)] * 10  # layer3_1..2, layer4_0..2
    for p in SPP_POOLS:
        ph, pw = min(p, h4), min(p, w4)
        out.append((_conv(128, 32, 1, (h4 // ph) * (w4 // pw)), True))
    out.append((_conv(320, 128, 9, n4), True))
    return out


def stereo_convs(h: int, w: int, max_disp: int, c: int = 32, heads: int = 1) -> list[tuple[float, bool]]:
    """(FLOPs, input needs a gradient) of every convolution of one pair's
    forward: both feature extractors, the last 1x1 conv, the four context
    maps, dres0/dres1, three hourglasses and ``heads`` heads."""
    h4, w4 = h // 4, w // 4
    n = (max_disp // 4) * h4 * w4
    out = []
    for _ in range(2):
        out += feature_convs(h, w) + [(_conv(128, c, 1, h4 * w4), True)]
    out += [(_conv(c, 128, 9, h4 * w4), True), (_conv(128, c, 1, h4 * w4), True)] * 4
    out += [(_conv(2 * c, c, 27, n), True)] + [(_conv(c, c, 27, n), True)] * 3
    for _ in range(3):
        out += [
            (_conv(c, 2 * c, 27, n // 8), True),  # conv1, stride 2
            (_conv(2 * c, 2 * c, 27, n // 8), True),  # conv2
            (_conv(2 * c, 2 * c, 27, n // 64), True),  # conv3, stride 2
            (_conv(2 * c, 2 * c, 27, n // 64), True),  # conv4
            (_conv(2 * c, 2 * c, 27, n // 64), True),  # conv5, transposed: input voxels
            (_conv(2 * c, c, 27, n // 8), True),  # conv6, transposed: input voxels
        ]
    out += [(_conv(c, c, 27, n), True), (_conv(c, 1, 27, n), True)] * heads
    return out


def eval_flops(h: int, w: int, max_disp: int, c: int = 32) -> float:
    """FLOPs of one pair's eval forward (the last head only)."""
    return sum(f for f, _ in stereo_convs(h, w, max_disp, c, heads=1))


def train_flops(batch: int, h: int, w: int, max_disp: int, c: int = 32) -> float:
    """FLOPs of one train step on ``batch`` pairs: the forward with three
    heads, and the backward's weight and input gradients."""
    per_pair = sum(f * (3 if grad_in else 2) for f, grad_in in stereo_convs(h, w, max_disp, c, heads=3))
    return batch * per_pair


# -- the program's own kernels: each form's operations and bytes -------------

def _form(ops: float, moved: float, exps: float = 0.0) -> dict:
    return {"ops": ops, "bytes": moved, "exps": exps}


def bound_s(form: dict) -> float:
    """The least time the card could take: the largest of the operations at
    the bf16 tensor-core peak, the exponentials at the SFU peak and the
    bytes (each input read once, each output written once) at the HBM peak."""
    return max(form["ops"] / PEAK_BF16_FLOPS, form["exps"] / PEAK_EXP_PER_S, form["bytes"] / PEAK_BYTES_PER_S)


def _conv3d(cin: int, cout: int, n_in: int, n_out: int, n_taps_at: int, extra: float = 0.0) -> dict:
    """A 3x3x3 conv (+ folded BatchNorm) in bf16: ``n_taps_at`` voxels carry
    the 27 taps (output voxels, or input voxels for a transposed conv)."""
    moved = n_in * cin * BF16 + n_out * cout * BF16 + 27 * cin * cout * BF16 + 2 * cout * F32 + extra
    return _form(_conv(cin, cout, 27, n_taps_at), moved)


def eval_forms(batch: int, h: int, w: int, max_disp: int, c: int = 32) -> dict[str, dict]:
    """The forms an eval forward of the grouped path runs through the
    program's kernels, at ``batch`` pairs: the concat volume, the four
    stride-1 convs (the context map fused into dres0_2, the residual into
    dres1_2), the three stride-2 and three transposed convs (with
    ``+ cost0``), the last head's pair of convs and the regression."""
    h4, w4, d4 = h // 4, w // 4, max_disp // 4
    n = batch * d4 * h4 * w4
    plane = batch * h4 * w4 * c * BF16
    forms = {
        "cost_volume_concat": _form(0.0, 2 * plane + n * 2 * c * BF16),
        "conv3d_bn_s1.dres0_1": _conv3d(2 * c, c, n, n, n),
        "conv3d_bn_s1.dres0_2": _conv3d(c, c, n, n, n, extra=plane),
        "conv3d_bn_s1.dres1_1": _conv3d(c, c, n, n, n),
        "conv3d_bn_s1.dres1_2": _conv3d(c, c, n, n, n, extra=n * c * BF16),
    }
    for i in (1, 2, 3):
        forms[f"conv3d_bn_down.hourglass{i}"] = _conv3d(c, 2 * c, n, n // 8, n // 8)
        forms[f"deconv3d_bn.hourglass{i}"] = _conv3d(2 * c, c, n // 8, n, n // 8, extra=n * c * BF16)
    pair_bytes = n * c * BF16 + n * BF16 + 27 * c * (c + 1) * BF16 + 2 * c * F32 + F32
    forms["fused_conv3d_pair.classif3"] = _form(_conv(c, c, 27, n) + _conv(c, 1, 27, n), pair_bytes)
    forms["fused_upsample_softargmin"] = _form(0.0, n * BF16 + batch * h * w * F32, exps=batch * max_disp * h * w)
    return forms


def train_forms(batch: int, h: int, w: int, max_disp: int, c: int = 32) -> dict[str, dict]:
    """The forms a train step runs through the program's kernels:
    ``gband_conv_s1`` forward and input gradient at the seven full-resolution
    stride-1 convs (dres0_1 from 2 x width, dres0_2, dres1_1, dres1_2 and
    each head's conv1)."""
    n = batch * (max_disp // 4) * (h // 4) * (w // 4)
    forms = {}
    sites = {"dres0_1": 2 * c, "dres0_2": c, "dres1_1": c, "dres1_2": c,
             "classif1.conv1": c, "classif2.conv1": c, "classif3.conv1": c}
    for site, cin in sites.items():
        weights = 27 * cin * c * BF16
        forms[f"gband_conv_s1.{site}"] = _form(_conv(cin, c, 27, n), n * (cin + c) * BF16 + weights)
        forms[f"gband_conv_s1_input_grad.{site}"] = _form(_conv(c, cin, 27, n), n * (cin + c) * BF16 + weights)
    return forms
