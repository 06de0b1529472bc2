"""IGEVStereo: the program's ``IGEVStereo`` model (serving only), its seeded
weights, the plain reference ``reference/igevstereo.py`` and the count of
its work, at the configuration file's sizes (``shapes``: ``height``,
``width``, ``max_disp``, ``hidden_dims``, ``n_gru_layers``,
``n_downsample``, ``corr_levels``, ``corr_radius``, ``valid_iters``,
``groups``, ``descriptor_dim``, ``volume_channels``; ``dtype``). The
family's contract: ``families/__init__.py``; there are no training entries.

Weights, RAFT-Stereo's recipe (``families/raftstereo.py``) over IGEV's
modules: :func:`weights.make_weights`, whose He-normal draw takes a
transposed convolution's fan-out from its name (``.deconv.weight``), which
IGEV's do not have, so each transposed weight is rescaled to its true
fan-out; every BatchNorm scale (2-D and 3-D: MobileNetV2, ``cnet``, the
hourglass and its excitations, ``spx_2_gru``) drawn again in the weights
group's ``bn_scale`` and its shift in ``bn_shift``, a norm registered twice
(``norm3`` and ``downsample.1``) one set of values (:func:`draw_bn_scales`):
shifts of a few units keep the normalised units in their activations'
linear ranges, where a random network with shifts around 0 is chaotic and a
float16 rounding grows to pixels. Then, on a
seeded :func:`calibration_pair` of the served size, every running statistic
is set to its batch statistics in the reference's train-mode forward of one
iteration (:func:`calibrate_bn_stats`), the classifier is scaled so that the
reference's initial disparity has the group's spatial standard deviation
``init_std`` (:func:`normalise_classifier`: a rounding of the logits moves
the soft-argmin in proportion to that spread, which random classifiers give
from a fraction of a plane to several), the disparity head's last
convolution so that the first update has the root mean square
``delta_std``, and the upsampling's last convolution so that its logits
over the 9 neighbours have the per-pixel standard deviation ``mask_std``
(:func:`normalise_heads`: each full-resolution pixel a convex combination,
not a choice that a rounding flips).
"""

from __future__ import annotations

import math

import torch

from stereo_bench import counts
from stereo_bench import weights as W
from stereo_bench.families.raftstereo import DTYPES, calibration_pair
from stereo_bench.reference import igevstereo as R

DISP_HEAD = "update_block.disp_head.conv2"
UPSAMPLING = "spx_gru.0"
CLASSIFIER = "classifier"
BISECTIONS = 48  # of the classifier's scale over 1e-4 .. 1e4: a relative step of ~1e-13
# the transposed convolutions' weights ([Cin, Cout, k, k(, k)])
TRANSPOSED = (".deconv32_16.conv1.", ".deconv16_8.conv1.", ".deconv8_4.conv1.", "_up.conv.", "spx_2_gru.conv1.",
              "spx_gru.0.")
EXACT, FP8 = R.EXACT, R.FP8
# the program's kernels on this family's path (csrc/geo_lookup.cu, csrc/cost_volume.cu)
KERNELS = ("geo_lookup_kernel", "correlation_kernel")


def build(cfg: dict, device: torch.device):
    """The program's model of configuration ``cfg`` with uninitialised
    storage on ``device`` (in eval mode), at the file's sizes and dtype."""
    from ecm_torch.models import build_model

    s = cfg["shapes"]
    sizes = {"max_disp": s["max_disp"], "hidden_dims": tuple(s["hidden_dims"]), "corr_levels": s["corr_levels"],
             "corr_radius": s["corr_radius"], "n_downsample": s["n_downsample"], "iters": s["valid_iters"],
             "dtype": DTYPES[cfg["dtype"]]}
    with torch.device("meta"):
        model = build_model("igev_stereo", device="meta", generator=torch.Generator(), **sizes)
    return model.to_empty(device=device).eval()


def check_sizes(model, cfg: dict) -> None:
    """The model is built at the file's widths, disparities, levels, radius,
    iterations and dtype."""
    s = cfg["shapes"]
    sd = model.state_dict()
    assert len(s["hidden_dims"]) == s["n_gru_layers"] == 3 and s["n_downsample"] == 2
    assert [sd[f"update_block.gru{k}.convz.weight"].shape[0] for k in ("16", "08", "04")] == s["hidden_dims"]
    assert sd["desc.weight"].shape[:2] == (s["descriptor_dim"], s["descriptor_dim"])
    assert sd["corr_stem.conv.weight"].shape[:2] == (s["groups"], s["groups"])
    assert sd["cost_agg.conv1_up.conv.weight"].shape[1] == sd["classifier.weight"].shape[1] == s["volume_channels"]
    taps = s["corr_levels"] * (2 * s["corr_radius"] + 1)
    assert sd["update_block.encoder.convc1.weight"].shape[1] == taps * (s["volume_channels"] + 1)
    assert (model.max_disp, model.iters, model.corr_levels, model.corr_radius) == (
        s["max_disp"], s["valid_iters"], s["corr_levels"], s["corr_radius"])
    assert model.dtype == DTYPES[cfg["dtype"]]


def _net(params: dict, cfg: dict, iters: int, train: bool = False, precision=EXACT) -> R.Net:
    s = cfg["shapes"]
    return R.Net(params, iters, s["max_disp"], s["corr_levels"], s["corr_radius"], train, precision)


@torch.no_grad()
def fix_transposed_fan_out(params: dict[str, torch.Tensor]) -> None:
    """He-normal over a transposed convolution's fan-out (``Cout k^n``, its
    weight's dim 1), where :func:`weights.make_weights` took dim 0."""
    for k, t in params.items():
        if k.endswith(".weight") and t.ndim >= 4 and any(m in f".{k}" for m in TRANSPOSED):
            t.mul_(math.sqrt(t.shape[0] / t.shape[1]))


def _bn_scales(params: dict[str, torch.Tensor]) -> list[str]:
    return [k for k in params if k.endswith(".weight") and f"{k[:-len('weight')]}running_mean" in params]


@torch.no_grad()
def draw_bn_scales(params: dict[str, torch.Tensor], spec: dict, seed: int) -> None:
    """Every BatchNorm scale uniform in ``bn_scale`` and shift uniform in
    ``bn_shift`` (one draw each from ``seed``), and each ``norm3.*`` equal to
    its ``downsample.1.*``, the same module under two names."""
    names = _bn_scales(params)
    lo, hi = spec["bn_scale"]
    device = params[names[0]].device
    u = torch.rand(sum(params[k].numel() for k in names), generator=torch.Generator(device=device).manual_seed(seed + 1),
                   device=device)
    for k, part in zip(names, u.split([params[k].numel() for k in names])):
        params[k] = part.view_as(params[k]).mul_(hi - lo).add_(lo)
    lo, hi = spec["bn_shift"]
    shifts = [f"{k[:-len('weight')]}bias" for k in names]
    u = torch.rand(sum(params[k].numel() for k in shifts),
                   generator=torch.Generator(device=device).manual_seed(seed + 3), device=device)
    for k, part in zip(shifts, u.split([params[k].numel() for k in shifts])):
        params[k] = part.view_as(params[k]).mul_(hi - lo).add_(lo)
    for k in list(params):
        if ".norm3." in k:
            params[k] = params[k.replace(".norm3.", ".downsample.1.")].clone()


@torch.no_grad()
def calibrate_bn_stats(params: dict[str, torch.Tensor], cfg: dict, pair: dict) -> None:
    """Set every BatchNorm's running mean and variance (both names of a
    norm registered twice) to its batch statistics in the reference's
    train-mode forward of ``pair`` with one iteration."""
    net = _net(params, cfg, 1, train=True)
    with R.strict_f32():
        net.forward(pair["left"], pair["right"])
    for name, mean, var in net.stats:
        for alias in {name, name.replace(".downsample.1", ".norm3")}:
            params[f"{alias}.running_mean"].copy_(mean)
            params[f"{alias}.running_var"].copy_(var)


@torch.no_grad()
def normalise_classifier(params: dict[str, torch.Tensor], cfg: dict, pair: dict) -> float:
    """Scale the classifier (bias-free, so its logits scale with it) so that
    the reference's initial disparity on ``pair`` has a spatial standard
    deviation of the weights group's ``init_std`` planes (bisection over the
    scale, the GEV computed once); returns the scale."""
    net = _net(params, cfg, 0)
    with R.strict_f32():
        img1, img2 = net.image(pair["left"]), net.image(pair["right"])
        feats, match_l, match_r, _ = net.features(img1, img2)
        _, logits, _ = net.geometry(feats, match_l, match_r)
        planes = torch.arange(logits.shape[1], dtype=torch.float32, device=logits.device).view(1, -1, 1, 1)
        spread = lambda s: (torch.softmax(s * logits, 1) * planes).sum(1).std().item()  # noqa: E731
        lo, hi = 1e-4, 1e4
        for _ in range(BISECTIONS):
            mid = math.sqrt(lo * hi)
            lo, hi = (mid, hi) if spread(mid) < cfg["weights"]["init_std"] else (lo, mid)
    scale = math.sqrt(lo * hi)
    params[f"{CLASSIFIER}.weight"].mul_(scale)
    return scale


@torch.no_grad()
def normalise_heads(params: dict[str, torch.Tensor], cfg: dict, pair: dict) -> tuple[float, float]:
    """Scale the disparity head's last convolution (weight and bias) so that
    the reference's first update on ``pair`` has a root mean square of the
    weights group's ``delta_std`` (its mean included: a mean update drifts
    every pixel the same way each iteration), and the upsampling's last (transposed) convolution so that
    its logits over the 9 neighbours have a mean per-pixel standard deviation
    of ``mask_std``; returns both scales. Neither head feeds the other's
    input in a forward of one iteration."""
    with R.strict_f32():
        out = _net(params, cfg, 1).forward(pair["left"], pair["right"])
    scales = (cfg["weights"]["delta_std"] / out["deltas"][0].square().mean().sqrt().item(),
              cfg["weights"]["mask_std"] / out["upsampling_logits"].std(1).mean().item())
    for head, scale in zip((DISP_HEAD, UPSAMPLING), scales):
        for name in (f"{head}.weight", f"{head}.bias"):
            params[name].mul_(scale)
    return scales


def seeded_weights(cfg: dict, template: dict[str, torch.Tensor], seed: int, device: torch.device) -> dict:
    """The configuration's weights from ``seed``: :func:`weights.make_weights`,
    :func:`fix_transposed_fan_out`, :func:`draw_bn_scales`, then on a
    :func:`calibration_pair` :func:`calibrate_bn_stats`,
    :func:`normalise_classifier` and :func:`normalise_heads`."""
    spec = cfg["weights"]
    params = W.make_weights(template, spec, seed, device)
    fix_transposed_fan_out(params)
    draw_bn_scales(params, spec, seed)
    pair = calibration_pair(cfg, seed, device)
    calibrate_bn_stats(params, cfg, pair)
    normalise_classifier(params, cfg, pair)
    normalise_heads(params, cfg, pair)
    return params


def infer(params: dict, cfg: dict, left: torch.Tensor, right: torch.Tensor, precision) -> torch.Tensor:
    s = cfg["shapes"]
    return R.infer(params, s["valid_iters"], left, right, precision, s["max_disp"], s["corr_levels"],
                   s["corr_radius"])


# -- the work of a request ---------------------------------------------------

def _conv(cin: int, cout: int, taps: int, points: int) -> float:
    """A convolution's FLOPs: ``points`` output (input, for a transposed one)
    positions, ``taps`` a kernel, ``cin`` a group."""
    return 2.0 * cin * cout * taps * points


def _mobilenet(h: int, w: int) -> tuple[float, list[tuple[int, int, int]]]:
    """FLOPs of the stem and the six stages on one image, and each of the
    1/2 .. 1/32 outputs' (channels, height, width)."""
    h, w = -(-h // 2), -(-w // 2)
    total, cin, outs = _conv(3, 32, 9, h * w), 32, []
    for i, (blocks, cout, stride) in enumerate(R.STAGES):
        for k in range(blocks):
            s = stride if k == 0 else 1
            mid = cin if i == 0 else 6 * cin  # stage 0: depthwise-separable; then expansion 6
            if mid != cin:
                total += _conv(cin, mid, 1, h * w)
            h, w = -(-h // s), -(-w // s)
            total += _conv(1, mid, 9, h * w) + _conv(mid, cout, 1, h * w)
            cin = cout
        outs.append((cout, h, w))
    return total, outs


def eval_flops(cfg: dict) -> float:
    """FLOPs of one pair's eval forward: every convolution (2 a multiply-add,
    at its kernel's taps, a group's input channels, a transposed one at its
    input positions) and the all-pairs correlation's matmul; the volume, the
    lookups, norms, gates, pools, resizes, the regression and the
    upsampling's sums are not counted (as ``counts.py``)."""
    s = cfg["shapes"]
    h, w, hid, g = s["height"], s["width"], s["hidden_dims"], s["volume_channels"]
    trunk, outs = _mobilenet(h, w)
    (_, h2, w2), (c4, h4, w4), (c8, h8, w8), (c16, h16, w16), (c32, h32, w32) = [outs[0], outs[1], outs[2],
                                                                                  outs[4], outs[5]]
    n2, n4, n8, n16, n32 = h2 * w2, h4 * w4, h8 * w8, h16 * w16, h32 * w32
    decoder = (_conv(c32, 96, 16, n32) + _conv(192, 192, 9, n16) + _conv(192, 32, 16, n16)
               + _conv(64, 64, 9, n8) + _conv(64, 24, 16, n8) + _conv(48, 48, 9, n4) + _conv(48, 48, 9, n4))
    stems = _conv(3, 32, 9, n2) + _conv(32, 32, 9, n2) + _conv(32, 48, 9, n4) + _conv(48, 48, 9, n4)
    dd = s["descriptor_dim"]
    match = _conv(dd, dd, 9, n4) + _conv(dd, dd, 1, n4)
    per_image = trunk + decoder + stems + match
    # the 3-D stage over D/4 x H/4 x W/4 and its halvings
    v = (s["max_disp"] // 4) * n4
    att = lambda cv, feat, n: _conv(feat, feat // 2, 1, n) + _conv(feat // 2, cv, 1, n)  # noqa: E731
    geometry = (_conv(g, g, 27, v) + att(g, 96, n4)
                + _conv(g, 2 * g, 27, v // 8) + _conv(2 * g, 2 * g, 27, v // 8) + att(2 * g, 64, n8)
                + _conv(2 * g, 4 * g, 27, v // 64) + _conv(4 * g, 4 * g, 27, v // 64) + att(4 * g, 192, n16)
                + _conv(4 * g, 6 * g, 27, v // 512) + _conv(6 * g, 6 * g, 27, v // 512) + att(6 * g, 160, n32)
                + _conv(6 * g, 4 * g, 64, v // 512) + _conv(8 * g, 4 * g, 1, v // 64)
                + 2 * _conv(4 * g, 4 * g, 27, v // 64) + att(4 * g, 192, n16)
                + _conv(4 * g, 2 * g, 64, v // 64) + _conv(4 * g, 2 * g, 1, v // 8)
                + 2 * _conv(2 * g, 2 * g, 27, v // 8) + att(2 * g, 64, n8)
                + _conv(2 * g, g, 64, v // 8) + _conv(g, 1, 27, v))
    # cnet: RAFT-Stereo's, at n_downsample 2
    n1 = h * w
    cnet = _conv(3, 64, 49, n1)
    block = lambda cin, cout, n, short: _conv(cin, cout, 9, n) + _conv(cout, cout, 9, n) + (  # noqa: E731
        _conv(cin, cout, 1, n) if short else 0.0)
    cnet += 2 * block(64, 64, n1, False)
    cnet += block(64, 96, n2, True) + block(96, 96, n2, False)
    cnet += block(96, 128, n4, True) + block(128, 128, n4, False)
    cnet += block(128, 128, n8, True) + block(128, 128, n8, False)
    cnet += block(128, 128, n16, True) + block(128, 128, n16, False)
    cnet += 2 * (block(128, 128, n4, False) + _conv(128, hid[2], 9, n4))
    cnet += 2 * (block(128, 128, n8, False) + _conv(128, hid[1], 9, n8))
    cnet += 2 * _conv(128, hid[0], 9, n16)
    zqr = _conv(hid[2], 3 * hid[2], 9, n4) + _conv(hid[1], 3 * hid[1], 9, n8) + _conv(hid[0], 3 * hid[0], 9, n16)
    corr = 2.0 * dd * h4 * w4 * w4
    lookup = s["corr_levels"] * (2 * s["corr_radius"] + 1) * (g + 1)
    gru = lambda hidden, inputs, n: 3 * _conv(hidden + inputs, hidden, 9, n)  # noqa: E731
    update = (gru(hid[0], hid[1], n16) + gru(hid[1], hid[0] + hid[2], n8) + gru(hid[2], 128 + hid[1], n4)
              + _conv(lookup, 64, 1, n4) + _conv(64, 64, 9, n4) + _conv(1, 64, 49, n4) + _conv(64, 64, 9, n4)
              + _conv(128, 127, 9, n4) + _conv(hid[2], 256, 9, n4) + _conv(256, 1, 9, n4)
              + _conv(hid[2], 32, 9, n4))
    upsample = _conv(32, 32, 16, n4) + _conv(64, 64, 9, n2) + _conv(64, 9, 16, n2)
    return 2 * per_image + geometry + cnet + zqr + corr + s["valid_iters"] * update + upsample


def lookup_form(cfg: dict, batch: int) -> dict:
    """One lookup's bytes at the dtypes the kernel reads and writes: each
    pixel's float32 disparity; of each level, the float32 window of
    2r + 2 planes of each geometry channel and of the correlation row that
    its taps read (at clamped addresses, whatever the disparity); and its
    ``levels x (C + 1) x (2r + 1)`` outputs in the configuration's dtype."""
    s = cfg["shapes"]
    pixels = batch * (s["height"] // 4) * (s["width"] // 4)
    out = 2 if DTYPES[cfg["dtype"]] != torch.float32 else 4
    levels, r, rows = s["corr_levels"], s["corr_radius"], s["volume_channels"] + 1
    moved = pixels * (4 + levels * rows * (2 * r + 2) * 4 + levels * rows * (2 * r + 1) * out)
    return {"ops": 0.0, "bytes": float(moved), "exps": 0.0}


def volume_form(cfg: dict, batch: int) -> dict:
    """The group-wise volume's bytes: both descriptor maps read once, the
    ``[B, D/4, H/4, W/4, G]`` volume written once, in the configuration's
    dtype; and its multiply-adds (2 FLOPs each, columns ``w >= d`` only)."""
    s = cfg["shapes"]
    e = 2 if DTYPES[cfg["dtype"]] != torch.float32 else 4
    h4, w4, d4 = s["height"] // 4, s["width"] // 4, s["max_disp"] // 4
    pixels = batch * h4 * w4
    ops = 2.0 * batch * h4 * s["descriptor_dim"] * sum(max(w4 - d, 0) for d in range(d4))
    return {"ops": ops, "bytes": float(pixels * (2 * s["descriptor_dim"] + d4 * s["groups"]) * e), "exps": 0.0}


def eval_work(cfg: dict, batch: int) -> dict:
    lookups = cfg["shapes"]["valid_iters"] * counts.bound_s(lookup_form(cfg, batch))
    return {"flops": batch * eval_flops(cfg), "port_bound_s": lookups + counts.bound_s(volume_form(cfg, batch)),
            "lookup_bound_s": lookups}
