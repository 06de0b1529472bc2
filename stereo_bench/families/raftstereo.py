"""RAFTStereo: the program's ``RAFTStereo`` model (serving only), its seeded
weights, the plain reference ``reference/raftstereo.py`` and the count of
its work, at the configuration file's sizes (``shapes``: ``hidden_dims``,
``n_gru_layers``, ``n_downsample``, ``corr_levels``, ``corr_radius``,
``valid_iters``, ``fnet_dim``; ``dtype``). The family's contract:
``families/__init__.py``; there are no training entries.

Weights: :func:`weights.make_weights`, whose BatchNorm scales are told by
the suffix ``bn.weight``, which the published names (``norm1.weight``) do
not have: so every ``cnet`` norm's scale is drawn again in the weights
group's ``bn_scale`` (:func:`draw_bn_scales`), and a norm registered twice
(``norm3`` and ``downsample.1``) gets one set of values. Then, on a seeded
:func:`calibration_pair` of the served size, every ``cnet`` BatchNorm's
running statistics are set to its batch statistics in the reference's
train-mode forward (:func:`calibrate_bn_stats`), and the flow head's last
convolution is scaled so that the reference's first update of the x flow
has the group's standard deviation ``delta_std`` (:func:`normalise_flow_head`):
random heads give updates of very different size from seed to seed, from
an iteration that barely moves to one that runs away in 32 steps.
"""

from __future__ import annotations

import torch

from stereo_bench import counts
from stereo_bench import weights as W
from stereo_bench.reference import raftstereo as R

FLOW_HEAD = "update_block.flow_head.conv2"
DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16, "float32": torch.float32}
EXACT, FP8 = R.EXACT, R.FP8
# the program's kernel on this family's path (csrc/corr1d.cu)
KERNELS = ("corr1d_lookup_kernel",)


def build(cfg: dict, device: torch.device):
    """The program's model of configuration ``cfg`` with uninitialised
    storage on ``device`` (in eval mode), at the file's sizes and dtype."""
    from ecm_torch.models import build_model

    s = cfg["shapes"]
    sizes = {"hidden_dims": tuple(s["hidden_dims"]), "corr_levels": s["corr_levels"],
             "corr_radius": s["corr_radius"], "n_downsample": s["n_downsample"], "iters": s["valid_iters"],
             "dtype": DTYPES[cfg["dtype"]]}
    with torch.device("meta"):
        model = build_model("raft_stereo", device="meta", generator=torch.Generator(), **sizes)
    return model.to_empty(device=device).eval()


def check_sizes(model, cfg: dict) -> None:
    """The model is built at the file's widths, levels, radius, iterations
    and dtype."""
    s = cfg["shapes"]
    sd = model.state_dict()
    assert len(s["hidden_dims"]) == s["n_gru_layers"] == 3
    assert [sd[f"update_block.gru{k}.convz.weight"].shape[0] for k in ("32", "16", "08")] == s["hidden_dims"]
    assert sd["fnet.conv2.weight"].shape[0] == s["fnet_dim"]
    assert sd["update_block.encoder.convc1.weight"].shape[1] == s["corr_levels"] * (2 * s["corr_radius"] + 1)
    assert sd["update_block.mask.2.weight"].shape[0] == 9 * 4 ** s["n_downsample"]
    assert (model.iters, model.corr_levels, model.corr_radius) == (s["valid_iters"], s["corr_levels"], s["corr_radius"])
    assert model.dtype == DTYPES[cfg["dtype"]]


def _net(params: dict, cfg: dict, iters: int, train: bool = False, precision=EXACT) -> R.Net:
    s = cfg["shapes"]
    return R.Net(params, iters, s["corr_levels"], s["corr_radius"], s["n_downsample"], train, precision)


def calibration_pair(cfg: dict, seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    """A seeded pair of the configuration's height and width, with a
    disparity field in the weights group's ``calibration_disparity``; no
    served request is this pair."""
    from stereo_bench import synth

    h, w = cfg["shapes"]["height"], cfg["shapes"]["width"]
    lo, hi = cfg["weights"]["calibration_disparity"]
    return synth.make_pairs(torch.Generator(device=device).manual_seed(seed + 2), 1, h, w, lo, hi, device)


@torch.no_grad()
def draw_bn_scales(params: dict[str, torch.Tensor], spec: dict, seed: int) -> None:
    """Every ``cnet`` BatchNorm scale uniform in ``bn_scale`` (one draw from
    ``seed``), and each ``norm3.*`` equal to its ``downsample.1.*``, the
    same module under two names."""
    names = [k for k in params if k.startswith("cnet.") and k.endswith(".weight") and params[k].ndim == 1]
    if names:
        lo, hi = spec["bn_scale"]
        gen = torch.Generator(device=params[names[0]].device).manual_seed(seed + 1)
        u = torch.rand(sum(params[k].numel() for k in names), generator=gen, device=params[names[0]].device)
        for k, part in zip(names, u.split([params[k].numel() for k in names])):
            params[k] = part.view_as(params[k]).mul_(hi - lo).add_(lo)
    for k in list(params):
        if ".norm3." in k:
            params[k] = params[k.replace(".norm3.", ".downsample.1.")].clone()


@torch.no_grad()
def calibrate_bn_stats(params: dict[str, torch.Tensor], cfg: dict, pair: dict) -> None:
    """Set every ``cnet`` BatchNorm's running mean and variance (both names
    of a norm registered twice) to its batch statistics in the reference's
    train-mode forward of ``pair``'s left image."""
    net = _net(params, cfg, 0, train=True)
    with R.strict_f32():
        net.context(net.image(pair["left"]))
    for name, mean, var in net.stats:
        for alias in {name, name.replace(".downsample.1", ".norm3")}:
            params[f"{alias}.running_mean"].copy_(mean)
            params[f"{alias}.running_var"].copy_(var)


@torch.no_grad()
def normalise_flow_head(params: dict[str, torch.Tensor], cfg: dict, pair: dict) -> float:
    """Scale the flow head's last convolution (weight and bias) so that the
    reference's first update of the x flow on ``pair`` has the weights
    group's ``delta_std``; returns the scale."""
    with R.strict_f32():
        delta = _net(params, cfg, 1).forward(pair["left"], pair["right"])["deltas"][0]
    scale = cfg["weights"]["delta_std"] / delta.std().item()
    for name in (f"{FLOW_HEAD}.weight", f"{FLOW_HEAD}.bias"):
        params[name].mul_(scale)
    return scale


def seeded_weights(cfg: dict, template: dict[str, torch.Tensor], seed: int, device: torch.device) -> dict:
    """The configuration's weights from ``seed``: :func:`weights.make_weights`,
    :func:`draw_bn_scales`, then on a :func:`calibration_pair`
    :func:`calibrate_bn_stats` and :func:`normalise_flow_head`."""
    spec = cfg["weights"]
    params = W.make_weights(template, spec, seed, device)
    draw_bn_scales(params, spec, seed)
    pair = calibration_pair(cfg, seed, device)
    calibrate_bn_stats(params, cfg, pair)
    normalise_flow_head(params, cfg, pair)
    return params


def infer(params: dict, cfg: dict, left: torch.Tensor, right: torch.Tensor, precision) -> torch.Tensor:
    s = cfg["shapes"]
    return R.infer(params, s["valid_iters"], left, right, precision, s["corr_levels"], s["corr_radius"],
                   s["n_downsample"])


# -- the work of a request ---------------------------------------------------

def _conv(cin: int, cout: int, k: int, pixels: int) -> float:
    return 2.0 * cin * cout * k * k * pixels


def _trunk(h: int, w: int, ds: int) -> tuple[float, int, int]:
    """FLOPs of the 7x7 stem and layer1-layer3 on one image, and the output's
    height and width."""
    total, c = 0.0, 64
    s = 1 + (ds > 2)
    h, w = -(-h // s), -(-w // s)
    total += _conv(3, 64, 7, h * w)
    for cout, stride in ((64, 1), (96, 1 + (ds > 1)), (128, 1 + (ds > 0))):
        f, h, w = _layer(c, cout, stride, h, w)
        total, c = total + f, cout
    return total, h, w


def _block(cin: int, cout: int, stride: int, h: int, w: int) -> tuple[float, int, int]:
    h, w = -(-h // stride), -(-w // stride)
    f = _conv(cin, cout, 3, h * w) + _conv(cout, cout, 3, h * w)
    if stride != 1 or cin != cout:
        f += _conv(cin, cout, 1, h * w)
    return f, h, w


def _layer(cin: int, cout: int, stride: int, h: int, w: int) -> tuple[float, int, int]:
    f1, h, w = _block(cin, cout, stride, h, w)
    f2, h, w = _block(cout, cout, 1, h, w)
    return f1 + f2, h, w


def eval_flops(cfg: dict) -> float:
    """FLOPs of one pair's eval forward: every convolution (2 a multiply-add,
    at k x k taps) and the correlation's matmul; the lookups, norms, gates,
    pools, resizes and the upsampling are not counted (as ``counts.py``)."""
    s = cfg["shapes"]
    h, w, ds, hid, fdim = s["height"], s["width"], s["n_downsample"], s["hidden_dims"], s["fnet_dim"]
    trunk, h4, w4 = _trunk(h, w, ds)
    n4 = h4 * w4
    fnet = 2 * (trunk + _conv(128, fdim, 1, n4))
    f4, h8, w8 = _layer(128, 128, 2, h4, w4)
    f5, h16, w16 = _layer(128, 128, 2, h8, w8)
    n8, n16 = h8 * w8, h16 * w16
    heads = 2 * (_block(128, 128, 1, h4, w4)[0] + _conv(128, hid[2], 3, n4))
    heads += 2 * (_block(128, 128, 1, h8, w8)[0] + _conv(128, hid[1], 3, n8))
    heads += _conv(128, hid[0], 3, n16) + _conv(128, hid[0], 3, n16)
    cnet = trunk + f4 + f5 + heads
    zqr = _conv(hid[2], 3 * hid[2], 3, n4) + _conv(hid[1], 3 * hid[1], 3, n8) + _conv(hid[0], 3 * hid[0], 3, n16)
    corr = 2.0 * fdim * h4 * w4 * w4
    taps = s["corr_levels"] * (2 * s["corr_radius"] + 1)
    gru = lambda hidden, inputs, n: 3 * _conv(hidden + inputs, hidden, 3, n)  # noqa: E731
    update = (gru(hid[0], hid[1], n16) + gru(hid[1], hid[0] + hid[2], n8) + gru(hid[2], 128 + hid[1], n4)
              + _conv(taps, 64, 1, n4) + _conv(64, 64, 3, n4) + _conv(2, 64, 7, n4) + _conv(64, 64, 3, n4)
              + _conv(128, 126, 3, n4)
              + _conv(hid[2], 256, 3, n4) + _conv(256, 2, 3, n4)
              + _conv(hid[2], 256, 3, n4) + _conv(256, 9 * 4**ds, 1, n4))
    return fnet + cnet + zqr + corr + s["valid_iters"] * update


def lookup_form(cfg: dict, batch: int) -> dict:
    """One lookup's bytes at the dtypes the kernel reads and writes: each
    pixel's float32 x coordinate, the float32 window of 2r + 2 neighbours
    it reads of each level (at clamped addresses, whatever the coordinate),
    and its ``levels x (2r + 1)`` outputs in the configuration's dtype."""
    s = cfg["shapes"]
    ds = 2 ** s["n_downsample"]
    pixels = batch * (-(-s["height"] // ds)) * (-(-s["width"] // ds))
    out = 2 if DTYPES[cfg["dtype"]] != torch.float32 else 4
    levels, r = s["corr_levels"], s["corr_radius"]
    moved = pixels * (4 + levels * (2 * r + 2) * 4 + levels * (2 * r + 1) * out)
    return {"ops": 0.0, "bytes": float(moved), "exps": 0.0}


def eval_work(cfg: dict, batch: int) -> dict:
    return {"flops": batch * eval_flops(cfg),
            "port_bound_s": cfg["shapes"]["valid_iters"] * counts.bound_s(lookup_form(cfg, batch))}
