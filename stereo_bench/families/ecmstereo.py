"""ECMStereo: the program's ``ECMStereo`` model, its seeded weights, the plain
reference ``reference/ecm.py`` and the counts of ``counts.py``, at the
configuration file's sizes (``shapes``: ``max_disp``, ``feature_channels``;
``dtype``), so that the model, the counts and the reference take one set of
sizes. The family's contract: ``families/__init__.py``.

Weights: :func:`weights.make_weights`; then, for serving, on a seeded
:func:`calibration_pair` of the served size, every running statistic is
set by :func:`calibrate_bn_stats` and the last head scaled by
:func:`normalise_head`. Random weights with random statistics give
networks of very different gain and conditioning from seed to seed: a cost
map of 1e7 makes the soft-argmin a hard argmax that any rounding flips, and
a seed whose activations sit far off their scale reads bfloat16's rounding
several times larger than the others; standardised layers and a head of one
scale give every seed work of one difficulty.
"""

from __future__ import annotations

import torch

from stereo_bench import counts
from stereo_bench import weights as W
from stereo_bench.reference import ecm as R

HEAD = "aggregation.classif3.conv2"  # the eval path's last head's final convolution
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
EXACT, FP8, RUNNING = R.EXACT, R.FP8, R.RUNNING
# the program's kernels (csrc/*.cu), by symbol: the conv core's
# instantiations (every conv3d_bn and gband_conv_s1 form, deconv3d_bn), the
# CUDA-core routes, the fused pair, the cost volumes and the regression
KERNELS = (
    "conv3d_wgmma_kernel", "conv3d_bn_kernel", "fused_pair_wgmma_kernel", "fused_pair_kernel",
    "concat_kernel", "correlation_kernel", "upsample_softargmin_kernel",
)


def build(cfg: dict, device: torch.device):
    """The program's model of configuration ``cfg`` with uninitialised
    storage on ``device`` (in eval mode): the preset with the file's
    ``overrides``, and the file's disparity range, width and dtype."""
    from ecm_torch.configs.base import CONFIGS

    model_cfg = CONFIGS[cfg["preset"]].model
    sizes = {"max_disp": cfg["shapes"]["max_disp"], "feature_channels": cfg["shapes"]["feature_channels"],
             "dtype": DTYPES[cfg["dtype"]]}
    with torch.device("meta"):
        model = model_cfg.build(device="meta", generator=torch.Generator(), **cfg.get("overrides", {}), **sizes)
    return model.to_empty(device=device).eval()


def check_sizes(model, cfg: dict) -> None:
    """The model is built at the file's disparity range, width and dtype."""
    shapes = cfg["shapes"]
    assert model.max_disp == shapes["max_disp"]
    c = shapes["feature_channels"]
    assert model.state_dict()["aggregation.dres0_1.conv.weight"].shape[:2] == (c, 2 * c)
    assert model.feature.dtype == DTYPES[cfg["dtype"]]  # the compute dtype; parameters stay float32


def calibration_pair(cfg: dict, seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    """A seeded pair of the configuration's height and width, with a
    disparity field in the weights group's ``calibration_disparity``, as the
    served pairs have (a smaller pair's cost volume is mostly the zeros
    beyond its left edge, and does not read the network as the served size
    does); no served request is this pair."""
    from stereo_bench import synth

    h, w = cfg["shapes"]["height"], cfg["shapes"]["width"]
    lo, hi = cfg["weights"]["calibration_disparity"]
    return synth.make_pairs(torch.Generator(device=device).manual_seed(seed + 2), 1, h, w, lo, hi, device)


@torch.no_grad()
def calibrate_bn_stats(params: dict[str, torch.Tensor], cfg: dict, pair: dict) -> None:
    """Set every BatchNorm's running mean and variance to its batch
    statistics in the reference's train-mode forward of ``pair`` (the
    mean of the siamese feature net's two calls), so that at eval each
    layer's input is standardised before its scale and shift on every
    seed: random statistics leave some seeds' activations far off their
    scale, a network on which bfloat16's rounding weighs several times
    more than on the others."""
    net = R.Net(params, cfg["shapes"]["max_disp"], train=True)
    with R.strict_f32():
        net.cost_maps(pair["left"], pair["right"])
    seen: dict[str, list] = {}
    for name, mean, var in net.stats:
        seen.setdefault(name, []).append((mean, var))
    for name, calls in seen.items():
        params[f"{name}.running_mean"].copy_(torch.stack([m for m, _ in calls]).mean(0))
        params[f"{name}.running_var"].copy_(torch.stack([v for _, v in calls]).mean(0))


@torch.no_grad()
def normalise_head(params: dict[str, torch.Tensor], cfg: dict, pair: dict) -> float:
    """Scale the last head's final convolution (weight and bias) so that the
    reference's eval cost map of ``pair`` has the configuration's
    ``head_cost_std`` (its standard deviation over the disparities, averaged
    over pixels); returns the scale. At eval the residual stacks' gain
    varies from seed to seed, and with it how sharp the soft-argmin is."""
    with R.strict_f32():
        cost = R.Net(params, cfg["shapes"]["max_disp"], train=False).cost_maps(pair["left"], pair["right"])[-1]
    scale = cfg["weights"]["head_cost_std"] / cost.std(1).mean().item()
    for name in (f"{HEAD}.weight", f"{HEAD}.bias"):
        params[name].mul_(scale)
    return scale


def seeded_weights(cfg: dict, template: dict[str, torch.Tensor], seed: int, device: torch.device) -> dict:
    """The configuration's weights from ``seed`` (:func:`weights.make_weights`;
    then, where the weights group names a ``calibration_disparity``, on a
    :func:`calibration_pair`: :func:`calibrate_bn_stats` where it sets
    ``bn_stats_from_calibration``, and :func:`normalise_head` where it names
    a ``head_cost_std``)."""
    params = W.make_weights(template, cfg["weights"], seed, device)
    spec = cfg["weights"]
    if "calibration_disparity" in spec:
        pair = calibration_pair(cfg, seed, device)
        if spec.get("bn_stats_from_calibration"):
            calibrate_bn_stats(params, cfg, pair)
        if "head_cost_std" in spec:
            normalise_head(params, cfg, pair)
    return params


def infer(params: dict, cfg: dict, left: torch.Tensor, right: torch.Tensor, precision) -> torch.Tensor:
    return R.infer(params, cfg["shapes"]["max_disp"], left, right, precision)


def train_steps(params: dict, names: list[str], cfg: dict, batches: list[dict], precision) -> dict:
    return R.train_steps(params, names, cfg["shapes"]["max_disp"], cfg["train"]["lr"], batches, precision)


def _sizes(cfg: dict) -> tuple[int, int, int, int]:
    s = cfg["shapes"]
    return s["height"], s["width"], s["max_disp"], s["feature_channels"]


def eval_work(cfg: dict, batch: int) -> dict:
    forms = counts.eval_forms(batch, *_sizes(cfg))
    return {"flops": batch * counts.eval_flops(*_sizes(cfg)),
            "port_bound_s": sum(counts.bound_s(f) for f in forms.values())}


def train_work(cfg: dict) -> dict:
    shape = cfg["shapes"]["batch"], *_sizes(cfg)
    return {"flops": counts.train_flops(*shape),
            "port_bound_s": sum(counts.bound_s(f) for f in counts.train_forms(*shape).values())}
