"""Seeded weights and the program's model built on them.

The benchmark makes every parameter and BatchNorm statistic itself, on the
device, from ``--seed`` (a ``torch.Generator`` on the card, one draw for all
convolution weights and one for the rest), and loads them into the program's
model with ``load_state_dict``; the reference reads the same tensors. The
names and shapes come from the program's module tree, built on the ``meta``
device (no host work, no initialisation).

The distribution (the configuration's ``weights`` group): convolution
weights He-normal over fan-out, clamped at two standard deviations, as the
program initialises them; BatchNorm scales uniform in ``bn_scale``, shifts,
biases and running means normal with standard deviation ``shift_std``,
running variances uniform in ``running_var``. For serving, on a seeded
:func:`calibration_pair` of the served size, every running statistic is
then set by :func:`calibrate_bn_stats` and the last head scaled by
:func:`normalise_head`. Random weights with random statistics give
networks of very different gain and conditioning from seed to seed: a cost
map of 1e7 makes the soft-argmin a hard argmax that any rounding flips, and
a seed whose activations sit far off their scale reads bfloat16's rounding
several times larger than the others; standardised layers and a head of one
scale give every seed work of one difficulty.
"""

from __future__ import annotations

import math

import torch

HEAD = "aggregation.classif3.conv2"  # the eval path's last head's final convolution


DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_model(cfg: dict, device: torch.device):
    """The program's model of configuration ``cfg`` with uninitialised
    storage on ``device`` (in eval mode): the preset with the file's
    ``overrides``, and the file's disparity range, width and dtype, so that
    the model, the counts and the reference take one set of sizes."""
    from ecm_torch.configs.base import CONFIGS

    model_cfg = CONFIGS[cfg["preset"]].model
    sizes = {"max_disp": cfg["shapes"]["max_disp"], "feature_channels": cfg["shapes"]["feature_channels"],
             "dtype": DTYPES[cfg["dtype"]]}
    with torch.device("meta"):
        model = model_cfg.build(device="meta", generator=torch.Generator(), **cfg.get("overrides", {}), **sizes)
    return model.to_empty(device=device).eval()


def _fan_out(name: str, shape: torch.Size) -> int:
    # a transposed convolution's weight is [Cin, Cout, k, k, k]
    cout = shape[1] if name.endswith(".deconv.weight") else shape[0]
    return cout * math.prod(shape[2:])


@torch.no_grad()
def make_weights(template: dict[str, torch.Tensor], spec: dict, seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    """Every entry of ``template`` (a state dict: names and shapes) drawn
    from ``seed`` on ``device``, float32 (integers 0)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    convs = {k: v.shape for k, v in template.items() if v.ndim >= 3}
    rest = {k: v.shape for k, v in template.items() if v.ndim < 3 and v.is_floating_point()}
    out = {}
    flat = torch.randn(sum(math.prod(s) for s in convs.values()), generator=gen, device=device).clamp_(-2.0, 2.0)
    for (name, shape), part in zip(convs.items(), flat.split([math.prod(s) for s in convs.values()])):
        out[name] = part.view(shape).mul_(math.sqrt(2.0 / _fan_out(name, shape)))
    sizes = [math.prod(s) for s in rest.values()]
    uniform = torch.rand(sum(sizes), generator=gen, device=device)
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    for (name, shape), u, n in zip(rest.items(), uniform.split(sizes), normal.split(sizes)):
        if name.endswith("running_var"):
            lo, hi = spec["running_var"]
            out[name] = u.view(shape).mul_(hi - lo).add_(lo)
        elif name.endswith("bn.weight"):
            lo, hi = spec["bn_scale"]
            out[name] = u.view(shape).mul_(hi - lo).add_(lo)
        else:  # BatchNorm shifts and running means, convolution biases
            out[name] = n.view(shape).mul_(spec["shift_std"])
    for name, t in template.items():
        if not t.is_floating_point():
            out[name] = torch.zeros(t.shape, dtype=t.dtype, device=device)
    return out


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
    from stereo_bench.reference import ecm as R

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
    from stereo_bench.reference import ecm as R

    with R.strict_f32():
        cost = R.Net(params, cfg["shapes"]["max_disp"], train=False).cost_maps(pair["left"], pair["right"])[-1]
    scale = cfg["weights"]["head_cost_std"] / cost.std(1).mean().item()
    for name in (f"{HEAD}.weight", f"{HEAD}.bias"):
        params[name].mul_(scale)
    return scale


def seeded_weights(cfg: dict, template: dict[str, torch.Tensor], seed: int, device: torch.device) -> dict:
    """The configuration's weights from ``seed`` (:func:`make_weights`;
    then, where the weights group names a ``calibration_disparity``, on a
    :func:`calibration_pair`: :func:`calibrate_bn_stats` where it sets
    ``bn_stats_from_calibration``, and :func:`normalise_head` where it names
    a ``head_cost_std``)."""
    params = make_weights(template, cfg["weights"], seed, device)
    spec = cfg["weights"]
    if "calibration_disparity" in spec:
        pair = calibration_pair(cfg, seed, device)
        if spec.get("bn_stats_from_calibration"):
            calibrate_bn_stats(params, cfg, pair)
        if "head_cost_std" in spec:
            normalise_head(params, cfg, pair)
    return params


def trainable(model) -> list[str]:
    """The names of the model's parameters, in its order."""
    return [n for n, p in model.named_parameters() if p.requires_grad]
