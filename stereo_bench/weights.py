"""Seeded weights, the same for the program and the reference.

The benchmark makes every parameter and BatchNorm statistic itself, on the
device, from ``--seed`` (a ``torch.Generator`` on the card, one draw for all
convolution weights and one for the rest); the program's model loads them
with ``load_state_dict`` and the reference reads the same tensors. The names
and shapes come from the program's module tree, built on the ``meta``
device (no host work, no initialisation) by the configuration's family
(``families/``), which may then calibrate them.

The distribution (the configuration's ``weights`` group): convolution
weights He-normal over fan-out, clamped at two standard deviations, as the
program initialises them; BatchNorm scales uniform in ``bn_scale``, shifts,
biases and running means normal with standard deviation ``shift_std``,
running variances uniform in ``running_var``.
"""

from __future__ import annotations

import math

import torch


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


def trainable(model) -> list[str]:
    """The names of the model's parameters, in its order."""
    return [n for n, p in model.named_parameters() if p.requires_grad]
