"""The weight bridge from the JAX package: flax variables -> torch state_dict.

``from_flax`` takes the ``{"params", "batch_stats"}`` tree as nested dicts of
numpy arrays (no JAX needed) and returns the ``state_dict`` of the port's
module with the same scope names. The layout rules are the inverse of
``ecm_tpu/checkpoint_import.py``:

- conv kernel ``[*k, I, O]`` -> ``weight [O, I, *k]``;
- transposed-conv kernel (scope ``deconv``, flax ``ConvTranspose`` with
  ``transpose_kernel=False``) ``[*k, I, O]`` -> ``[I, O, *k]`` with every
  spatial dim flipped;
- dense kernel ``[I, O]`` -> ``weight [O, I]``;
- BN ``scale/bias`` and ``mean/var`` -> ``weight/bias`` and
  ``running_mean/running_var`` (plus ``num_batches_tracked = 0``);
- conv and dense biases carry over.

It is strict: every leaf of the tree must map to a key of ``expected`` and
every key of ``expected`` must be produced, with equal shapes.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_BN_PARAMS = {"scale": "weight", "bias": "bias"}
_BN_STATS = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping, prefix: tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _convert_param(path: tuple[str, ...], a: np.ndarray) -> tuple[str, np.ndarray]:
    scope, leaf = path[:-1], path[-1]
    if scope and scope[-1] == "bn":
        if leaf not in _BN_PARAMS:
            raise KeyError(f"unknown BatchNorm param {'/'.join(path)}")
        return ".".join(scope + (_BN_PARAMS[leaf],)), a
    if leaf == "bias":
        return ".".join(scope + ("bias",)), a
    if leaf != "kernel":
        raise KeyError(f"unknown param {'/'.join(path)}")
    nd = a.ndim - 2
    if nd == 0:  # dense [I, O] -> [O, I]
        w = a.T
    elif scope and scope[-1] == "deconv":  # [*k, I, O] -> [I, O, *k], flipped
        w = np.flip(np.transpose(a, (nd, nd + 1, *range(nd))), axis=tuple(range(2, 2 + nd)))
    else:  # [*k, I, O] -> [O, I, *k]
        w = np.transpose(a, (nd + 1, nd, *range(nd)))
    return ".".join(scope + ("weight",)), w


def from_flax(variables: Mapping, expected: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Convert flax ``variables`` into a state_dict matching ``expected``
    (e.g. ``module.state_dict()``). Raises on a missing or extra key, an
    unknown leaf or a shape mismatch."""
    out: dict[str, np.ndarray] = {}
    for path, a in _leaves(variables.get("params", {})):
        key, w = _convert_param(path, a)
        out[key] = w
    for path, a in _leaves(variables.get("batch_stats", {})):
        scope, leaf = path[:-1], path[-1]
        if leaf not in _BN_STATS:
            raise KeyError(f"unknown batch stat {'/'.join(path)}")
        out[".".join(scope + (_BN_STATS[leaf],))] = a
        out[".".join(scope + ("num_batches_tracked",))] = np.zeros((), np.int64)
    missing = sorted(set(expected) - set(out))
    extra = sorted(set(out) - set(expected))
    if missing or extra:
        raise KeyError(f"flax tree does not match the module: missing {missing}, extra {extra}")
    sd = {}
    for key, ref in expected.items():
        w = out[key]
        if tuple(w.shape) != tuple(ref.shape):
            raise ValueError(f"shape mismatch at {key}: flax {w.shape} vs torch {tuple(ref.shape)}")
        sd[key] = torch.from_numpy(np.ascontiguousarray(w)).to(ref.dtype)
    return sd


def load_flax(module: torch.nn.Module, variables: Mapping) -> torch.nn.Module:
    """Load flax ``variables`` into ``module`` (strict) and return it."""
    expected = module.state_dict()
    sd = {k: v.to(expected[k].device) for k, v in from_flax(variables, expected).items()}
    module.load_state_dict(sd, strict=True)
    return module
