"""Reference checkpoints into the port (port of
``ecm_tpu/checkpoint_import.py``).

The reference saves ``torch.save({'state_dict': model.state_dict(), ...},
'checkpoint_N.tar')`` with ``nn.DataParallel``'s ``module.`` prefixes.

- ``load_torch_checkpoint`` reads such a ``.tar``/``.pth`` onto the CPU and
  strips the prefixes.
- ``import_by_structure`` maps it onto the port's module by structure, not
  by name: the i-th conv (or BatchNorm) of the checkpoint goes to the i-th
  conv (or BatchNorm) of the module, with a shape check at every
  assignment. The module's layers are taken in the order in which
  ``ecm_tpu`` takes the flax tree's (each scope path in natural order), so
  that one checkpoint lands on the same layers in both packages.

The port's layers keep torch's layouts (conv ``[O, I, *k]``, transposed
conv ``[I, O, *k]``), so no layout is converted; the layer counts and every
shape must still match.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import torch


def load_torch_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """Read a reference checkpoint -> flat ``{name: tensor}`` on the CPU,
    ``module.`` prefixes stripped."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    return {k.removeprefix("module."): v for k, v in sd.items()}


def _natkey(s: str):
    """Natural order ('layer2_2' < 'layer2_10')."""
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


def _layer_groups(sd: Mapping[str, torch.Tensor]) -> list[tuple[str, dict[str, torch.Tensor]]]:
    """A state_dict's entries grouped by layer (the name before the last
    dot), in insertion order; ``num_batches_tracked`` left out."""
    groups: dict[str, dict[str, torch.Tensor]] = {}
    for name, value in sd.items():
        if name.endswith("num_batches_tracked"):
            continue
        stem, leaf = name.rsplit(".", 1)
        groups.setdefault(stem, {})[leaf] = value
    return list(groups.items())


def _path_key(*components: str):
    return [_natkey(c) for c in components]


def _module_layers(expected: Mapping[str, torch.Tensor]) -> tuple[list[str], list[str]]:
    """The module's conv (and dense) scopes and BatchNorm scopes (each
    ending in ``bn``), in ``ecm_tpu``'s order of the matching flax paths
    (``<scope>/kernel`` and ``<scope>``)."""
    convs, bns = [], []
    for name in expected:
        scope, leaf = name.rsplit(".", 1)
        if scope.rsplit(".", 1)[-1] == "bn":
            if leaf == "running_mean":
                bns.append(scope)
        elif leaf == "weight":
            convs.append(scope)
    convs.sort(key=lambda s: _path_key(*s.split("."), "kernel"))
    bns.sort(key=lambda s: _path_key(*s.split(".")))
    return convs, bns


_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def import_by_structure(
    sd: Mapping[str, torch.Tensor], expected: Mapping[str, torch.Tensor]
) -> dict[str, torch.Tensor]:
    """A state_dict for the module whose ``state_dict()`` is ``expected``,
    filled from the checkpoint ``sd`` by structure. Raises ``ValueError``
    naming both sides on a layer-count or shape mismatch."""
    out = dict(expected)

    def assign(key: str, source: str, value: torch.Tensor) -> None:
        if key not in out:
            raise ValueError(f"checkpoint {source} has no counterpart: the module has no {key}")
        old = out[key]
        if tuple(old.shape) != tuple(value.shape):
            raise ValueError(
                f"shape mismatch at {key} <- checkpoint {source}: {tuple(old.shape)} vs {tuple(value.shape)}"
            )
        out[key] = value.detach().to(dtype=old.dtype, device=old.device)

    convs, bns = _module_layers(expected)
    groups = _layer_groups(sd)
    src_convs = [(stem, g) for stem, g in groups if "weight" in g and g["weight"].ndim >= 4]
    src_bns = [(stem, g) for stem, g in groups if "running_mean" in g]
    if len(convs) != len(src_convs) or len(bns) != len(src_bns):
        raise ValueError(
            f"layer-count mismatch: module {len(convs)} convs / {len(bns)} BNs vs checkpoint "
            f"{len(src_convs)} / {len(src_bns)}; the structural import needs identical architectures"
        )
    for scope, (stem, group) in zip(convs, src_convs):
        for leaf in ("weight", "bias"):
            if leaf in group:
                assign(f"{scope}.{leaf}", f"{stem}.{leaf}", group[leaf])
    for scope, (stem, group) in zip(bns, src_bns):
        for leaf in _BN_LEAVES:
            assign(f"{scope}.{leaf}", f"{stem}.{leaf}", group[leaf])
    return out
