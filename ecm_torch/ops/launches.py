"""The launch counts of the CUDA kernels' wrappers: each wrapper adds one
to its count where it launches its kernel (a CPU tensor launches nothing).
A caller sets them to 0 just before a path and reads them just after.

A CUDA graph's capture (``train/graphs.py``) launches nothing: what the
wrappers count during it is the graph's launches per replay, and their
counts are set back after it. A replay runs no Python, so no wrapper counts
it: each replay adds the launches that its capture counted to a count of
its own, :func:`read_replayed`, which :func:`reset_counts` also sets to 0.
:func:`read_counts` plus :func:`read_replayed` are the launches that ran."""

from __future__ import annotations

from ecm_torch.ops import bn_act as bnk
from ecm_torch.ops import conv_gru as grk
from ecm_torch.ops import cuda_corr1d as corrk
from ecm_torch.ops import cuda_cost_volume as cvk
from ecm_torch.ops import cuda_fused_agg as pairk
from ecm_torch.ops import cuda_geo_lookup as geok
from ecm_torch.ops import cuda_gband as gbk
from ecm_torch.ops import cuda_gdeconv as gdk
from ecm_torch.ops import cuda_regression as regk
from ecm_torch.ops import instance_norm as ink

# name -> (wrapper, attribute)
COUNTERS = {
    "cost_volume_concat": (cvk.cost_volume_concat, "launches"),
    "cost_volume_correlation": (cvk.cost_volume_correlation, "launches"),
    "conv3d_bn_s1": (gbk.conv3d_bn_s1, "launches"),
    "conv3d_bn_down": (gbk.conv3d_bn_down, "launches"),
    "deconv3d_bn": (gdk.deconv3d_bn, "launches"),
    "fused_conv3d_pair": (pairk.fused_conv3d_pair, "launches"),
    "fused_upsample_softargmin": (regk.fused_upsample_softargmin, "launches"),
    "gband_conv_s1": (gbk.gband_conv_s1, "launches"),
    "gband_conv_s1_input_grad": (gbk.gband_conv_s1, "backward_launches"),
    "corr1d_lookup": (corrk.corr1d_lookup, "launches"),
    "instance_norm": (ink.instance_norm, "launches"),
    "conv_gru_pack": (grk.conv_gru_pack, "launches"),
    "conv_gru_gate": (grk.conv_gru_gate, "launches"),
    "conv_gru_update": (grk.conv_gru_update, "launches"),
    "geo_lookup": (geok.geo_lookup, "launches"),
    "gwc_volume": (cvk.cost_volume_correlation, "group_launches"),
    "bn_act": (bnk.bn_act, "launches"),
}


_replayed = dict.fromkeys(COUNTERS, 0)


def reset_counts() -> None:
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)
    _replayed.update(dict.fromkeys(COUNTERS, 0))


def read_counts() -> dict[str, int]:
    return {k: getattr(fn, attr) for k, (fn, attr) in COUNTERS.items()}


def set_counts(counts: dict[str, int]) -> None:
    """Set the wrappers' counts (a CUDA graph's capture sets them back: it
    launches nothing)."""
    for k, n in counts.items():
        fn, attr = COUNTERS[k]
        setattr(fn, attr, n)


def add_replayed(counts: dict[str, int]) -> None:
    for k, n in counts.items():
        _replayed[k] += n


def read_replayed() -> dict[str, int]:
    """The launches that graph replays ran since the last reset."""
    return dict(_replayed)
