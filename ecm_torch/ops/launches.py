"""The launch counts of the CUDA kernels' wrappers: each wrapper adds one
to its count where it launches its kernel (a CPU tensor launches nothing).
A caller sets them to 0 just before a path and reads them just after."""

from __future__ import annotations

from ecm_torch.ops import cuda_cost_volume as cvk
from ecm_torch.ops import cuda_fused_agg as pairk
from ecm_torch.ops import cuda_gband as gbk
from ecm_torch.ops import cuda_gdeconv as gdk
from ecm_torch.ops import cuda_regression as regk

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
}


def reset_counts() -> None:
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)


def read_counts() -> dict[str, int]:
    return {k: getattr(fn, attr) for k, (fn, attr) in COUNTERS.items()}
