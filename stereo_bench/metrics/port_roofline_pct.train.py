"""The program's kernels in a train step (gband_conv_s1 forward and input
gradient) against their roofline: the sum of the bounds of the forms over
their device time."""

from stereo_bench import trace

UNIT = "%"


def read(windows: list[dict]) -> float | None:
    return trace.port_roofline_pct(windows)
