"""The program's kernels on the batch-1 eval path against their roofline: the
sum of the bounds of the forms they ran over their device time."""

from stereo_bench import trace

UNIT = "%"


def read(windows: list[dict]) -> float | None:
    return trace.port_roofline_pct(windows)
