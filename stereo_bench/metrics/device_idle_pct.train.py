"""The device's idle share of the traced slice of train steps: one minus the
union of its kernels, copies and sets over the slice's wall time."""

from stereo_bench import trace

UNIT = "%"


def read(windows: list[dict]) -> float | None:
    return trace.idle_pct(windows)
