"""Batch-1 serving's share of the bf16 peak: the benchmark's FLOP count of the
eval forwards the slice completed over its wall time."""

from stereo_bench import trace

UNIT = "%"


def read(windows: list[dict]) -> float | None:
    return trace.mfu_pct(windows)
