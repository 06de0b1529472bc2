"""Device time of every kernel outside the program's own (cuDNN convolutions
and weight gradients, BatchNorm, Adam) per train step."""

from stereo_bench import trace

UNIT = "ms"


def read(windows: list[dict]) -> float | None:
    return trace.library_ms(windows, "steps")
