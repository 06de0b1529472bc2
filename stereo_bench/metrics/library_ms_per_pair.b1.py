"""Device time of every kernel outside the program's own (cuDNN, torch) per
pair served at batch 1."""

from stereo_bench import trace

UNIT = "ms"


def read(windows: list[dict]) -> float | None:
    return trace.library_ms(windows, "pairs")
