"""The share of the batch-1 slice's wall time in which the device is idle
while the host is inside one of the program's ``ecm.*`` spans: the part of
``device_idle_pct.b1`` that the program's own host work causes (the rest is
the caller's, here the pageable copies around each request)."""

from stereo_bench import spans

UNIT = "%"
SPANS = (spans.PROGRAM,)


def read(windows: list[dict]) -> float | None:
    return spans.program_idle_pct(windows)
