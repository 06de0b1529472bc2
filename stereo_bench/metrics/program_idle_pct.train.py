"""The share of the train slice's wall time in which the device is idle
while the host is inside one of the program's ``ecm.*`` spans, the batch's
copies in ``ecm.loop.to_device`` among them: the part of
``device_idle_pct.train`` that the program's own host work causes."""

from stereo_bench import spans

UNIT = "%"
SPANS = (spans.PROGRAM,)


def read(windows: list[dict]) -> float | None:
    return spans.program_idle_pct(windows)
