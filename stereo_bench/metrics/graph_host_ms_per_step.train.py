"""The host time of the program's train step per step: the summed
``ecm.train.step`` spans of the traced slice over its steps (the learning
rate's write, the graph wrapper's call and the step counts)."""

from stereo_bench import spans

UNIT = "ms"
SPANS = ("ecm.train.step",)


def read(windows: list[dict]) -> float | None:
    return spans.span_ms(windows, SPANS[0], "steps")
