"""The host time of the program's graph wrapper per pair served at batch 1:
the summed ``ecm.graph.call`` spans of the traced slice over its pairs (the
signature, the input copies' enqueue, the graph's launch, the clones)."""

from stereo_bench import spans

UNIT = "ms"
SPANS = ("ecm.graph.call",)


def read(windows: list[dict]) -> float | None:
    return spans.span_ms(windows, SPANS[0], "pairs")
