"""Numbers read from the program's own spans in a traced slice.

The program marks its host work with ``ecm.*`` spans
(``ecm_torch/utils/profiling.span``: ``ecm.graph.call`` around a call of its
graph wrapper, ``ecm.train.step`` around a train step,
``ecm.loop.to_device`` around a batch's copies, and the parts of a call
inside ``ecm.graph.call``). They are ``record_function`` annotations, so
``trace.profile`` returns them among a window's ``host`` events, on the
clock of the device's kernels, copies and sets. A program without them (an
older commit) gives every reader here None, never an error.
"""

from __future__ import annotations

from stereo_bench import trace

PROGRAM = "ecm."  # the namespace of every span the program opens
ANNOTATION = "user_annotation"


def _union(intervals) -> list[list[float]]:
    """The union of ``(start, end)`` intervals, as sorted, disjoint
    ``[start, end]`` pairs."""
    out: list[list[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def _overlap_us(a: list[list[float]], b: list[list[float]]) -> float:
    """The length of the intersection of two sorted, disjoint unions."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def span_ms(windows: list[dict], name: str, per: str) -> float | None:
    """The summed host time of the spans named ``name`` in a window, in ms
    per pair or step (``per``: a key of the window's work). None where no
    window holds such a span."""
    return trace._mean([
        sum(e[2] - e[1] for e in spans) / 1e3 / w[per]
        for w in windows
        if w.get(per) and (spans := [e for e in w["host"] if e[0] == name and e[3] == ANNOTATION])
    ])


def program_idle_pct(windows: list[dict]) -> float | None:
    """The share of a window's wall time in which the device is idle (no
    kernel, copy or set) while the host is inside one of the program's
    spans: the part of ``trace.idle_pct`` that the program's own host work
    causes. None where no window holds a span of the program."""
    values = []
    for w in windows:
        spans = _union((a, b) for name, a, b, cat in w["host"] if cat == ANNOTATION and name.startswith(PROGRAM))
        if not spans or not w["device"]:
            continue
        busy = _union((a, b) for _, a, b, _ in w["device"])
        in_spans = sum(b - a for a, b in spans)
        values.append(100.0 * (in_spans - _overlap_us(spans, busy)) / 1e6 / w["wall_s"])
    return trace._mean(values)
