"""A traced slice of the steady window and the numbers read from it.

:func:`profile` runs a fixed count of requests or steps under
``torch.profiler`` (host and device activity), inside one annotation whose
span is the slice's window, writes the trace under the checkout's
``build/stereo_bench/trace/`` and reads it back: the device's kernels,
copies and sets, and the host's operations, in microseconds of one clock.
The slice is a fixed count of work so that a trace stays a few hundred MB.
The profiler sometimes drops an event, so no reader needs exact counts.

The readers take the list of one window per card used and average over
them. The program's kernels are told apart by symbol, as its sources name
them: a window's ``port_kernels``, which the driver takes from the
configuration's family.
"""

from __future__ import annotations

import bisect
import json
from pathlib import Path

from stereo_bench import counts

TRACE_DIR = Path(__file__).resolve().parents[1] / "build" / "stereo_bench" / "trace"
WINDOW = "stereo_bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
TOP = 10
MIN_GAP_US = 2.0
SCAN = 2000


def profile(run_slice, name: str, work: dict) -> dict:
    """Run ``run_slice()`` (which ends in a synchronise) under the profiler
    and return its window: ``wall_s``, ``device`` and ``host`` events
    ``(name, start_us, end_us, cat)``, the window's bounds ``t0``/``t1`` and
    ``work`` (pairs, steps, flops, the bound of the program's forms, the
    symbols of its kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = TRACE_DIR / f"{name}.json"
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            run_slice()
    prof.export_chrome_trace(str(path))
    try:
        events = json.loads(path.read_text())["traceEvents"]
    finally:
        path.unlink(missing_ok=True)
    (span,) = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    t0, t1 = float(span["ts"]), float(span["ts"]) + float(span["dur"])

    def clipped(cats):
        out = []
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in cats and e is not span:
                start, end = max(float(e["ts"]), t0), min(float(e["ts"]) + float(e.get("dur", 0)), t1)
                if end > start:
                    out.append((e["name"], start, end, e["cat"]))
        return out

    return {"wall_s": (t1 - t0) / 1e6, "t0": t0, "t1": t1, "device": clipped(DEVICE_CATS),
            "host": clipped(HOST_CATS), **work}


def busy_us(win: dict) -> float:
    """The union of the device's intervals in the window."""
    total, end = 0.0, float("-inf")
    for _, start, stop, _ in sorted(win["device"], key=lambda e: e[1]):
        total += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return total


def kernel_us(win: dict, port: bool) -> float:
    """Device time of the window's kernels: ``port`` True the program's
    (a name that holds one of the window's ``port_kernels``), False every
    other."""
    return sum(stop - start for name, start, stop, cat in win["device"]
               if cat == "kernel" and any(s in name for s in win["port_kernels"]) == port)


def _mean(values: list[float | None]) -> float | None:
    values = [v for v in values if v is not None]
    return sum(values) / len(values) if values else None


def idle_pct(windows: list[dict]) -> float | None:
    return _mean([100.0 * (1.0 - busy_us(w) / 1e6 / w["wall_s"]) for w in windows if w["device"]])


def mfu_pct(windows: list[dict]) -> float | None:
    """The window's FLOPs (the benchmark's count of the work it completed)
    over its wall time and the bf16 peak."""
    return _mean([100.0 * w["flops"] / w["wall_s"] / counts.PEAK_BF16_FLOPS for w in windows if w.get("flops")])


def port_roofline_pct(windows: list[dict]) -> float | None:
    """The sum of the bounds of the forms the window ran through the
    program's kernels over those kernels' device time."""
    return _mean([100.0 * w["port_bound_s"] * 1e6 / us for w in windows
                  if w.get("port_bound_s") and (us := kernel_us(w, port=True)) > 0])


def library_ms(windows: list[dict], per: str) -> float | None:
    """Device time of every kernel outside the program's, per pair or step."""
    return _mean([kernel_us(w, port=False) / 1e3 / w[per] for w in windows if w["device"] and w.get(per)])


def breakdown(win: dict) -> dict:
    """The device operations that took most time, and the longest idle gaps
    summed by what the host was doing (its innermost operation at the
    gap's middle), in seconds."""
    by_op: dict[str, float] = {}
    for name, start, stop, _ in win["device"]:
        by_op[name[:120]] = by_op.get(name[:120], 0.0) + (stop - start) / 1e6
    gaps, end = [], win["t0"]
    for _, start, stop, _ in sorted(win["device"], key=lambda e: e[1]):
        if start - end >= MIN_GAP_US:
            gaps.append((end, start))
        end = max(end, stop)
    if win["t1"] - end >= MIN_GAP_US:
        gaps.append((end, win["t1"]))
    host = sorted(win["host"], key=lambda e: e[1])
    starts = [e[1] for e in host]
    by_host: dict[str, float] = {}
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:2000]:
        mid = (a + b) / 2
        # of properly nested operations, the innermost one around ``mid`` is
        # the one that started last
        i = bisect.bisect_right(starts, mid)
        inner = next((e for e in reversed(host[max(0, i - SCAN):i]) if e[2] >= mid), None)
        label = inner[0][:120] if inner else "host outside any operation"
        by_host[label] = by_host.get(label, 0.0) + (b - a) / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]  # noqa: E731
    return {"device_ops": top(by_op), "idle_gaps": top(by_host)}
