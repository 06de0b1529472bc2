"""Cells cut to a size the CPU runs in seconds, for the harness's own tests:
64x128 pairs, max-disp 64, two pairs a request or step, and optionally the
program in float32 (so that a sound run reads far inside the limits set for
bfloat16 at full size)."""

from __future__ import annotations

import copy

from stereo_bench import harness


def tiny(name: str, f32: bool = True, man: dict | None = None) -> dict:
    """The cell ``name`` of ``man`` (the benchmark's manifest by default)
    cut to that size."""
    spec = copy.deepcopy(harness.cell(name, man or harness.manifest()))
    cfg, mix = spec["config"], spec["mix"]
    cfg["shapes"].update(height=64, width=128, max_disp=64)
    if f32:
        cfg["dtype"] = "float32"
    if "batch" in cfg["shapes"]:
        cfg["shapes"]["batch"] = 2
    mix["pool"] = 4
    if mix["driver"] == "serve":
        mix.update(batch=2, reference_block=1, trace_requests=3, checked_requests=2)
    else:
        mix.update(trace_steps=2)
    return spec
