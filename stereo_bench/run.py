"""Run one cell of the benchmark once.

    python3 -m stereo_bench.run --workload kitti_b1 --seed 1234 --seconds 10 --trace 0

from the root of a checkout. ``--trace 0`` measures the cell's end-to-end
metrics over a window of ``--seconds``; ``--trace 1`` profiles a fixed
slice of the same traffic and reports the per-layer metrics. Either way the
last line on standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and ``checked`` last: each number compared beside its limit),
and the last lines on standard error are those numbers again. Without the
cards the cell asks for, or with JAX or the JAX package loaded, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from stereo_bench import harness  # noqa: E402

# every build and kernel cache at a fixed path inside the checkout (the
# program's own nvcc builds go to build/ecm_torch/ by its code)
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions"}


def card_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi unavailable: {err}"


def measure(spec: dict, seed: int, seconds: float, traced: bool, device, t_start: float) -> dict:
    """Everything after the look for the cards: the cell's driver, the check
    that neither JAX nor the JAX package was loaded, and the result line."""
    import torch

    out = harness.driver(spec["mix"]).run(spec, seed, seconds, traced, device, t_start)
    found = harness.forbidden_loaded()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package loaded: {found}")
    on_card = device.type == "cuda"
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else device.type,
           "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    if traced:
        from stereo_bench import trace

        wins = out["windows"]
        dev["busy_s"] = sum(trace.busy_us(w) for w in wins) / 1e6 / len(wins)
        dev["window_s"] = sum(w["wall_s"] for w in wins) / len(wins)
        out["breakdown"] = trace.breakdown(wins[0])
    return harness.result_line(spec, out, traced, dev)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(harness.ROOT / "build" / "stereo_bench" / sub)

    spec = harness.cell(args.workload, harness.manifest())
    harness.require_cards(spec["workload"]["chips"])
    import torch

    line = measure(spec, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T_START)
    print(f"card: {card_limit()}", file=sys.stderr)
    print("metrics: " + json.dumps(line["metrics"]), file=sys.stderr)
    for key, c in line["checked"].items():
        print(f"check {key}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
