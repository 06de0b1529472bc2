"""The program built in a precision below its configuration's, run as the
cell runs it and checked by the harness's own comparison, on the card.

    python3 -m stereo_bench.lower_precision --workload raft_kitti_b1 --dtype bfloat16 --seeds 1 2 3 4 --seconds 2

Where the program has such a build (``raft_kitti_b1``: bfloat16 below the
configuration's float16), it is a control that the cell's limits must catch:
each seed's line must read ``"correct": false``. The readings are the upper
ones beside ``calibrate``'s (PERF.md §6's rule for a cell's limits). One
JSON line a seed, as ``calibrate``'s program lines. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import copy
import json
import time

import torch

from stereo_bench import harness


def run(spec: dict, dtype: str, seed: int, seconds: float, device: torch.device) -> dict:
    """One whole run of the cell ``spec`` (a short window) with the program
    built in ``dtype``; the line ``calibrate`` prints for a program seed."""
    spec = copy.deepcopy(spec)
    spec["config"]["dtype"] = dtype
    out = harness.driver(spec["mix"]).run(spec, seed, seconds, False, device, time.perf_counter())
    return {"workload": spec["workload"]["name"], "seed": seed, "dtype": dtype, "program": out["numbers"],
            "correct": out["correct"]}


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--dtype", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    spec = harness.cell(args.workload, harness.manifest())
    if args.dtype == spec["config"]["dtype"]:
        raise SystemExit(f"{args.dtype} is the configuration's own precision")
    harness.require_cards(spec["workload"]["chips"])
    for seed in args.seeds:
        print(json.dumps(run(spec, args.dtype, seed, args.seconds, torch.device("cuda", 0))), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
