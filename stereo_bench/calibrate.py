"""The readings that a cell's limits are set from, on the card.

    python3 -m stereo_bench.calibrate --workload kitti_b1 --seeds 1 2 3 --control-seeds 4 5 6 --seconds 2

For each of ``--seeds``, one whole run of the cell (a short window) in this
process: the program's numbers, whose largest is a limit's lower reading.
For each of ``--control-seeds``, the control put in the program's place on
that seed's weights and inputs: the reference computed in float8 (the
family's ``FP8``: e4m3, a per-tensor scale) against the float32 reference,
the precision below the configuration's bfloat16; for a serving cell also the
fault of a stale answer (another input's reference answer in the place of
this one's), for a training cell the fault of half the batch left out (the
reference's steps on the first half of each batch's rows). These set the
limits' upper readings. One JSON line each. The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from stereo_bench import compare, harness, synth
from stereo_bench import weights as W
from stereo_bench.families import family


def serve_control(spec: dict, seed: int, device: torch.device) -> dict:
    """The float8 reference against the float32 one on as many answers as a
    run compares: the pool's first requests of the seed."""
    cfg, mix = spec["config"], spec["mix"]
    fam, s = family(cfg), cfg["shapes"]
    params = fam.seeded_weights(cfg, fam.build(cfg, torch.device("meta")).state_dict(), seed, device)
    pool = synth.make_pool(seed + 1, mix["pool"], mix["batch"], s["height"], s["width"], *mix["disparity_range"], device)
    errors, stale, previous = [], [], None
    for x in pool[: mix["checked_requests"]]:
        for lo in range(0, mix["batch"], mix["reference_block"]):
            left = x["left"][lo:lo + mix["reference_block"]].to(device)
            right = x["right"][lo:lo + mix["reference_block"]].to(device)
            ref = fam.infer(params, cfg, left, right, fam.EXACT)
            errors.append((fam.infer(params, cfg, left, right, fam.FP8) - ref).abs())
            if previous is not None:
                stale.append((previous - ref).abs())
            previous = ref
    # the fault of a stale answer: another input's answer in the place of this one's
    return {"control": compare.serve_numbers(errors), "stale_answer": compare.serve_numbers(stale)}


def train_control(spec: dict, seed: int, device: torch.device) -> dict:
    """The float8 reference's first steps, and the reference's on half of
    each batch, against the float32 reference's."""
    from stereo_bench.drivers import train as T

    cfg, mix = spec["config"], spec["mix"]
    fam = family(cfg)
    model = fam.build(cfg, torch.device("meta"))
    names = W.trainable(model)
    params = fam.seeded_weights(cfg, model.state_dict(), seed, device)
    batches = [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
               for b in T.host_pool(cfg, mix, seed, device)[:T.CHECKED_STEPS]]
    run = lambda bs, precision=fam.EXACT: fam.train_steps(params, names, cfg, bs, precision)  # noqa: E731
    ref = run(batches)
    half = [{k: v[: v.shape[0] // 2] for k, v in b.items()} for b in batches]
    return {"control": compare.train_numbers(run(batches, fam.FP8), ref, params, names)["numbers"],
            "half_batch": compare.train_numbers(run(half), ref, params, names)["numbers"]}


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    spec = harness.cell(args.workload, harness.manifest())
    harness.require_cards(spec["workload"]["chips"])
    device = torch.device("cuda", 0)
    run = harness.driver(spec["mix"]).run
    for seed in args.seeds:
        out = run(spec, seed, args.seconds, False, device, time.perf_counter())
        print(json.dumps({"workload": args.workload, "seed": seed, "program": out["numbers"],
                          "correct": out["correct"]}), flush=True)
    control = train_control if spec["mix"]["driver"] == "train" else serve_control
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        readings = control(spec, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed, **readings,
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
