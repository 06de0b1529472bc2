"""Serving time of two checkouts on one card, in turns: parent, change,
change, parent.

    git archive <parent> | tar -x -C build/parent
    python3 scripts/serve_ab.py --parent build/parent

Each turn runs that checkout's own copy of this script with ``--one``, in
a fresh process from the checkout's root, so that each builds and imports
its own ``ecm_torch`` and calls its own ``chip_smoke`` as that checkout
defines it: it serves ``kitti_infer``'s two ECMStereo paths at full
width (``chip_smoke.serve``: grouped and standard, batch 1 and 8, launch
counts and the cost map against the plain path checked) and profiles a
batch-1 window of each (``chip_smoke.profile_forward``). Prints one JSON
line per turn and a summary of the medians. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

GROUPED = dict(cost_volume_concat=1, conv3d_bn_s1=4, conv3d_bn_down=3, deconv3d_bn=3, fused_conv3d_pair=1,
               fused_upsample_softargmin=1)
STANDARD = dict(cost_volume_concat=1, fused_conv3d_pair=3, fused_upsample_softargmin=1)


def one() -> dict:
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from ecm_torch.kernels import build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    build.build()
    out = {"tree": os.getcwd(), "card": cs.nvidia_smi("name,power.limit"), "build_s": time.time() - t0}
    out["grouped"] = cs.serve("slice2_grouped", "stackhourglass", cs.SLICE2_OVERRIDES, GROUPED, batch8=True)
    out["standard"] = cs.serve("slice1_standard", "stackhourglass", cs.SLICE_OVERRIDES, STANDARD, batch8=True)
    for path in ("slice2_grouped", "slice1_standard"):
        out["profile_" + path] = cs.profile_forward(path)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", help="the parent checkout's root")
    parser.add_argument("--one", action="store_true", help="serve the checkout in the working directory once")
    args = parser.parse_args()
    if args.one:
        print("SERVE " + json.dumps(one()), flush=True)
        return 0
    if not args.parent:
        parser.error("--parent is required")
    turns = []
    for name, root in (("parent", args.parent), ("change", "."), ("change", "."), ("parent", args.parent)):
        script = Path(root, "scripts", "serve_ab.py").resolve()
        run = subprocess.run([sys.executable, str(script), "--one"], cwd=root, capture_output=True, text=True)
        line = next((l for l in run.stdout.splitlines() if l.startswith("SERVE ")), None)
        if run.returncode or line is None:
            sys.stderr.write(run.stdout[-4000:] + run.stderr[-4000:])
            raise SystemExit(f"serve_ab: the {name} turn failed")
        result = json.loads(line[len("SERVE "):])
        result["name"] = name
        turns.append(result)
        print(json.dumps(result), flush=True)
    summary = {}
    for name in ("parent", "change"):
        mine = [t for t in turns if t["name"] == name]
        for path in ("grouped", "standard"):
            for key in ("ms_per_forward_b1", "ms_per_forward_b8"):
                summary[f"{name} {path} {key}"] = [t[path][key] for t in mine]
            prof = [t["profile_slice2_grouped" if path == "grouped" else "profile_slice1_standard"] for t in mine]
            summary[f"{name} {path} device busy ms a b1 forward"] = [p["device_busy_ms_per_forward"] for p in prof]
            summary[f"{name} {path} pair device ms a b1 forward"] = [
                p["ms_per_forward_by_group"].get("fused_conv3d_pair", 0.0) for p in prof]
            summary[f"{name} {path} idle share"] = [p["idle_share"] for p in prof]
    print("SUMMARY " + json.dumps({k: [statistics.median(v), v] for k, v in summary.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
