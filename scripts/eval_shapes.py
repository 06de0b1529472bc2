"""``evaluate`` over many input shapes and over one, eager against graphed,
on one card.

    python3 scripts/eval_shapes.py [--scenes 8] [--out build/eval_shapes/result.json]

Writes two Middlebury-layout trees of seeded synthetic pairs under
``build/eval_shapes``: ``mixed``, each scene its own size (H 960-1000, W
1400-1500, about Middlebury 2014's half resolution; ``evaluate`` pads each
to a multiple of 32, so every scene is a signature of its own), and
``repeated``, every scene 375x1242 (KITTI 2015's size, one signature). Runs
``ecm_torch.cli.evaluate --dataset middlebury`` in-process on each tree
with the ``kitti_infer`` preset's seeded random weights, three ways, in the
turns a, b, c, c, b, a:

- ``eager``: the eval step calls its function and never captures;
- ``graphed``: as the port serves (``ecm_torch/train/graphs.py``): the
  second sighting of a signature captures, later ones replay;
- ``first_sighting``: every signature captured the first time it is seen
  (``GraphedForward._miss`` replaced by ``_capture``).

For each run: evaluate's wall time, the time of each eval step (synchronised
before and after), the graphs kept at the end, their capture times and pool
bytes, the largest device memory reserved, and the metrics, which must be
the same in every run of a tree. Prints one JSON line a run and a summary of
the medians, and writes both to ``--out``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent.parent
MODES = ("eager", "graphed", "first_sighting")
TURNS = (*MODES, *reversed(MODES))


def write_tree(root: Path, sizes: list[tuple[int, int]], seed: int) -> str:
    """Middlebury-layout scenes (``im0.png``, ``im1.png``, ``disp0GT.pfm``)
    of seeded synthetic pairs at ``sizes``."""
    import numpy as np
    from PIL import Image

    from ecm_torch.data import make_pair, write_pfm

    rng = np.random.default_rng(seed)
    for i, (h, w) in enumerate(sizes):
        s = make_pair(rng, h, w, max_disp=96.0, normalized=False)
        scene = root / f"Scene{i:02d}"
        scene.mkdir(parents=True, exist_ok=True)
        for side, name in (("left", "im0.png"), ("right", "im1.png")):
            Image.fromarray(np.clip(np.round(s[side]), 0, 255).astype(np.uint8)).save(scene / name)
        write_pfm(str(scene / "disp0GT.pfm"), s["disparity"])
    return str(root)


def run(mode: str, tree: str) -> dict:
    """``evaluate`` on ``tree`` once, served ``mode``."""
    import torch

    from ecm_torch.cli import evaluate
    from ecm_torch.train.graphs import GraphedForward

    steps_ms, served = [], []
    call = GraphedForward.__call__

    def timed(self, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*args) if mode == "eager" else call(self, *args)
        torch.cuda.synchronize()
        steps_ms.append((time.perf_counter() - t0) * 1e3)
        served.append(self)
        return out

    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(GraphedForward, "__call__", timed))
        if mode == "first_sighting":
            stack.enter_context(mock.patch.object(GraphedForward, "_miss", lambda self, key, args: self._capture(key, args)))
        printed = stack.enter_context(contextlib.redirect_stdout(io.StringIO()))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        evaluate.main(["--dataset", "middlebury", "--datapath", tree])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kept = list(served[-1].graphs.values())
    out = dict(
        mode=mode, wall_s=wall_s, steps_ms=steps_ms, steps_ms_sum=sum(steps_ms),
        graphs_kept=len(kept), capture_ms=[g.capture_ms for g in kept], pool_bytes=[g.pool_bytes for g in kept],
        max_reserved_bytes=torch.cuda.max_memory_reserved(),
        metrics=json.loads(printed.getvalue().strip().splitlines()[-1]),
    )
    del served, kept
    torch.cuda.empty_cache()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--scenes", type=int, default=8)
    parser.add_argument("--out", default=str(ROOT / "build" / "eval_shapes" / "result.json"))
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    os.chdir(ROOT)
    import numpy as np
    import torch

    from ecm_torch.kernels import build

    if not torch.cuda.is_available():
        raise SystemExit("eval_shapes: needs a CUDA device")
    build.build()
    rng = np.random.default_rng(0)
    mixed = sorted({(int(rng.integers(960, 1001)), int(rng.integers(1400, 1501))) for _ in range(args.scenes)})
    padded = {(-(-h // 32) * 32, -(-w // 32) * 32) for h, w in mixed}
    base = ROOT / "build" / "eval_shapes"
    trees = {
        "mixed": write_tree(base / "mixed", mixed, 1),
        "repeated": write_tree(base / "repeated", [(375, 1242)] * args.scenes, 2),
    }
    card = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    result = dict(card=card, scenes=args.scenes, mixed_sizes=mixed, mixed_signatures=len(padded), runs={})
    run("graphed", trees["repeated"])  # builds and loads everything once, untimed
    for name, tree in trees.items():
        runs = result["runs"][name] = []
        for mode in TURNS:
            r = run(mode, tree)
            runs.append(r)
            print(json.dumps(dict(tree=name, **r)), flush=True)
        if any(r["metrics"] != runs[0]["metrics"] for r in runs):
            raise SystemExit(f"eval_shapes: the {name} tree's metrics differ between runs")
    result["summary"] = {
        f"{name} {mode}": {k: statistics.median(r[k] for r in runs if r["mode"] == mode)
                           for k in ("wall_s", "steps_ms_sum", "graphs_kept", "max_reserved_bytes")}
        for name, runs in result["runs"].items() for mode in MODES
    }
    print("SUMMARY " + json.dumps(dict(card=card, **result["summary"])), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
