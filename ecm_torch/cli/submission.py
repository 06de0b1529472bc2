"""KITTI test-server submission (port of ``ecm_tpu/cli/submission.py``, the
reference's ``submission.py``): pads each test pair to 384x1248 (top and
right), runs the eval forward, un-pads, and writes uint16 PNGs (disparity *
256). The time printed beside each file runs from the host arrays to the
disparity back on the host. With ``--multihost`` every rank runs every pair,
as ``ecm_tpu``'s does, and rank 0 writes and prints; with ``--mesh-disp N``
the N ranks split each pair's disparities.

    python -m ecm_torch.cli.submission --datapath /data/kitti2015 \\
        --loadmodel ./ckpt_kitti --outdir ./disp_0
"""

from __future__ import annotations

import os
import time

import torch

from ecm_torch.cli.common import (
    base_parser,
    build_state,
    eval_mesh,
    maybe_init_distributed,
    resolve_config,
    restore,
    say,
    shutdown_distributed,
)
from ecm_torch.data.kitti import list_kitti, load_sample, save_disp_png
from ecm_torch.data.preprocess import unpad
from ecm_torch.parallel import is_main_process, use_mesh
from ecm_torch.train.steps import make_infer_fn


def main(argv: list[str] | None = None) -> None:
    parser = base_parser("ecm_torch KITTI submission (reference submission.py)")
    parser.add_argument("--outdir", default="disp_0")
    parser.add_argument("--datatype", default="2015", choices=["2012", "2015"])
    args = parser.parse_args(argv)
    maybe_init_distributed(args)
    cfg = resolve_config(args, default_preset="kitti_infer")

    mesh = eval_mesh(cfg)
    state, _ = restore(build_state(cfg, args.device, 0), args.loadmodel)
    device = next(state.model.parameters()).device
    infer = make_infer_fn(state.model)

    year = 2015 if args.datatype == "2015" else 2012
    specs, _ = list_kitti(cfg.data.datapath, year=year, split="testing")
    if is_main_process():
        os.makedirs(args.outdir, exist_ok=True)
    for spec in specs:
        sample = load_sample(spec, crop=None)
        t0 = time.perf_counter()
        left = torch.from_numpy(sample["left"])[None].to(device)
        right = torch.from_numpy(sample["right"])[None].to(device)
        with use_mesh(mesh):
            disp = infer(left, right)[0].float().cpu().numpy()
        dt = time.perf_counter() - t0
        disp = unpad(disp, tuple(sample["pads"]))
        out = os.path.join(args.outdir, os.path.basename(spec.left))
        if is_main_process():
            save_disp_png(out, disp)
        say(f"{out}  {dt * 1e3:.1f} ms")
    shutdown_distributed()


if __name__ == "__main__":
    main()
