"""Evaluation (port of ``ecm_tpu/cli/evaluate.py``): EPE, D1-all and the
k-px rates over a SceneFlow test split, a KITTI validation split or the
Middlebury scenes with ground truth, printed as one JSON object (the mean
of each metric over the pairs, and ``num_pairs``). With ``--multihost``
every rank evaluates the whole set, as ``ecm_tpu``'s does, and rank 0 prints;
with ``--mesh-disp N`` (the ``middlebury_disp_sharded`` preset) the N ranks
split each pair's disparities.

    python -m ecm_torch.cli.evaluate --datapath /data/sceneflow --dataset sceneflow \\
        --loadmodel ./ckpt
    python -m torch.distributed.run --nproc_per_node 4 -m ecm_torch.cli.evaluate \\
        --config middlebury_disp_sharded --maxdisp 384 --dataset middlebury \\
        --datapath /data/middlebury --multihost [--dist-backend gloo]
"""

from __future__ import annotations

import json

import numpy as np

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
from ecm_torch.data.pipeline import make_eval_iterator
from ecm_torch.parallel import use_mesh
from ecm_torch.train.loop import to_device
from ecm_torch.train.steps import make_eval_step


def main(argv: list[str] | None = None) -> None:
    parser = base_parser("ecm_torch evaluation (EPE / D1-all)")
    parser.add_argument(
        "--dataset",
        default="sceneflow",
        choices=["sceneflow", "kitti2015", "kitti2012", "middlebury"],
    )
    parser.add_argument("--limit", type=int, default=0, help="max pairs (0 = all)")
    args = parser.parse_args(argv)
    maybe_init_distributed(args)
    cfg = resolve_config(args, default_preset="kitti_infer")

    if args.dataset == "sceneflow":
        from ecm_torch.data.sceneflow import list_sceneflow, load_sample

        _, specs = list_sceneflow(args.datapath)
    elif args.dataset == "middlebury":
        from ecm_torch.data.middlebury import list_middlebury, load_sample

        specs, _ = list_middlebury(args.datapath)
    else:
        from ecm_torch.data.kitti import list_kitti, load_sample

        year = 2015 if args.dataset.endswith("15") else 2012
        _, specs = list_kitti(args.datapath, year=year)
    if args.limit:
        specs = specs[: args.limit]
    if not specs:
        raise FileNotFoundError(f"no eval samples under {args.datapath!r}")

    mesh = eval_mesh(cfg)
    if mesh is not None:
        say(f"disp-sharded eval mesh: data {mesh.data}, disp {mesh.disp}")
    state, _ = restore(build_state(cfg, args.device, 0), args.loadmodel)
    device = next(state.model.parameters()).device
    eval_step = make_eval_step(state.model, cfg.model.max_disp)

    all_m = []
    with use_mesh(mesh):
        for batch in make_eval_iterator(specs, load_sample, batch_size=1):
            _, m = eval_step(state, to_device(batch, device))
            all_m.append({k: float(v) for k, v in m.items()})
    agg = {k: float(np.mean([m[k] for m in all_m])) for k in all_m[0] if k != "valid_px"}
    agg["num_pairs"] = len(all_m)
    say(json.dumps(agg))
    shutdown_distributed()


if __name__ == "__main__":
    main()
