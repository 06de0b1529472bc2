"""KITTI fine-tuner (port of ``ecm_tpu/cli/finetune.py``, the reference's
``finetune.py``): takes a SceneFlow checkpoint's weights and BatchNorm
statistics (a fresh optimizer, step 0), trains on KITTI 2012/2015 crops
with the preset's learning-rate drop, and reports EPE, D1-all and the 3-px
rate on the validation split at each eval.

    python -m ecm_torch.cli.finetune --datapath /data/kitti2015 \\
        --datatype 2015 --loadmodel ./ckpt_sceneflow --savemodel ./ckpt_kitti
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ecm_torch.cli.common import (
    base_parser,
    build_state,
    make_data_iter,
    make_mesh_from,
    maybe_init_distributed,
    resolve_config,
    say,
    shutdown_distributed,
    steps_from_epochs,
)
from ecm_torch.train import checkpoint as ckpt_lib
from ecm_torch.train.loop import to_device, train_loop
from ecm_torch.train.state import create_train_state, make_optimizer
from ecm_torch.train.steps import make_eval_step, make_train_step


def main(argv: list[str] | None = None) -> None:
    parser = base_parser("ecm_torch KITTI fine-tune (reference finetune.py)")
    parser.add_argument("--datatype", default="2015", choices=["2012", "2015"])
    args = parser.parse_args(argv)
    maybe_init_distributed(args)
    cfg = resolve_config(args, default_preset="kitti_finetune")
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, dataset=f"kitti{args.datatype}")
    )
    mesh = make_mesh_from(cfg)

    tx = make_optimizer(cfg.train.lr, list(cfg.train.lr_drops) or None)
    state = build_state(cfg, args.device, cfg.data.seed, tx)
    if args.loadmodel:  # SceneFlow-pretrained weights (reference --loadmodel)
        loaded, step0 = ckpt_lib.restore_latest(ckpt_lib.make_manager(args.loadmodel), state)
        # weights + BN stats only; a fresh optimizer and step for the fine-tune
        state = create_train_state(loaded.model, tx)
        say(f"loaded pretrained weights (step {step0}) from {args.loadmodel}")

    manager = ckpt_lib.make_manager(cfg.train.ckpt_dir)

    # validation eval: 3-px error / D1-all on the held-out split, the whole
    # split on every rank
    from ecm_torch.data.kitti import list_kitti, load_sample
    from ecm_torch.data.pipeline import make_eval_iterator

    year = 2015 if args.datatype == "2015" else 2012
    _, val_specs = list_kitti(cfg.data.datapath, year=year)
    model = state.model
    device = next(model.parameters()).device
    eval_step = make_eval_step(model, cfg.model.max_disp)

    def eval_fn(state, step):
        ms = []
        for batch in make_eval_iterator(val_specs, load_sample, batch_size=1):
            _, m = eval_step(state, to_device(batch, device))
            ms.append({k: float(v) for k, v in m.items()})
        if not ms:
            return {}
        return {
            k: float(np.mean([m[k] for m in ms])) for k in ("epe", "d1_all", "px3")
        }

    data_iter, n_samples = make_data_iter(cfg, mesh)
    num_steps = steps_from_epochs(cfg, n_samples)
    state = train_loop(
        state,
        make_train_step(model, cfg.model.max_disp, mesh),
        data_iter,
        num_steps=num_steps,
        mesh=mesh,
        log_every=cfg.train.log_every,
        ckpt_manager=manager,
        ckpt_every=cfg.train.ckpt_every,
        metrics_path=f"{cfg.train.ckpt_dir}/metrics.jsonl",
        tensorboard_dir=args.tensorboard,
        eval_fn=eval_fn if val_specs else None,
        eval_every=cfg.train.eval_every or cfg.train.ckpt_every,
    )
    say(f"done at step {state.step}")
    shutdown_distributed()


if __name__ == "__main__":
    main()
