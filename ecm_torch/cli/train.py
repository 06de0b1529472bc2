"""SceneFlow trainer (port of ``ecm_tpu/cli/train.py``, the reference's
``main.py``). Resumes from the newest checkpoint in ``--savemodel``, or
starts from ``--loadmodel``'s.

    python -m ecm_torch.cli.train --datapath /data/sceneflow --steps 20000 \\
        --maxdisp 192 --savemodel ./ckpt
    python -m ecm_torch.cli.train --config overfit_gate     # synthetic gate
    python -m torch.distributed.run --nproc_per_node 8 -m ecm_torch.cli.train \\
        --multihost --config sceneflow_dp --datapath /data/sceneflow   # 8 cards
    python -m torch.distributed.run --nproc_per_node 8 -m ecm_torch.cli.train \\
        --multihost --mesh-disp 2 --config sceneflow_dp ...   # a (4, 2) grid
"""

from __future__ import annotations

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
from ecm_torch.train.loop import train_loop
from ecm_torch.train.state import make_optimizer
from ecm_torch.train.steps import make_train_step


def main(argv: list[str] | None = None) -> None:
    args = base_parser("ecm_torch SceneFlow training (reference main.py)").parse_args(argv)
    maybe_init_distributed(args)
    cfg = resolve_config(args, default_preset="sceneflow_single")
    mesh = make_mesh_from(cfg)

    tx = make_optimizer(cfg.train.lr, list(cfg.train.lr_drops) or None)
    state = build_state(cfg, args.device, cfg.data.seed, tx)

    manager = ckpt_lib.make_manager(cfg.train.ckpt_dir)
    if args.loadmodel:
        state, step0 = ckpt_lib.restore_latest(ckpt_lib.make_manager(args.loadmodel), state)
        say(f"restored checkpoint at step {step0} from {args.loadmodel}")
    else:
        state, step0 = ckpt_lib.restore_latest(manager, state)
        if step0:
            say(f"auto-resumed from step {step0}")

    data_iter, n_samples = make_data_iter(cfg, mesh)
    num_steps = steps_from_epochs(cfg, n_samples)
    state = train_loop(
        state,
        make_train_step(state.model, cfg.model.max_disp, mesh),
        data_iter,
        num_steps=num_steps,
        mesh=mesh,
        log_every=cfg.train.log_every,
        ckpt_manager=manager,
        ckpt_every=cfg.train.ckpt_every,
        metrics_path=f"{cfg.train.ckpt_dir}/metrics.jsonl",
        tensorboard_dir=args.tensorboard,
    )
    say(f"done at step {state.step}")
    shutdown_distributed()


if __name__ == "__main__":
    main()
