"""Shared plumbing of the command-line drivers (port of
``ecm_tpu/cli/common.py``): the reference's flags (``--maxdisp``,
``--model``, ``--datapath``, ``--loadmodel``, ``--savemodel``, ``--seed``),
preset resolution and the train-data iterator.

Intended differences from the JAX package:
- ``--device`` (default ``cuda``, which raises without a GPU) lets a caller
  run on the CPU;
- ``--model raft_stereo`` and ``--model igev_stereo`` (the port's own;
  ``ecm_tpu`` has neither) serve RAFT-Stereo and IGEV-Stereo at their
  published sizes, float16 unless ``--no-bf16``; the ECM flags do not reach
  them, and they have no training step;
- ``--pallas`` keeps its name and selects the CUDA cost-volume kernel, as
  ``ModelConfig.use_pallas`` does in the port;
- ``--debug-nans`` turns on ``torch.autograd``'s anomaly detection;
- ``--multihost`` joins the process group of ``torch.distributed.run``
  (one process a card, ``cuda:LOCAL_RANK``, or the CPU with ``--device
  cpu``); ``--dist-backend`` (NCCL on CUDA, gloo on the CPU by default) and
  ``--dist-timeout`` are the port's own. The data axis is every rank of the
  group (``mesh_data`` None; another size raises, where ``ecm_tpu`` may
  take a subset of its devices). Only rank 0 prints and writes files;
  ``evaluate``, ``submission`` and ``test_img`` take the whole set on every
  rank, as ``ecm_tpu``'s do;
- ``--mesh-disp N`` above 1 shards the disparities over N ranks
  (``ecm_torch.parallel.halo``); with ``--dist-backend gloo`` ranks may
  share one card. ``evaluate`` and ``submission`` (the
  ``middlebury_disp_sharded`` preset) need ``--multihost`` with N ranks,
  every rank reads the same pair, rank 0 prints and writes. ``train`` and
  ``finetune`` run on a ``(data, disp)`` grid of the ranks of
  ``--multihost``: the ranks of one disp group draw the same pairs;
- no compile-cache settings: the kernel build cache in ``build/`` is their
  counterpart.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch
import torch.distributed as dist

from ecm_torch.configs import CONFIGS, ExperimentConfig
from ecm_torch.parallel.sharding import grid_shape, init_from_env, is_main_process, make_mesh


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", default=None, help="named preset from ecm_torch.configs")
    p.add_argument("--maxdisp", type=int, default=192)
    p.add_argument("--model", default="stackhourglass", choices=["stackhourglass", "basic", "raft_stereo", "igev_stereo"],
                   help="raft_stereo, igev_stereo: RAFT-Stereo, IGEV-Stereo at their published sizes, serving only "
                        "(test_img, submission)")
    p.add_argument("--datapath", default="")
    p.add_argument("--epochs", type=int, default=None, help="epochs (converted to steps)")
    p.add_argument("--steps", type=int, default=None, help="train steps (overrides epochs)")
    p.add_argument("--batch", type=int, default=None, help="global batch size")
    p.add_argument("--loadmodel", default=None, help="checkpoint dir to restore")
    p.add_argument("--savemodel", default="checkpoints", help="checkpoint dir")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--no-bf16", action="store_true", help="compute in f32")
    p.add_argument("--pallas", action="store_true", help="use the CUDA cost-volume kernel")
    p.add_argument(
        "--regress-mode",
        default=None,
        choices=["auto", "fullres", "fused", "lowres"],
        help="disparity regression path (auto = the fused CUDA kernel on a GPU at eval)",
    )
    p.add_argument(
        "--agg-layout",
        default=None,
        choices=["auto", "standard", "grouped"],
        help="aggregation dispatch (auto = grouped layer kernels on a GPU)",
    )
    p.add_argument(
        "--agg-fused",
        default=None,
        choices=["off", "auto", "on"],
        help="standard-layout fused CUDA conv pairs (eval only)",
    )
    p.add_argument(
        "--mesh-disp", type=int, default=None,
        help="disp-axis mesh size: with --multihost, the disparities split over that many ranks",
    )
    p.add_argument("--multihost", action="store_true", help="join torch.distributed.run's process group")
    p.add_argument(
        "--dist-backend",
        default=None,
        choices=["nccl", "gloo"],
        help="with --multihost (default: nccl on CUDA, one rank a card; gloo on the CPU)",
    )
    p.add_argument(
        "--dist-timeout", type=float, default=600.0, help="with --multihost: seconds before a collective fails"
    )
    p.add_argument(
        "--debug-nans",
        action="store_true",
        help="torch.autograd anomaly detection: fail fast on NaN",
    )
    p.add_argument("--tensorboard", default=None, help="TensorBoard logdir")
    p.add_argument("--device", default=None, help="device to run on (default: cuda; raises without a GPU)")
    return p


def resolve_config(args, default_preset: str) -> ExperimentConfig:
    cfg = CONFIGS[args.config or default_preset]
    model = dataclasses.replace(
        cfg.model,
        name=args.model,
        max_disp=args.maxdisp,
        bf16=cfg.model.bf16 and not args.no_bf16,
        use_pallas=args.pallas or cfg.model.use_pallas,
        regress_mode=args.regress_mode or cfg.model.regress_mode,
        agg_layout=args.agg_layout or cfg.model.agg_layout,
        agg_fused=args.agg_fused or cfg.model.agg_fused,
    )
    data = dataclasses.replace(
        cfg.data,
        datapath=args.datapath or cfg.data.datapath,
        global_batch=args.batch or cfg.data.global_batch,
        seed=args.seed,
    )
    train = cfg.train
    if args.steps is not None:
        train = dataclasses.replace(train, num_steps=args.steps)
    elif args.epochs is not None:
        # resolved to steps once the dataset is listed (train CLIs call
        # steps_from_epochs with the sample count make_data_iter returns)
        train = dataclasses.replace(train, epochs=args.epochs)
    if args.lr is not None:
        train = dataclasses.replace(train, lr=args.lr)
    if args.mesh_disp is not None:
        train = dataclasses.replace(train, mesh_disp=args.mesh_disp)
    train = dataclasses.replace(train, ckpt_dir=args.savemodel)
    return ExperimentConfig(model=model, data=data, train=train)


def maybe_init_distributed(args) -> None:
    """``--multihost``: join the process group and set ``args.device`` to
    this rank's device."""
    if getattr(args, "multihost", False):
        args.device = init_from_env(args.device, args.dist_backend, args.dist_timeout)
    if getattr(args, "debug_nans", False):
        torch.autograd.set_detect_anomaly(True)


def shutdown_distributed() -> None:
    """Leave the process group, if the process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def say(*a) -> None:
    """``print`` on rank 0 only."""
    if is_main_process():
        print(*a, flush=True)


def make_mesh_from(cfg: ExperimentConfig):
    """The training mesh (``ecm_tpu/cli/common.py:110-120``): None for one
    process with ``mesh_disp <= 1`` (the JAX package's answer on one
    device); else ``make_mesh(data=mesh_data, disp=mesh_disp)`` over the
    ranks of ``--multihost``, which prints it. A grid that is not the whole
    group raises ``ValueError``, with one process too."""
    disp = max(cfg.train.mesh_disp, 1)
    if not dist.is_initialized():
        grid_shape(1, cfg.train.mesh_data, disp)
        return None
    mesh = make_mesh(data=cfg.train.mesh_data, disp=disp)
    say(f"training mesh: data {mesh.data}, disp {mesh.disp}")
    return mesh


def eval_mesh(cfg: ExperimentConfig):
    """The disparity-sharded eval mesh (BASELINE config 4, Middlebury
    high-res): ``make_mesh(data=1, disp=mesh_disp)`` over the ranks of
    ``--multihost``, which must be ``mesh_disp`` of them (eval runs batch 1,
    so the whole group goes to the disparity axis); None for ``mesh_disp <=
    1``."""
    disp = cfg.train.mesh_disp
    if disp <= 1:
        return None
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != disp:
        raise ValueError(f"--mesh-disp {disp} needs --multihost with {disp} ranks, have {world}")
    return make_mesh(data=1, disp=disp)


def make_data_iter(cfg: ExperimentConfig, mesh=None):
    """The train-data iterator of ``cfg.data.dataset``: this rank's rows of
    each global batch, by ``mesh``'s data axis (the ranks of one disp group
    draw the same pairs and crops).

    Returns ``(iterator, n_samples)``; ``n_samples`` is None for unbounded
    synthetic streams (used by ``steps_from_epochs``).
    """
    from ecm_torch.data.pipeline import PipelineConfig, make_synthetic_pipeline

    pcfg = PipelineConfig(
        batch_size=cfg.data.global_batch,
        crop=cfg.data.crop,
        seed=cfg.data.seed,
        num_workers=cfg.data.workers,
    )
    ds = cfg.data.dataset
    if ds == "synthetic":
        h, w = cfg.data.crop
        it = make_synthetic_pipeline(
            pcfg,
            h=h,
            w=w,
            max_disp=min(cfg.model.max_disp * 0.8, 40.0),
            distinct=cfg.data.synthetic_distinct,
            mesh=mesh,
        )
        return it, None
    from ecm_torch.data.pipeline import make_train_pipeline

    if ds == "sceneflow":
        from ecm_torch.data.sceneflow import list_sceneflow, load_sample

        train, _ = list_sceneflow(cfg.data.datapath)
        if not train:
            raise FileNotFoundError(f"no SceneFlow samples under {cfg.data.datapath!r}")
        return make_train_pipeline(train, load_sample, pcfg, mesh), len(train)
    if ds in ("kitti2015", "kitti2012"):
        from ecm_torch.data.kitti import list_kitti, load_sample

        year = 2015 if ds.endswith("15") else 2012
        train, _ = list_kitti(cfg.data.datapath, year=year)
        if not train:
            raise FileNotFoundError(f"no KITTI samples under {cfg.data.datapath!r}")
        return make_train_pipeline(train, load_sample, pcfg, mesh), len(train)
    if ds == "middlebury":
        from ecm_torch.data.middlebury import list_middlebury, load_sample

        train, _ = list_middlebury(cfg.data.datapath)
        if not train:
            raise FileNotFoundError(f"no Middlebury scenes under {cfg.data.datapath!r}")
        return make_train_pipeline(train, load_sample, pcfg, mesh), len(train)
    raise ValueError(f"unknown dataset {ds!r}")


def steps_from_epochs(cfg: ExperimentConfig, n_samples: int | None) -> int:
    """The step budget: ``num_steps`` unless ``--epochs`` was given, then
    epochs * floor(dataset / global_batch) (the reference's epoch loop over
    a drop-last DataLoader)."""
    if cfg.train.epochs is None:
        return cfg.train.num_steps
    if n_samples is None:
        raise ValueError(
            "--epochs needs a finite dataset; synthetic streams are unbounded "
            "— use --steps instead"
        )
    steps_per_epoch = max(1, n_samples // cfg.data.global_batch)
    return cfg.train.epochs * steps_per_epoch


def build_state(cfg: ExperimentConfig, device: str | None, seed: int, tx=None):
    """The model of ``cfg`` on ``device`` (None: cuda), initialised from
    ``seed``, in a train state with optimizer ``tx`` (default Adam)."""
    from ecm_torch.train.state import create_train_state

    model = cfg.model.build(device=device, generator=torch.Generator().manual_seed(seed))
    return create_train_state(model, tx)


def restore(state, loadmodel: str | None):
    """``state`` with the newest checkpoint of ``loadmodel`` loaded (as is
    without one), and its step."""
    from ecm_torch.train import checkpoint as ckpt_lib

    if not loadmodel:
        return state, 0
    state, step0 = ckpt_lib.restore_latest(ckpt_lib.make_manager(loadmodel), state)
    say(f"loaded checkpoint step {step0}")
    return state, step0
