"""The graphed train step against the eager one at the bf16 convergence
gate's configuration, and the card's Adam against torch's host-side Adam,
on one card.

    python3 scripts/train_gate_graphs.py [--steps 6]

1. ``overfit_gate_grouped`` as ``ecm_torch.cli.train`` resolves it (max-disp
   192 from ``--maxdisp``'s default, bf16, ``remat``, the grouped dispatch)
   on one seeded synthetic batch of 2 x 128x256: ``--steps`` steps of a
   graphed ``make_train_step`` and of two eager ones (``graphed=False``),
   each from the seed-0 weights, with ``torch.backends.cudnn.deterministic``
   off and then on. Prints each step's loss difference and the largest
   parameter difference, graphed against eager and eager against eager.
2. The port's optimizer on the card (``train/state.py``: ``capturable=True``,
   the learning rate an f32 device tensor) against ``torch.optim.Adam`` with
   a float learning rate (the host-side step size of the optimizer before
   its steps were captured) over the same seeded gradients of that model's
   parameters for ``--steps`` steps: the largest parameter difference and
   how many elements differ.

Prints one JSON line per part. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ecm_torch.cli import common as cli_common  # noqa: E402
from ecm_torch.data import make_batch  # noqa: E402
from ecm_torch.train.loop import to_device  # noqa: E402
from ecm_torch.train.state import create_train_state, make_optimizer  # noqa: E402
from ecm_torch.train.steps import make_train_step  # noqa: E402

PRESET = "overfit_gate_grouped"


def steps_three_ways(cfg, batch: dict, steps: int) -> dict:
    """Losses and final parameters of a graphed run and two eager runs."""
    runs = {}
    for name in ("graphed", "eager", "eager_again"):
        model = cfg.model.build(generator=torch.Generator().manual_seed(0))
        state = create_train_state(model, make_optimizer(cfg.train.lr))
        step = make_train_step(model, cfg.model.max_disp, graphed=name == "graphed")
        losses = [step(state, batch)[1]["loss"].item() for _ in range(steps)]
        runs[name] = (losses, {n: p.detach().clone() for n, p in model.named_parameters()})
    out = {}
    for a, b in (("graphed", "eager"), ("graphed", "eager_again"), ("eager", "eager_again")):
        (la, pa), (lb, pb) = runs[a], runs[b]
        out[f"{a}_vs_{b}"] = dict(
            loss_diffs=[abs(x - y) for x, y in zip(la, lb)],
            max_param_diff=max((pa[n].float() - pb[n].float()).abs().max().item() for n in pa),
        )
    return out


def adam_against_host_adam(cfg, steps: int) -> dict:
    """The port's capturable Adam against torch's with a float learning rate
    on the same parameters and gradients."""
    params = [p.detach().clone() for p in cfg.model.build(generator=torch.Generator().manual_seed(0)).parameters()]
    ours = [torch.nn.Parameter(p.clone()) for p in params]
    host = [torch.nn.Parameter(p.clone()) for p in params]
    opt = make_optimizer(cfg.train.lr)(ours)
    ref = torch.optim.Adam(host, lr=cfg.train.lr, betas=(0.9, 0.999), eps=1e-8)
    gen = torch.Generator(device=params[0].device).manual_seed(1)
    for _ in range(steps):
        for a, b in zip(ours, host):
            a.grad = torch.randn(a.shape, generator=gen, device=a.device) * 1e-2
            b.grad = a.grad.clone()
        opt.step()
        ref.step()
    diffs = [(a.detach() - b.detach()).abs() for a, b in zip(ours, host)]
    return dict(
        capturable=opt.adam.param_groups[0]["capturable"], lr_dtype=str(opt.lr_tensor.dtype),
        max_param_diff=max(d.max().item() for d in diffs),
        elements_differing=sum(int((d > 0).sum()) for d in diffs), elements=sum(d.numel() for d in diffs),
    )


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=6)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("train_gate_graphs: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cli_common.resolve_config(cli_common.base_parser("").parse_args(["--config", PRESET]), PRESET)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    batch = to_device(make_batch(3, cfg.data.global_batch, *cfg.data.crop), torch.device("cuda"))
    for deterministic in (False, True):
        torch.backends.cudnn.deterministic = deterministic
        result = steps_three_ways(cfg, batch, args.steps)
        print(json.dumps(dict(part="steps", preset=PRESET, max_disp=cfg.model.max_disp, bf16=cfg.model.bf16,
                              remat=cfg.model.remat, deterministic=deterministic, card=card, **result)), flush=True)
    torch.backends.cudnn.deterministic = False
    print(json.dumps(dict(part="adam", steps=args.steps, card=card, **adam_against_host_adam(cfg, args.steps))),
          flush=True)


if __name__ == "__main__":
    main()
