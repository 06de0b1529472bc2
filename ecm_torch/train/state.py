"""Train state and optimizer (port of ``ecm_tpu/train/state.py``).

The optimizer is optax's chain as the JAX package builds it: optional
``clip_by_global_norm``, then Adam (b1 0.9, b2 0.999, eps 1e-8; torch's Adam
computes the same update) with optax's ``piecewise_constant_schedule``. That
schedule is built with scales ``new_lr / lr`` and optax multiplies the scales
of every boundary passed, so two drops compound: ``lr * prod(v / lr)`` over
the boundaries ``b <= step``. The port keeps that on purpose.

A train step on the card is one CUDA graph (``train/graphs.py``), which
reads every tensor by the address it had at capture and bakes every Python
number into its kernels' arguments. So the optimizer keeps its varying
state on the device, at fixed addresses: the schedule's learning rate is a
0-d tensor that :meth:`Optimizer.set_lr` writes before each step (a replay
reads the value of its own step), and Adam, built with ``capturable=True``,
keeps each parameter's step count on the device and advances it there. Its
state is made when the optimizer is, so that its addresses do not move at
the first step. ``Optimizer.count``, which drives the schedule and the
checkpoint, stays the host's int. On the CPU (no graph) Adam runs as torch
runs it there, with the learning rate a float64 tensor that it reads as the
float itself.
"""

from __future__ import annotations

import dataclasses
import functools
from collections.abc import Iterable

import torch
from torch import nn


class Optimizer:
    """``optax.chain(clip_by_global_norm(clip_norm), adam(schedule))`` over
    ``params``. :meth:`update` reads each parameter's ``.grad``; :meth:`step`
    is one whole step: :meth:`set_lr`, :meth:`update`, ``count += 1``."""

    def __init__(
        self,
        params: Iterable[nn.Parameter],
        lr: float = 1e-3,
        boundaries_and_lrs: list[tuple[int, float]] | None = None,
        clip_norm: float | None = None,
    ):
        self.params = [p for p in params if p.requires_grad]
        device = self.params[0].device
        capturable = device.type == "cuda"  # torch refuses capturable=True on the CPU
        dtype = torch.float32 if capturable else torch.float64
        self.adam = torch.optim.Adam(
            self.params, lr=torch.tensor(lr, dtype=dtype, device=device), betas=(0.9, 0.999), eps=1e-8,
            capturable=capturable,
        )
        # an eager step on the card is as right as a captured one; torch
        # warns once an instance that its capturable step runs uncaptured
        self.adam._warned_capturable_if_run_uncaptured = True
        self._init_state()
        self.lr = lr
        self.scales = sorted((b, v / lr) for b, v in boundaries_and_lrs or ())
        self.clip_norm = clip_norm
        self.count = 0

    def _init_state(self) -> None:
        """Adam's state of each parameter that has none, made as Adam makes
        it at its first step: the step count (on the device where capturable)
        and zero moments."""
        capturable = self.adam.param_groups[0]["capturable"]
        for p in self.params:
            if not self.adam.state[p]:
                self.adam.state[p] = {
                    "step": torch.zeros((), dtype=torch.float32, device=p.device if capturable else "cpu"),
                    "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                    "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
                }

    @property
    def lr_tensor(self) -> torch.Tensor:
        """The 0-d tensor Adam reads the learning rate from."""
        return self.adam.param_groups[0]["lr"]

    def lr_at(self, count: int) -> float:
        """optax's piecewise-constant schedule: every scale whose boundary
        ``count`` has reached multiplies in."""
        lr = self.lr
        for boundary, scale in self.scales:
            if count >= boundary:
                lr = lr * scale
        return lr

    def set_lr(self) -> None:
        """Write the schedule's learning rate at ``count`` into
        :attr:`lr_tensor` (a fill: no host read)."""
        self.lr_tensor.fill_(self.lr_at(self.count))

    def tensors(self) -> list[torch.Tensor]:
        """What a step reads and writes by address besides the parameters
        and their gradients: the learning rate and Adam's state."""
        return [self.lr_tensor, *(t for p in self.params for t in self.adam.state[p].values())]

    @torch.no_grad()
    def clip(self) -> None:
        """optax's ``clip_by_global_norm``: each gradient becomes
        ``g / norm * clip_norm`` when the global norm reaches ``clip_norm``
        (on the device: no host read)."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
        keep = norm < self.clip_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * self.clip_norm))

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def update(self) -> None:
        """Clip and apply the gradients at the learning rate in
        :attr:`lr_tensor`: the device work of a step, which a CUDA graph
        captures."""
        if self.clip_norm:
            self.clip()
        self.adam.step()

    def step(self) -> None:
        self.set_lr()
        self.update()
        self.count += 1

    def state_dict(self) -> dict:
        """Adam's state in the form a CPU optimizer writes, wherever this one
        runs: each step count a host tensor, each group's learning rate a
        float, ``capturable`` off."""
        sd = self.adam.state_dict()
        sd["state"] = {i: dict(s, step=s["step"].cpu()) for i, s in sd["state"].items()}
        for group in sd["param_groups"]:
            group.update(lr=float(group["lr"]), capturable=False)
        return sd

    def load_state_dict(self, sd: dict) -> None:
        """Adam's state from ``sd`` (either device's form). The moments and
        step counts are new tensors, at new addresses; the learning-rate
        tensor, ``capturable`` and the other settings stay this optimizer's
        (torch would take the file's)."""
        ours = self.adam.param_groups
        groups = [dict(g, params=saved["params"]) for g, saved in zip(ours, sd["param_groups"], strict=True)]
        lrs = [g["lr"] for g in ours]
        self.adam.load_state_dict(dict(sd, param_groups=groups))
        for g, lr in zip(self.adam.param_groups, lrs):
            g["lr"] = lr  # torch loads a copy of each group
        self._init_state()


def make_optimizer(
    lr: float = 1e-3,
    boundaries_and_lrs: list[tuple[int, float]] | None = None,
    clip_norm: float | None = None,
):
    """A factory ``params -> Optimizer``: Adam with the step-boundary LR
    schedule and optional global-norm clipping (``create_train_state``
    applies it to the model's parameters, as optax's init is applied to the
    params in JAX)."""
    return functools.partial(
        Optimizer, lr=lr, boundaries_and_lrs=boundaries_and_lrs, clip_norm=clip_norm
    )


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics), its optimizer, and
    the number of steps taken."""

    model: nn.Module
    optimizer: Optimizer
    step: int = 0


def create_train_state(model: nn.Module, tx=None) -> TrainState:
    """A train state at step 0 for ``model`` (already initialised, e.g. by
    ``build_model``); ``tx`` is a :func:`make_optimizer` factory (default:
    Adam at 1e-3)."""
    tx = tx if tx is not None else make_optimizer()
    return TrainState(model=model, optimizer=tx(model.parameters()))
