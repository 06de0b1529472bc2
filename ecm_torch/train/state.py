"""Train state and optimizer (port of ``ecm_tpu/train/state.py``).

The optimizer is optax's chain as the JAX package builds it: optional
``clip_by_global_norm``, then Adam (b1 0.9, b2 0.999, eps 1e-8; torch's Adam
computes the same update) with optax's ``piecewise_constant_schedule``. That
schedule is built with scales ``new_lr / lr`` and optax multiplies the scales
of every boundary passed, so two drops compound: ``lr * prod(v / lr)`` over
the boundaries ``b <= step``. The port keeps that on purpose.
"""

from __future__ import annotations

import dataclasses
import functools
from collections.abc import Iterable

import torch
from torch import nn


class Optimizer:
    """``optax.chain(clip_by_global_norm(clip_norm), adam(schedule))`` over
    ``params``. :meth:`step` reads each parameter's ``.grad``."""

    def __init__(
        self,
        params: Iterable[nn.Parameter],
        lr: float = 1e-3,
        boundaries_and_lrs: list[tuple[int, float]] | None = None,
        clip_norm: float | None = None,
    ):
        self.params = [p for p in params if p.requires_grad]
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        self.lr = lr
        self.scales = sorted((b, v / lr) for b, v in boundaries_and_lrs or ())
        self.clip_norm = clip_norm
        self.count = 0

    def lr_at(self, count: int) -> float:
        """optax's piecewise-constant schedule: every scale whose boundary
        ``count`` has reached multiplies in."""
        lr = self.lr
        for boundary, scale in self.scales:
            if count >= boundary:
                lr = lr * scale
        return lr

    @torch.no_grad()
    def clip(self) -> None:
        """optax's ``clip_by_global_norm``: each gradient becomes
        ``g / norm * clip_norm`` when the global norm reaches ``clip_norm``."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
        keep = norm < self.clip_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * self.clip_norm))

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.clip_norm:
            self.clip()
        for group in self.adam.param_groups:
            group["lr"] = self.lr_at(self.count)
        self.adam.step()
        self.count += 1


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
