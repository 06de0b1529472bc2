"""Checkpoints and resume (port of ``ecm_tpu/train/checkpoint.py``), with
``torch.save`` files where the JAX package keeps orbax directories.

A checkpoint holds the full train state: the model's ``state_dict``
(parameters and BatchNorm buffers), the Adam state, the optimizer's step
count (which drives the learning-rate schedule) and the train step. It is
written to a temporary name and renamed into place, so a crash during a
save never leaves a corrupt newest checkpoint; the newest ``keep`` are kept.
An ``ecm_tpu`` checkpoint does not load here: it crosses only through
``ecm_torch.weights.from_flax``.

In data-parallel training every rank holds the same state: rank 0 writes
(``train_loop``) and every rank restores. The state is the model's own
``state_dict``, never a ``DistributedDataParallel`` wrapper's (no
``module.`` prefix), so a checkpoint moves freely between one process and
several.
"""

from __future__ import annotations

import os
import re

import torch

from ecm_torch.train.state import TrainState

_NAME = re.compile(r"^(\d+)\.pt$")


class CheckpointManager:
    """The checkpoints of one directory, one file ``<step>.pt`` a step."""

    def __init__(self, directory: str, keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def all_steps(self) -> list[int]:
        """The saved steps, oldest first (temporary files are not steps)."""
        return sorted(int(m.group(1)) for n in os.listdir(self.directory) if (m := _NAME.match(n)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None


def make_manager(directory: str, keep: int = 5) -> CheckpointManager:
    return CheckpointManager(directory, keep)


def save(manager: CheckpointManager, step: int, state: TrainState) -> None:
    """Write ``state`` as step ``step``, then drop all but the newest
    ``manager.keep``."""
    blob = {
        "model": state.model.state_dict(),
        "adam": state.optimizer.adam.state_dict(),
        "count": state.optimizer.count,
        "step": state.step,
    }
    final = manager.path(step)
    tmp = f"{final}.tmp{os.getpid()}"
    torch.save(blob, tmp)
    os.replace(tmp, final)
    for old in manager.all_steps()[: -manager.keep]:
        os.remove(manager.path(old))


def restore_latest(manager: CheckpointManager, template: TrainState) -> tuple[TrainState, int]:
    """Load the newest checkpoint into ``template`` (in place), onto the
    device of its model. Returns (state, step); (template, 0) if there is
    none."""
    step = manager.latest_step()
    if step is None:
        return template, 0
    device = next(template.model.parameters()).device
    blob = torch.load(manager.path(step), map_location=device, weights_only=True)
    template.model.load_state_dict(blob["model"])
    template.optimizer.adam.load_state_dict(blob["adam"])
    template.optimizer.count = blob["count"]
    template.step = blob["step"]
    return template, step


def wait(manager: CheckpointManager) -> None:
    """Saves are synchronous: nothing to wait for (orbax's are not)."""
