"""Training loop (port of ``ecm_tpu/train/loop.py``): steps over a batch
iterator, metrics to stdout, JSONL and TensorBoard every ``log_every`` steps
with the JAX package's log line, a checkpoint every ``ckpt_every`` steps and
one at the end, resuming from ``state.step``.

With a ``mesh`` (data-parallel ranks, each stepping on its rows of the
global batch) the pair count is the global batch's, and only rank 0 prints
and writes the JSONL, TensorBoard and checkpoint files.
"""

from __future__ import annotations

import json
import time
from collections.abc import Iterator
from typing import Callable

import numpy as np
import torch

from ecm_torch.train import checkpoint as ckpt_lib
from ecm_torch.train.state import TrainState
from ecm_torch.utils.profiling import span

BATCH_KEYS = ("left", "right", "disparity")


def to_device(batch: dict[str, np.ndarray], device: torch.device) -> dict[str, torch.Tensor]:
    """The model's inputs of a numpy batch, as f32 tensors on ``device``
    (an ``ecm.loop.to_device`` span). To the card each is a copy from
    pageable memory, which waits for the work queued before it."""
    with span("ecm.loop.to_device"):
        return {k: torch.from_numpy(np.asarray(batch[k], np.float32)).to(device) for k in BATCH_KEYS}


def _save(manager, step: int, state: TrainState, mesh) -> None:
    """A checkpoint of ``state`` at ``step``: with a mesh, rank 0 writes it
    and every rank returns once it is in place."""
    if mesh is None or mesh.rank == 0:
        ckpt_lib.save(manager, step, state)
    if mesh is not None:
        mesh.barrier()


def train_loop(
    state: TrainState,
    train_step: Callable,
    data_iter: Iterator[dict[str, np.ndarray]],
    num_steps: int,
    mesh=None,
    log_every: int = 20,
    ckpt_manager=None,
    ckpt_every: int = 1000,
    metrics_path: str | None = None,
    eval_fn: Callable[[TrainState, int], dict] | None = None,
    eval_every: int = 0,
    tensorboard_dir: str | None = None,
) -> TrainState:
    """Run steps ``state.step .. num_steps - 1``; batches go to the model's
    device. With ``ckpt_manager``: a checkpoint every ``ckpt_every`` steps
    and one at ``num_steps``, each step number saved once. ``mesh``: the
    ``ecm_torch.parallel.Mesh`` that ``train_step`` steps over. Returns the
    state."""
    device = next(state.model.parameters()).device
    ranks, main = (1, True) if mesh is None else (mesh.data, mesh.rank == 0)
    # the steps saved, listed before any rank can write: every rank then
    # takes the same decision at the end
    saved = set(ckpt_manager.all_steps()) if ckpt_manager is not None else set()
    log_f = open(metrics_path, "a") if metrics_path and main else None
    tb = None
    if tensorboard_dir and main:
        from ecm_torch.train.writers import MetricWriter

        tb = MetricWriter(logdir=tensorboard_dir)
    t0 = time.perf_counter()
    window_images = 0
    try:
        for step in range(state.step, num_steps):
            batch = to_device(next(data_iter), device)
            state, metrics = train_step(state, batch)
            window_images += batch["left"].shape[0] * ranks
            if main and ((step + 1) % log_every == 0 or step + 1 == num_steps):
                m = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                m.update(
                    step=step + 1,
                    pairs_per_s=window_images / max(dt, 1e-9),
                    step_time_ms=1e3 * dt / log_every,
                )
                print(
                    f"step {step + 1}/{num_steps} loss={m['loss']:.4f} "
                    f"epe={m['epe']:.3f} d1={m['d1_all']:.4f} "
                    f"{m['pairs_per_s']:.2f} pairs/s",
                    flush=True,
                )
                if log_f:
                    log_f.write(json.dumps(m) + "\n")
                    log_f.flush()
                if tb is not None:
                    tb.write(step + 1, m)
                t0 = time.perf_counter()
                window_images = 0
            if ckpt_manager is not None and (step + 1) % ckpt_every == 0:
                _save(ckpt_manager, step + 1, state, mesh)
                saved.add(step + 1)
            if eval_fn is not None and eval_every and (step + 1) % eval_every == 0:
                eval_metrics = eval_fn(state, step + 1)
                if main:
                    print(f"eval @ {step + 1}: {eval_metrics}", flush=True)
                if log_f:
                    log_f.write(json.dumps({"step": step + 1, "eval": eval_metrics}) + "\n")
                    log_f.flush()
        if ckpt_manager is not None and num_steps not in saved:
            _save(ckpt_manager, num_steps, state, mesh)
    finally:
        if log_f:
            log_f.close()
        if tb is not None:
            tb.close()
    return state
