"""Training loop (port of ``ecm_tpu/train/loop.py``): steps over a batch
iterator, metrics to stdout, JSONL and TensorBoard every ``log_every`` steps
with the JAX package's log line, a checkpoint every ``ckpt_every`` steps and
one at the end, resuming from ``state.step``.
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

BATCH_KEYS = ("left", "right", "disparity")


def to_device(batch: dict[str, np.ndarray], device: torch.device) -> dict[str, torch.Tensor]:
    """The model's inputs of a numpy batch, as f32 tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(batch[k], np.float32)).to(device) for k in BATCH_KEYS}


def train_loop(
    state: TrainState,
    train_step: Callable,
    data_iter: Iterator[dict[str, np.ndarray]],
    num_steps: int,
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
    and one at ``num_steps``, each step number saved once. Returns the
    state."""
    device = next(state.model.parameters()).device
    log_f = open(metrics_path, "a") if metrics_path else None
    tb = None
    if tensorboard_dir:
        from ecm_torch.train.writers import MetricWriter

        tb = MetricWriter(logdir=tensorboard_dir)
    t0 = time.perf_counter()
    window_images = 0
    try:
        for step in range(state.step, num_steps):
            batch = to_device(next(data_iter), device)
            state, metrics = train_step(state, batch)
            window_images += batch["left"].shape[0]
            if (step + 1) % log_every == 0 or step + 1 == num_steps:
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
                ckpt_lib.save(ckpt_manager, step + 1, state)
            if eval_fn is not None and eval_every and (step + 1) % eval_every == 0:
                eval_metrics = eval_fn(state, step + 1)
                print(f"eval @ {step + 1}: {eval_metrics}", flush=True)
                if log_f:
                    log_f.write(json.dumps({"step": step + 1, "eval": eval_metrics}) + "\n")
                    log_f.flush()
        if ckpt_manager is not None and num_steps not in ckpt_manager.all_steps():
            ckpt_lib.save(ckpt_manager, num_steps, state)
    finally:
        if log_f:
            log_f.close()
        if tb is not None:
            tb.close()
    return state
