"""Train, eval and inference steps (port of ``ecm_tpu/train/steps.py``).

PyTorch runs eagerly, so a step is a plain function; each puts the model in
the mode it needs (``train()``: batch-statistics BatchNorm, every head;
``eval()``: running statistics, the last head). The model's own dtype casts
(bf16 activations, f32 parameters and statistics) are the mixed precision;
there is no autocast.
"""

from __future__ import annotations

import torch
from torch import nn

from ecm_torch.train.loss import stereo_loss
from ecm_torch.train.metrics import disparity_metrics
from ecm_torch.train.state import TrainState


def make_train_step(model: nn.Module, max_disp: int):
    """``(state, batch) -> (state, metrics)``: one optimizer step on
    ``batch`` (tensors on the model's device: left/right ``[B, H, W, 3]``,
    disparity ``[B, H, W]``). Metrics stay on the device."""

    def train_step(state: TrainState, batch: dict[str, torch.Tensor]):
        model.train()
        preds = model(batch["left"], batch["right"])
        loss = stereo_loss(preds, batch["disparity"], max_disp)
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        state.step += 1
        metrics = {"loss": loss.detach()}
        metrics.update(disparity_metrics(preds[-1].detach(), batch["disparity"], max_disp))
        return state, metrics

    return train_step


def make_eval_step(model: nn.Module, max_disp: int):
    """``(state, batch) -> (disp [B, H, W], metrics)`` in eval mode."""

    @torch.inference_mode()
    def eval_step(state: TrainState, batch: dict[str, torch.Tensor]):
        model.eval()
        disp = model(batch["left"], batch["right"])[-1]
        return disp, disparity_metrics(disp, batch["disparity"], max_disp)

    return eval_step


def make_infer_fn(model: nn.Module):
    """``(left, right) -> disp [B, H, W]`` in eval mode, for serving."""

    @torch.inference_mode()
    def infer(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
        model.eval()
        return model(left, right)[-1]

    return infer
