"""Training stack of the port (``ecm_tpu.train``): loss, metrics, optimizer
and train state, steps, and the loop."""

from ecm_torch.train.loss import STAGE_WEIGHTS, masked_smooth_l1, stereo_loss
from ecm_torch.train.metrics import disparity_metrics
from ecm_torch.train.state import TrainState, create_train_state, make_optimizer

__all__ = [
    "STAGE_WEIGHTS",
    "TrainState",
    "create_train_state",
    "disparity_metrics",
    "make_optimizer",
    "masked_smooth_l1",
    "stereo_loss",
]
