"""Experiment presets of the port (same names and fields as ecm_tpu.configs)."""

from ecm_torch.configs.base import (
    CONFIGS,
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    TrainConfig,
)

__all__ = ["CONFIGS", "DataConfig", "ExperimentConfig", "ModelConfig", "TrainConfig"]
