"""Model modules of the port (names mirror the flax scopes of ecm_tpu), and
``build_model``, which builds one of them by name."""

from __future__ import annotations

import torch
from torch import nn

from ecm_torch.models.ecm import ECMBasic, ECMStereo, regress_disparity, resolve_device
from ecm_torch.models.igev_stereo import IGEVStereo
from ecm_torch.models.layers import init_weights
from ecm_torch.models.raft_stereo import RAFTStereo

# build_model's names
MODELS = {"stackhourglass": ECMStereo, "ecm": ECMStereo, "basic": ECMBasic, "raft_stereo": RAFTStereo,
          "igev_stereo": IGEVStereo}
# the models that take none of the ECM knobs of ``configs.ModelConfig``: it
# builds them at their own (published) sizes from a dtype alone
DTYPE_ONLY = ("raft_stereo", "igev_stereo")


def build_model(
    name: str = "stackhourglass",
    device: str | torch.device | None = None,
    generator: torch.Generator | None = None,
    **kwargs,
) -> nn.Module:
    """Build a model in eval mode on ``device`` (default ``cuda``; raises when
    there is no GPU and no device was given), initialised from ``generator``
    (default: seed 0)."""
    dev = resolve_device(device)
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r}; expected {'|'.join(MODELS)}")
    model = MODELS[name](**kwargs)
    init_weights(model, generator if generator is not None else torch.Generator().manual_seed(0))
    return model.to(dev).eval()


__all__ = ["DTYPE_ONLY", "ECMBasic", "ECMStereo", "IGEVStereo", "MODELS", "RAFTStereo", "build_model",
           "regress_disparity"]
