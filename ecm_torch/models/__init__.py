"""Model modules of the port (names mirror the flax scopes of ecm_tpu)."""

from ecm_torch.models.ecm import ECMStereo, build_model, regress_disparity

__all__ = ["ECMStereo", "build_model", "regress_disparity"]
