"""Data layer of the port (``ecm_tpu.data``), numpy only: ImageNet
normalisation and the synthetic stereo generator. The dataset readers and
the loader wait for the data slice (ROADMAP queue 1)."""

from ecm_torch.data.preprocess import IMAGENET_MEAN, IMAGENET_STD, normalize
from ecm_torch.data.synthetic import make_batch, make_pair

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "make_batch", "make_pair", "normalize"]
