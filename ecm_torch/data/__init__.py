"""Data layer of the port (``ecm_tpu.data``): numpy readers (PFM, KITTI's
uint16 PNG through Pillow), the SceneFlow, KITTI and Middlebury listers, a
``DataLoader`` pipeline, ImageNet normalisation and the synthetic stereo
generator."""

from ecm_torch.data.pfm import read_pfm, write_pfm
from ecm_torch.data.preprocess import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    normalize,
    pad_to_multiple,
    random_crop,
)
from ecm_torch.data.synthetic import make_batch, make_pair

__all__ = [
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "make_batch",
    "make_pair",
    "normalize",
    "pad_to_multiple",
    "random_crop",
    "read_pfm",
    "write_pfm",
]
