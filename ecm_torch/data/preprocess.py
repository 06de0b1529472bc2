"""Image normalisation (the part of ``ecm_tpu/data/preprocess.py`` the
trainer needs now): uint8 or [0, 255] float ``[H, W, 3]`` -> ImageNet-
normalised float32, channels last, numpy only."""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def normalize(img: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3] (or float in [0, 255]; grey [H, W] or RGBA taken too)
    -> ImageNet-normalised float32."""
    img = np.asarray(img, dtype=np.float32)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.shape[-1] == 4:
        img = img[..., :3]
    img = img / 255.0
    return (img - IMAGENET_MEAN) / IMAGENET_STD
