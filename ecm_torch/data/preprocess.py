"""Preprocessing (port of ``ecm_tpu/data/preprocess.py``), numpy only:
ImageNet normalisation to channels-last float32, and the crop and pad
geometry of the readers: random train crops, and eval pads on the top and
the right (the reference KITTI submission's convention), so that the valid
region stays bottom-left aligned."""

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


def random_crop(
    rng: np.random.Generator,
    arrays: list[np.ndarray],
    crop_h: int,
    crop_w: int,
) -> list[np.ndarray]:
    """Crop the same random window from each array (images + disparity):
    the top row, then the left column, drawn from ``rng``."""
    h, w = arrays[0].shape[:2]
    if h < crop_h or w < crop_w:
        raise ValueError(f"image {h}x{w} < crop {crop_h}x{crop_w}")
    y = int(rng.integers(0, h - crop_h + 1))
    x = int(rng.integers(0, w - crop_w + 1))
    return [a[y : y + crop_h, x : x + crop_w] for a in arrays]


def pad_to_multiple(
    img: np.ndarray, multiple: int = 16, target: tuple[int, int] | None = None
) -> tuple[np.ndarray, tuple[int, int]]:
    """Pad H (top) and W (right) with zeros to ``target`` or to the next
    multiple of ``multiple``. Returns (padded, (pad_top, pad_right))."""
    h, w = img.shape[:2]
    if target is not None:
        th, tw = target
    else:
        th = -(-h // multiple) * multiple
        tw = -(-w // multiple) * multiple
    if th < h or tw < w:
        raise ValueError(f"target {th}x{tw} smaller than image {h}x{w}")
    pad_top, pad_right = th - h, tw - w
    pad_spec = [(pad_top, 0), (0, pad_right)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, pad_spec, mode="constant"), (pad_top, pad_right)


def unpad(disp: np.ndarray, pads: tuple[int, int]) -> np.ndarray:
    """Undo ``pad_to_multiple`` on a [H, W] disparity map."""
    pad_top, pad_right = pads
    w = disp.shape[1]
    return disp[pad_top:, : w - pad_right if pad_right else w]
