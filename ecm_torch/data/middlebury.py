"""Middlebury (2014/v3) high-resolution pairs (port of
``ecm_tpu/data/middlebury.py``).

Layout: ``<root>/<scene>/im0.png`` (left), ``im1.png`` (right),
``disp0GT.pfm`` (ground truth, ``inf`` = unknown) and an optional
``calib.txt`` with ``ndisp``. Eval pads H and W to a multiple of 32.
"""

from __future__ import annotations

import os

import numpy as np

from ecm_torch.data.pfm import read_pfm
from ecm_torch.data.preprocess import normalize, pad_to_multiple, random_crop
from ecm_torch.data.sceneflow import SampleSpec, read_rgb


def list_middlebury(root: str) -> tuple[list[SampleSpec], list[SampleSpec]]:
    """Scenes with ground truth -> first list; scenes without -> second."""
    with_gt, without_gt = [], []
    if not os.path.isdir(root):
        return [], []
    for scene in sorted(os.listdir(root)):
        base = os.path.join(root, scene)
        left, right = os.path.join(base, "im0.png"), os.path.join(base, "im1.png")
        if not (os.path.exists(left) and os.path.exists(right)):
            continue
        disp = os.path.join(base, "disp0GT.pfm")
        spec = SampleSpec(left, right, disp if os.path.exists(disp) else "")
        (with_gt if spec.disp else without_gt).append(spec)
    return with_gt, without_gt


def read_ndisp(scene_dir: str, default: int = 256) -> int:
    """``ndisp`` (the disparity search range) from the scene's calib.txt."""
    path = os.path.join(scene_dir, "calib.txt")
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                if line.startswith("ndisp="):
                    return int(float(line.split("=", 1)[1]))
    return default


def load_sample(
    spec: SampleSpec,
    crop: tuple[int, int] | None = None,
    rng: np.random.Generator | None = None,
    multiple: int = 32,
) -> dict[str, np.ndarray]:
    """One pair; an unknown (``inf``) ground truth becomes 0 (invalid), the
    KITTI and loss convention. Eval (``crop=None``): padded to ``multiple``
    on the top and the right, with the pads under ``pads``."""
    left = read_rgb(spec.left)
    right = read_rgb(spec.right)
    if spec.disp and os.path.exists(spec.disp):
        disp, _ = read_pfm(spec.disp)
        if disp.ndim == 3:
            disp = disp[..., 0]
        disp = np.where(np.isfinite(disp), disp, 0.0).astype(np.float32)
    else:
        disp = np.zeros(left.shape[:2], np.float32)
    if crop is not None:
        rng = rng or np.random.default_rng()
        left, right, disp = random_crop(rng, [left, right, disp], crop[0], crop[1])
        return {"left": normalize(left), "right": normalize(right), "disparity": disp}
    left_n, pads = pad_to_multiple(normalize(left), multiple=multiple)
    right_n, _ = pad_to_multiple(normalize(right), multiple=multiple)
    disp_p, _ = pad_to_multiple(disp, multiple=multiple)
    return {
        "left": left_n,
        "right": right_n,
        "disparity": disp_p,
        "pads": np.asarray(pads, np.int32),
    }
