"""SceneFlow file lister and sample loader (port of
``ecm_tpu/data/sceneflow.py``).

Walks the SceneFlow layout (FlyingThings3D, Monkaa, Driving;
``frames_finalpass`` or ``frames_cleanpass`` RGB frames beside a
``disparity`` tree of PFM files) into (left, right, left-disparity) path
triples: paths holding a ``TEST`` directory are the test split
(FlyingThings3D's convention), all others train.

Images are read with Pillow, imported where an image is read.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ecm_torch.data.pfm import read_pfm
from ecm_torch.data.preprocess import normalize, random_crop


@dataclasses.dataclass(frozen=True)
class SampleSpec:
    left: str
    right: str
    disp: str


def _is_image(name: str) -> bool:
    return name.endswith((".png", ".webp", ".jpg"))


def read_rgb(path: str) -> np.ndarray:
    """An image file as uint8 [H, W, 3]."""
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def list_sceneflow(root: str) -> tuple[list[SampleSpec], list[SampleSpec]]:
    """Walk a SceneFlow root -> (train, test) path triples.

    Any tree with parallel ``.../left/xxxx.png`` and ``.../right/xxxx.png``
    image directories and a ``disparity`` tree of ``.pfm`` files beside them
    is picked up.
    """
    train: list[SampleSpec] = []
    test: list[SampleSpec] = []
    for dirpath, _dirnames, filenames in os.walk(root):
        if os.path.basename(dirpath) != "left":
            continue
        right_dir = os.path.join(os.path.dirname(dirpath), "right")
        if not os.path.isdir(right_dir):
            continue
        for fn in sorted(filenames):
            if not _is_image(fn):
                continue
            left = os.path.join(dirpath, fn)
            right = os.path.join(right_dir, fn)
            stem = os.path.splitext(fn)[0]
            disp = None
            for cand in (
                left.replace("frames_finalpass", "disparity")
                .replace("frames_cleanpass", "disparity")
                .replace(fn, stem + ".pfm"),
                os.path.join(os.path.dirname(dirpath), "disparity", stem + ".pfm"),
            ):
                if os.path.exists(cand):
                    disp = cand
                    break
            if disp is None or not os.path.exists(right):
                continue
            spec = SampleSpec(left, right, disp)
            if os.sep + "TEST" + os.sep in left:
                test.append(spec)
            else:
                train.append(spec)
    return train, test


def load_sample(
    spec: SampleSpec,
    crop: tuple[int, int] | None = (256, 512),  # (H, W) train crop
    rng: np.random.Generator | None = None,
) -> dict[str, np.ndarray]:
    """One stereo sample -> {left, right [H, W, 3], disparity [H, W]}
    float32, the images ImageNet-normalised. With ``crop`` (training): a
    random crop drawn from ``rng``; ``crop=None`` (eval): the full images
    (the caller pads them to a multiple of 16)."""
    left = read_rgb(spec.left)
    right = read_rgb(spec.right)
    disp, _ = read_pfm(spec.disp)
    if disp.ndim == 3:
        disp = disp[..., 0]
    disp = np.ascontiguousarray(disp).astype(np.float32)
    if crop is not None:
        rng = rng or np.random.default_rng()
        left, right, disp = random_crop(rng, [left, right, disp], crop[0], crop[1])
    return {
        "left": normalize(left),
        "right": normalize(right),
        "disparity": disp,
    }
