"""KITTI 2012/2015 listers and sample loader (port of
``ecm_tpu/data/kitti.py``).

- 2015: ``training/image_2`` (left), ``image_3`` (right), ``disp_occ_0``
  (ground truth); 2012: ``colored_0``, ``colored_1``, ``disp_occ``.
- ``testing/`` has no ground truth; it is what a submission runs on.

Disparity PNGs are uint16, value = disparity * 256, 0 = invalid. Images are
read and written with Pillow, imported where an image is read or written.
"""

from __future__ import annotations

import os

import numpy as np

from ecm_torch.data.preprocess import normalize, pad_to_multiple, random_crop
from ecm_torch.data.sceneflow import SampleSpec, read_rgb

EVAL_SIZE = (384, 1248)  # eval pad target (top/right), the reference's


def list_kitti(
    root: str, year: int = 2015, split: str = "training", val_count: int = 40
) -> tuple[list[SampleSpec], list[SampleSpec]]:
    """List KITTI pairs -> (train, val): the last ``val_count`` pairs
    (at most half) are validation. For ``split='testing'`` the disparity
    paths are empty and every pair is in the first list."""
    if year == 2015:
        left_dir, right_dir, disp_dir = "image_2", "image_3", "disp_occ_0"
    elif year == 2012:
        left_dir, right_dir, disp_dir = "colored_0", "colored_1", "disp_occ"
    else:
        raise ValueError(f"KITTI year must be 2012 or 2015, got {year}")
    base = os.path.join(root, split)
    if not os.path.isdir(base):
        base = root  # allow pointing directly at training/
    ldir = os.path.join(base, left_dir)
    names = sorted(
        n for n in os.listdir(ldir) if n.endswith(".png") and "_10" in n
    ) if os.path.isdir(ldir) else []
    specs = []
    for n in names:
        disp = os.path.join(base, disp_dir, n) if split == "training" else ""
        specs.append(
            SampleSpec(
                os.path.join(base, left_dir, n),
                os.path.join(base, right_dir, n),
                disp,
            )
        )
    if split != "training":
        return specs, []
    val_count = min(val_count, len(specs) // 2)
    cut = len(specs) - val_count
    return specs[:cut], specs[cut:]


def decode_disp_png(path_or_array) -> np.ndarray:
    """uint16 KITTI disparity PNG (a path or its array) -> float32
    disparity (0 = invalid)."""
    if isinstance(path_or_array, np.ndarray):
        arr = path_or_array
    else:
        from PIL import Image

        with Image.open(path_or_array) as img:
            arr = np.asarray(img)
    return arr.astype(np.float32) / 256.0


def encode_disp_png(disp: np.ndarray) -> np.ndarray:
    """float32 disparity -> uint16 KITTI server encoding (disp * 256)."""
    return np.clip(np.round(np.asarray(disp) * 256.0), 0, 65535).astype(np.uint16)


def save_disp_png(path: str, disp: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(encode_disp_png(disp)).save(path)


def load_sample(
    spec: SampleSpec,
    crop: tuple[int, int] | None = (256, 512),
    rng: np.random.Generator | None = None,
) -> dict[str, np.ndarray]:
    """One KITTI sample. Training (``crop``): a random crop drawn from
    ``rng``. Eval (``crop=None``): padded to ``EVAL_SIZE`` on the top and
    the right, with the pads under ``pads`` for un-padding."""
    left = read_rgb(spec.left)
    right = read_rgb(spec.right)
    disp = (
        decode_disp_png(spec.disp)
        if spec.disp and os.path.exists(spec.disp)
        else np.zeros(left.shape[:2], np.float32)
    )
    if crop is not None:
        rng = rng or np.random.default_rng()
        left, right, disp = random_crop(rng, [left, right, disp], crop[0], crop[1])
        return {"left": normalize(left), "right": normalize(right), "disparity": disp}
    left_n, pads = pad_to_multiple(normalize(left), target=EVAL_SIZE)
    right_n, _ = pad_to_multiple(normalize(right), target=EVAL_SIZE)
    disp_p, _ = pad_to_multiple(disp, target=EVAL_SIZE)
    return {
        "left": left_n,
        "right": right_n,
        "disparity": disp_p,
        "pads": np.asarray(pads, np.int32),
    }
