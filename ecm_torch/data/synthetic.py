"""Synthetic stereo pairs (port of ``ecm_tpu/data/synthetic.py``, seed for
seed): a smooth random disparity field in ``(min_disp, max_disp)`` and a
smooth random texture; the right image is the texture, the left image the
texture resampled bilinearly at ``x - d(x)``, so ``d = x_left - x_right``
can be recovered. Inputs for the trainer and the tests without a dataset.
"""

from __future__ import annotations

import numpy as np

from ecm_torch.data.preprocess import normalize


def _texture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Smooth random RGB texture [H, W, 3] in [0, 255]."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        acc = np.zeros((h, w), np.float32)
        for _ in range(6):
            fx, fy = rng.uniform(0.02, 0.35, size=2)
            ph = rng.uniform(0, 2 * np.pi)
            amp = rng.uniform(0.3, 1.0)
            acc += amp * np.sin(fx * xx + fy * yy + ph)
        img[..., c] = acc
    img -= img.min()
    img /= max(img.max(), 1e-6)
    return (img * 255.0).astype(np.float32)


def _disparity_field(
    rng: np.random.Generator, h: int, w: int, min_disp: float, max_disp: float
) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    acc = np.zeros((h, w), np.float32)
    for _ in range(4):
        fx, fy = rng.uniform(0.002, 0.03, size=2)
        ph = rng.uniform(0, 2 * np.pi)
        acc += rng.uniform(0.3, 1.0) * np.sin(fx * xx + fy * yy + ph)
    acc -= acc.min()
    acc /= max(acc.max(), 1e-6)
    return (min_disp + acc * (max_disp - min_disp)).astype(np.float32)


def make_pair(
    rng: np.random.Generator,
    h: int = 256,
    w: int = 512,
    min_disp: float = 4.0,
    max_disp: float = 40.0,
    normalized: bool = True,
) -> dict[str, np.ndarray]:
    """One sample {left, right [H, W, 3], disparity [H, W]}: right(x) =
    texture(x + pad), left(x) = texture(x - d(x) + pad) = right(x - d)."""
    pad = int(np.ceil(max_disp)) + 2
    tex = _texture(rng, h, w + pad)
    disp = _disparity_field(rng, h, w, min_disp, max_disp)
    right = tex[:, pad:]
    xs = np.arange(w, dtype=np.float32)[None, :] - disp + pad
    x0 = np.floor(xs).astype(np.int32)
    frac = (xs - x0)[..., None]
    x0 = np.clip(x0, 0, w + pad - 2)
    rows = np.arange(h)[:, None]
    left = tex[rows, x0] * (1 - frac) + tex[rows, x0 + 1] * frac
    if normalized:
        left, right = normalize(left), normalize(right)
    return {
        "left": left.astype(np.float32),
        "right": right.astype(np.float32),
        "disparity": disp,
    }


def make_batch(
    seed: int, batch: int, h: int = 256, w: int = 512, max_disp: float = 40.0
) -> dict[str, np.ndarray]:
    """``batch`` samples from ``np.random.default_rng(seed)``, stacked."""
    rng = np.random.default_rng(seed)
    samples = [make_pair(rng, h, w, max_disp=max_disp) for _ in range(batch)]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}
