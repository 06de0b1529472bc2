"""Seeded stereo pairs, made on the device in a few batched calls.

The idea of the program's synthetic data (``data/synthetic.py``), written
again for speed: a smooth random texture (a sum of sinusoids per channel)
seen by the right camera, and the left image the same texture resampled
linearly at ``x - d(x)`` under a smooth random disparity field ``d`` in
``[min_disp, max_disp]``, so that ``d = x_left - x_right`` is the ground
truth. Images are ImageNet-normalised float32, channels last, as the
program's readers hand them to the model.
"""

from __future__ import annotations

import math

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
TEXTURE_WAVES = 6
DISPARITY_WAVES = 4


def _waves(gen, n: int, k: int, fmin: float, fmax: float, device) -> tuple[torch.Tensor, ...]:
    r = torch.rand(n, k, 4, generator=gen, device=device)
    fx, fy = (fmin + (fmax - fmin) * r[..., i] for i in (0, 1))
    return fx, fy, 2 * math.pi * r[..., 2], 0.3 + 0.7 * r[..., 3]


def _field(yy, xx, fx, fy, ph, amp) -> torch.Tensor:
    """sum_k amp_k sin(fx_k x + fy_k y + ph_k), [n, H, W], rescaled to [0, 1]."""
    acc = (amp[:, :, None, None] * torch.sin(
        fx[:, :, None, None] * xx + fy[:, :, None, None] * yy + ph[:, :, None, None])).sum(1)
    lo = acc.amin((1, 2), keepdim=True)
    hi = acc.amax((1, 2), keepdim=True)
    return (acc - lo) / (hi - lo).clamp_min(1e-6)


@torch.no_grad()
def make_pairs(gen: torch.Generator, n: int, h: int, w: int, min_disp: float, max_disp: float,
               device: torch.device) -> dict[str, torch.Tensor]:
    """``n`` pairs on ``device``: ``left``/``right`` [n, H, W, 3] and
    ``disparity`` [n, H, W], float32."""
    pad = int(math.ceil(max_disp)) + 2
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w + pad, device=device, dtype=torch.float32)[None, :]
    tex = torch.stack([_field(yy, xx, *_waves(gen, n, TEXTURE_WAVES, 0.02, 0.35, device)) for _ in range(3)], -1)
    disp = min_disp + (max_disp - min_disp) * _field(
        yy, xx[:, :w], *_waves(gen, n, DISPARITY_WAVES, 0.002, 0.03, device))
    xs = torch.arange(w, device=device, dtype=torch.float32) - disp + pad
    x0 = xs.floor().clamp_(0, w + pad - 2)
    frac = (xs - x0)[..., None]
    idx = x0.long()[..., None].expand(n, h, w, 3)
    left = torch.gather(tex, 2, idx) * (1 - frac) + torch.gather(tex, 2, idx + 1) * frac
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    std = torch.tensor(IMAGENET_STD, device=device)
    return {"left": (left - mean) / std, "right": (tex[:, :, pad:] - mean) / std, "disparity": disp}


def make_pool(seed: int, count: int, batch: int, h: int, w: int, min_disp: float, max_disp: float,
              device: torch.device) -> list[dict[str, torch.Tensor]]:
    """``count`` distinct batches of ``batch`` pairs from ``seed``, made on
    ``device`` one batch at a time and handed back in host memory
    (pageable, as a reader's arrays are)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [{k: v.cpu() for k, v in make_pairs(gen, batch, h, w, min_disp, max_disp, device).items()}
            for _ in range(count)]
