"""Trilinear/bilinear upsampling as separable resize-matrix contractions.

The same contraction as ``ecm_tpu/ops/upsample.py`` (not ``F.interpolate``),
so reduced-precision inputs round at the same places: a linear resize along
axis n is ``out = M @ x`` with a fixed ``[n_out, n_in]`` half-pixel-centre,
edge-clamped weight matrix. Upsampling and identity only, as the model uses.

The matrix is made with numpy once per size and copied to a device once per
``(n_in, n_out, device, dtype)`` (:func:`resize_matrix`): a forward makes no
host-to-device copy, which would block the host until the card drains and
cannot be captured in a CUDA graph. In JAX the matrix is a constant under
``jit``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] linear-interp matrix, half-pixel centers, edge clamp."""
    if n_out < n_in:
        raise ValueError(f"upsample only: {n_in} -> {n_out}")
    if n_in == n_out:
        return np.eye(n_in, dtype=np.float32)
    m = np.zeros((n_out, n_in), dtype=np.float32)
    coords = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    x0 = np.floor(coords).astype(np.int64)
    frac = (coords - x0).astype(np.float32)
    lo = np.clip(x0, 0, n_in - 1)
    hi = np.clip(x0 + 1, 0, n_in - 1)
    rows = np.arange(n_out)
    np.add.at(m, (rows, lo), 1.0 - frac)
    np.add.at(m, (rows, hi), frac)
    return m


# (n_in, n_out, device, dtype) -> the matrix there. Never evicted: a captured
# CUDA graph reads a matrix by its address, so it must outlive every graph.
_ON_DEVICE: dict[tuple, torch.Tensor] = {}


def resize_matrix(n_in: int, n_out: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """:func:`_resize_matrix` on ``device`` in ``dtype``, copied there once.
    Made outside inference mode, so that training can save it for the
    backward."""
    key = (n_in, n_out, device, dtype)
    mat = _ON_DEVICE.get(key)
    if mat is None:
        with torch.inference_mode(False):
            mat = _ON_DEVICE[key] = torch.from_numpy(_resize_matrix(n_in, n_out)).to(device, dtype)
    return mat


def _contract(x: torch.Tensor, axis: int, n_out: int) -> torch.Tensor:
    mat = resize_matrix(x.shape[axis], n_out, x.device, x.dtype)
    return torch.matmul(x.movedim(axis, -1), mat.T).movedim(-1, axis)


def upsample_trilinear(x: torch.Tensor, shape: tuple[int, int, int]) -> torch.Tensor:
    """Resize the trailing three dims of ``[B, D, H, W]`` to ``shape``, in f32
    (this feeds the soft-argmin)."""
    x = x.float()
    for axis, n_out in zip((1, 2, 3), shape):
        if x.shape[axis] != n_out:
            x = _contract(x, axis, n_out)
    return x


def upsample_bilinear(x: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """Resize ``[B, H, W, C]`` to spatial ``shape``, keeping the dtype."""
    for axis, n_out in zip((1, 2), shape):
        if x.shape[axis] != n_out:
            x = _contract(x, axis, n_out)
    return x
