"""PFM disparity maps (port of ``ecm_tpu/data/pfm.py``), numpy only.

A header line ``PF`` (colour) or ``Pf`` (grey), a line ``W H``, a scale
line whose sign gives the byte order (negative: little-endian), then float32
rows from bottom to top (so a read flips vertically).
"""

from __future__ import annotations

import re

import numpy as np


def read_pfm(path: str) -> tuple[np.ndarray, float]:
    """Read a PFM file -> (array [H, W] or [H, W, 3] float32, scale)."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"{path}: not a PFM file (header {header!r})")

        dims = f.readline()
        while dims.startswith(b"#"):  # optional comment lines
            dims = f.readline()
        m = re.match(rb"^\s*(\d+)\s+(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"{path}: malformed PFM dimension line {dims!r}")
        width, height = int(m.group(1)), int(m.group(2))

        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)

        data = np.frombuffer(f.read(), dtype=endian + "f")
        shape = (height, width, 3) if color else (height, width)
        data = data.reshape(shape)
        return np.ascontiguousarray(np.flipud(data)).astype(np.float32), scale


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    """Write a float32 [H, W] or [H, W, 3] array as PFM (little-endian)."""
    image = np.asarray(image, dtype=np.float32)
    if image.ndim == 2:
        color = False
    elif image.ndim == 3 and image.shape[2] == 3:
        color = True
    else:
        raise ValueError(f"bad PFM shape {image.shape}")
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        f.write(f"{-abs(scale)}\n".encode())  # negative = little-endian
        np.flipud(image).astype("<f").tofile(f)
