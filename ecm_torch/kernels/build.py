"""Build and load the port's hand-written CUDA kernels.

Each ``ecm_torch/csrc/<name>.cu`` is compiled on first use by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, under
``build/ecm_torch/`` at the root of the checkout, and loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds, not minutes). The library's
file name carries a hash of the source, of every shared header
(``csrc/*.cuh``) and of the flags, so an edited source or header is rebuilt
and a stale library is never loaded.

Every C entry point takes its pointers and the CUDA stream as ``void*``
(``ctypes.c_void_p``), its sizes as ``int``, and returns
``cudaGetLastError()`` after the launch; :func:`check` raises on a nonzero
status. Nothing here runs at import time: the CPU test machine has no
``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ecm_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
)
KERNELS = ("conv3d_bn", "cost_volume", "deconv3d_bn", "fused_conv3d_pair", "regression")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only on a machine with the "
            "CUDA toolkit (PATH or /usr/local/cuda/bin)"
        )
    return path


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start_build(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def build(names: tuple[str, ...] = KERNELS) -> dict[str, str]:
    """Compile every named kernel whose library is missing, one ``nvcc`` per
    source, all started together. Returns each build's compiler output
    (registers, shared memory, spills from ``-Xptxas -v``); raises if any
    build fails."""
    started = {n: b for n in names if (b := _start_build(n)) is not None}
    logs, failed = {}, []
    for name, (proc, tmp, out) in started.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    build((name,))
    return ctypes.CDLL(str(library_path(name)))


def check(status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {status}")
