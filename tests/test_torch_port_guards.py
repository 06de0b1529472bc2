"""Guards of the port: it never imports the JAX package, and its entry
points refuse to fall back to the CPU when no GPU is present."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "ecm_tpu")


def _port_sources():
    return sorted((ROOT / "ecm_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    sources = _port_sources()
    assert len(sources) > 10
    bad = [
        f"{p.relative_to(ROOT)}: {name}"
        for p in sources
        for name in _imports(p)
        if name.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad


def test_build_model_without_gpu_raises(monkeypatch):
    from ecm_torch.configs import CONFIGS
    from ecm_torch.models import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(max_disp=16, feature_channels=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CONFIGS["kitti_infer"].model.build()


def test_unported_paths_raise():
    from ecm_torch.configs import CONFIGS
    from ecm_torch.models import build_model

    with pytest.raises(NotImplementedError, match="grouped"):
        CONFIGS["overfit_gate_grouped"].model.build(device="cpu")
    with pytest.raises(NotImplementedError, match="ECMBasic"):
        build_model("basic", device="cpu")
    m = build_model(device="cpu", max_disp=16, feature_channels=8)
    m.train()
    with pytest.raises(NotImplementedError, match="training"):
        m(torch.zeros(1, 32, 48, 3), torch.zeros(1, 32, 48, 3))


def test_kernel_build_is_lazy():
    """Importing the wrappers builds nothing: no nvcc on a CPU machine."""
    import ecm_torch.kernels.build as build
    import ecm_torch.ops.cuda_fused_agg  # noqa: F401

    assert build.library.cache_info().currsize == 0
    assert set(build.KERNELS) == {p.stem for p in build.CSRC.glob("*.cu")}
