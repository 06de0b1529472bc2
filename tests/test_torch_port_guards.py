"""Guards of the port: it never imports the JAX package (nor grain, orbax,
clu or TensorFlow), its kernel wrappers and models know nothing of CUDA
graphs, and its entry points, the CLIs among them, refuse to fall back to
the CPU when no GPU is present."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "ecm_tpu", "grain", "orbax", "clu", "tensorflow")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    from test_torch_port_util import torch_threads

    with torch_threads(1):
        yield


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


@pytest.mark.parametrize("package", ["ops", "models"])
def test_kernels_and_models_know_no_graph(package):
    """No module of ``ecm_torch/ops/`` or ``ecm_torch/models/`` imports from
    ``ecm_torch.train`` or reads a tensor's ``_version``: a CUDA graph reads
    the weights by address and makes their packs and folds itself
    (``train/graphs.py``), so no wrapper or model caches a derived weight
    or learns of a capture."""
    sources = sorted((ROOT / "ecm_torch" / package).rglob("*.py"))
    assert len(sources) > 5
    for path in sources:
        nodes = list(ast.walk(ast.parse(path.read_text(), str(path))))
        names = [*_imports(path), *(f"{n.module}.{a.name}" for n in nodes if isinstance(n, ast.ImportFrom)
                                    for a in n.names)]
        assert not [n for n in names if n == "ecm_torch.train" or n.startswith("ecm_torch.train.")], path
        assert not [n for n in nodes if isinstance(n, ast.Attribute) and n.attr == "_version"], path


def test_build_model_without_gpu_raises(monkeypatch):
    from ecm_torch.configs import CONFIGS
    from ecm_torch.models import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(max_disp=16, feature_channels=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CONFIGS["kitti_infer"].model.build()


def test_unported_paths_raise(monkeypatch):
    """Every path is ported; a disparity mesh needs ranks: with one process
    the eval mesh of ``--mesh-disp`` above 1 needs ``--multihost`` with that
    many ranks, and the training mesh's grid must be the group (its disp
    axis does not divide one rank). What earlier slices ported runs: the
    training forward of both models (3 and 1 predictions),
    the correlation volume with ``use_pallas=True``, and the trainer with
    checkpoints; ``--multihost`` (the data axis) no longer raises
    ``NotImplementedError``: with no GPU and no ``--device`` it refuses the
    CPU before it joins a group, and one process's training mesh is None."""
    from ecm_torch.cli import common
    from ecm_torch.configs import CONFIGS
    from ecm_torch.models import build_model

    images = (torch.zeros(1, 32, 48, 3), torch.zeros(1, 32, 48, 3))
    for name, n in (("stackhourglass", 3), ("basic", 1)):
        m = build_model(name, device="cpu", max_disp=16, feature_channels=8)
        m.train()
        assert len(m(*images)) == n
    m = build_model(device="cpu", max_disp=16, feature_channels=8, cost_mode="correlation", use_pallas=True)
    with torch.inference_mode():
        assert m(*images)[0].shape == (1, 32, 48)
    for argv in (["--mesh-disp", "2"], ["--config", "middlebury_disp_sharded"]):
        cfg = common.resolve_config(common.base_parser("").parse_args(argv), "kitti_infer")
        with pytest.raises(ValueError, match="needs --multihost with .* ranks, have 1"):
            common.eval_mesh(cfg)
        with pytest.raises(ValueError, match=r"mesh disp=\d with 1 ranks: the disp axis must divide the group"):
            common.make_mesh_from(cfg)
    assert common.make_mesh_from(CONFIGS["sceneflow_single"]) is None
    assert common.eval_mesh(CONFIGS["kitti_infer"]) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        common.maybe_init_distributed(common.base_parser("").parse_args(["--multihost"]))
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("cli", ["train", "finetune", "evaluate", "submission", "test_img"])
def test_cli_without_gpu_raises(cli, monkeypatch, tmp_path):
    """Each CLI's ``main`` with no ``--device`` runs on cuda, so with no GPU
    it raises before it trains or serves."""
    import importlib

    from test_torch_port_util import write_kitti_tree

    argv = {
        "train": ["--config", "overfit_gate", "--steps", "1"],
        "finetune": ["--steps", "1"],
        "evaluate": ["--dataset", "kitti2015", "--datapath", write_kitti_tree(tmp_path, n_test=0)],
        "submission": ["--outdir", str(tmp_path / "out")],
        "test_img": ["--synthetic", "--out", str(tmp_path / "d.png")],
    }[cli]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        importlib.import_module(f"ecm_torch.cli.{cli}").main([*argv, "--savemodel", str(tmp_path / "ck")])
    assert not (tmp_path / "out").exists() and not (tmp_path / "d.png").exists()


def test_kernel_build_is_lazy():
    """Importing the wrappers builds nothing: no nvcc on a CPU machine."""
    import ecm_torch.kernels.build as build
    import ecm_torch.ops.cuda_fused_agg  # noqa: F401

    assert build.library.cache_info().currsize == 0
    assert set(build.KERNELS) == {p.stem for p in build.CSRC.glob("*.cu")}
