"""The model-family seam: a second stereo architecture joins the benchmark
by a family module, its reference and a configuration file, with no edit to
the drivers, the harness or the trace; and ECMStereo's family gives exactly
what the benchmark's constants gave before it had families."""

from __future__ import annotations

import json
import re
import sys
import time
import types

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from stereo_bench import harness, trace
from stereo_bench import weights as W
from stereo_bench.drivers import serve
from stereo_bench.families import ecmstereo, family
from stereo_bench.tests.tiny import tiny

CPU = torch.device("cpu")
MODEL = "ToyStereo"
CELL = "toy_b1"
CHANNELS = 4


# -- a toy family: a feature conv, a correlation volume and a soft-argmin ----

class ToyNet(nn.Module):
    """The port's model contract: ``forward(left, right)`` on channels-last
    ``[B, H, W, 3]`` images returns a list whose last entry is ``[B, H, W]``."""

    def __init__(self, max_disp: int):
        super().__init__()
        self.max_disp = max_disp
        self.feature = nn.Conv2d(3, CHANNELS, 3, padding=1)

    def forward(self, left: torch.Tensor, right: torch.Tensor) -> list[torch.Tensor]:
        fl, fr = (self.feature(x.permute(0, 3, 1, 2)) for x in (left, right))
        cost = fl.new_zeros(fl.shape[0], self.max_disp, *fl.shape[2:])
        for d in range(self.max_disp):
            cost[:, d, :, d:] = (fl[..., d:] * fr[..., : fl.shape[-1] - d]).mean(1)
        disps = torch.arange(self.max_disp, dtype=cost.dtype, device=cost.device)
        return [(cost.softmax(1) * disps[:, None, None]).sum(1)]


def toy_reference(params: dict, cfg: dict, left: torch.Tensor, right: torch.Tensor, precision) -> torch.Tensor:
    """The toy's plain reference: every disparity's shifted right features at
    once, the features rounded through ``precision``."""
    d = cfg["shapes"]["max_disp"]
    fl, fr = (F.conv2d(x.permute(0, 3, 1, 2), params["feature.weight"], params["feature.bias"], padding=1)
              .to(precision).float() for x in (left, right))
    shifted = torch.stack([F.pad(fr, (k, 0))[..., : fr.shape[-1]] for k in range(d)], 1)
    cost = (fl[:, None] * shifted).mean(2)
    return (cost.softmax(1) * torch.arange(d, dtype=cost.dtype, device=cost.device)[:, None, None]).sum(1)


def toy_build(cfg: dict, device: torch.device) -> ToyNet:
    with torch.device("meta"):
        model = ToyNet(cfg["shapes"]["max_disp"])
    return model.to_empty(device=device).eval()


def toy_check_sizes(model: ToyNet, cfg: dict) -> None:
    assert model.max_disp == cfg["shapes"]["max_disp"]


def toy_eval_work(cfg: dict, batch: int) -> dict:
    h, w, d = cfg["shapes"]["height"], cfg["shapes"]["width"], cfg["shapes"]["max_disp"]
    return {"flops": batch * (2 * 2.0 * 3 * CHANNELS * 9 * h * w + 2.0 * CHANNELS * d * h * w),
            "port_bound_s": batch * 1e-6}


def toy_family() -> types.ModuleType:
    """What ``families/toystereo.py`` would hold."""
    module = types.ModuleType(f"stereo_bench.families.{MODEL.lower()}")
    module.__dict__.update(
        build=toy_build, check_sizes=toy_check_sizes, infer=toy_reference, eval_work=toy_eval_work,
        seeded_weights=lambda cfg, template, seed, device: W.make_weights(template, cfg["weights"], seed, device),
        EXACT=torch.float32, FP8=torch.float8_e4m3fn, KERNELS=("toy_cost_kernel",))
    return module


def toy_manifest(tmp_path) -> dict:
    """A manifest of one toy cell on the serving mix, reporting what
    ``kitti_b1`` reports; ``BENCHMARK.json`` is left as it is."""
    cfg = {"name": "toy_kitti", "source": "https://example.org/toy-stereo", "model": MODEL,
           "shapes": {"height": 384, "width": 1248, "max_disp": 192}, "dtype": "float32", "reduced": [],
           "weights": {"bn_scale": [0.5, 1.0], "shift_std": 0.1, "running_var": [0.5, 1.5]},
           "limits": {"disp_mae_px": 1e-3, "disp_p999_px": 1e-2}}
    path = tmp_path / "toy_kitti.json"
    path.write_text(json.dumps(cfg))
    real = harness.manifest()
    retarget = lambda ms: [{**m, "workloads": [CELL]} for m in ms if "kitti_b1" in m.get("workloads", [])]  # noqa: E731
    return {"configs": [{"name": cfg["name"], "source": cfg["source"], "file": str(path), "reduced": [],
                         "why": "a toy"}],
            "workloads": [{"name": CELL, "config": cfg["name"], "traffic": "serve_b1", "chips": 1, "why": "a toy"}],
            "end_to_end": retarget(real["end_to_end"]) + [m for m in real["end_to_end"] if "workloads" not in m],
            "per_layer": retarget(real["per_layer"])}


@pytest.fixture
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_a_new_family_joins_by_its_module(tmp_path, monkeypatch, few_threads):
    """The toy resolves through ``harness.cell`` and runs through the serving
    driver, traced, on the CPU; the window's work and kernels are the toy's."""
    spec = tiny(CELL, man=toy_manifest(tmp_path))
    cfg = spec["config"]
    with pytest.raises(ModuleNotFoundError):
        family(cfg)
    fam = toy_family()
    monkeypatch.setitem(sys.modules, fam.__name__, fam)
    assert family(cfg) is fam
    fam.check_sizes(fam.build(cfg, torch.device("meta")), cfg)

    out = serve.run(spec, 4_294_967_311, 1.0, True, CPU, time.perf_counter())
    assert out["correct"], out["checked"]
    assert out["attempted"] == spec["mix"]["trace_requests"] and out["failed"] == 0
    (win,) = out["windows"]
    assert win["port_kernels"] == fam.KERNELS
    assert win["flops"] == win["requests"] * toy_eval_work(cfg, spec["mix"]["batch"])["flops"]
    line = harness.result_line(spec, out, True, {})
    assert "mfu.b1" in line["metrics"] and line["correct"]


def test_kernels_are_the_windows():
    """A kernel counts as the program's by the window's ``port_kernels``: under
    the toy's, ECM's conv core is library time."""
    win = {"device": [("void toy_cost_kernel<1>", 0.0, 5.0, "kernel"),
                      ("void ecm::wg::conv3d_wgmma_kernel<1, 32>", 5.0, 12.0, "kernel"),
                      ("Memcpy HtoD", 12.0, 20.0, "gpu_memcpy")],
           "port_kernels": toy_family().KERNELS}
    assert trace.kernel_us(win, port=True) == 5.0 and trace.kernel_us(win, port=False) == 7.0
    win["port_kernels"] = ecmstereo.KERNELS
    assert trace.kernel_us(win, port=True) == 7.0 and trace.kernel_us(win, port=False) == 5.0


# the modules every cell runs through name no model: what is particular to
# one lives in its family module and its reference
SEAM = ["harness.py", "run.py", "trace.py", "calibrate.py", "drivers/serve.py", "drivers/train.py"]
MODEL_NAMES = re.compile(r"reference\.ecm|reference import ecm|counts\.(eval|train)_|build_model|"
                         r"\b(W|weights)\.seeded_weights|feature_channels|PORT_KERNELS|ECMStereo|ecmstereo|"
                         + MODEL.lower())


@pytest.mark.parametrize("path", SEAM)
def test_seam_names_no_model(path):
    text = (harness.HERE / path).read_text()
    assert not MODEL_NAMES.search(text), MODEL_NAMES.search(text).group(0)


def test_ecm_family_gives_what_the_constants_gave():
    """The symbols, FLOPs and bounds of the forms that ``trace.py`` and the
    drivers computed before the seam, at each configuration file's sizes."""
    kitti, sceneflow = (json.loads((harness.HERE / "configs" / f"{n}.json").read_text())
                        for n in ("ecm_kitti", "ecm_sceneflow"))
    assert ecmstereo.KERNELS == (
        "conv3d_wgmma_kernel", "conv3d_bn_kernel", "fused_pair_wgmma_kernel", "fused_pair_kernel",
        "concat_kernel", "correlation_kernel", "upsample_softargmin_kernel")
    serve_work = ecmstereo.eval_work(kitti, 1)
    assert serve_work["flops"] == pytest.approx(1196.4338176e9, rel=1e-12)
    assert serve_work["port_bound_s"] == pytest.approx(0.0008535199955567311, rel=1e-12)
    train_work = ecmstereo.train_work(sceneflow)
    assert train_work["flops"] == pytest.approx(4464.45060096e9, rel=1e-12)
    assert train_work["port_bound_s"] == pytest.approx(0.001407046920024267, rel=1e-12)
