"""The IGEV-Stereo family: its FLOP count against ``FlopCounterMode`` over
the plain reference, the full-size figures and bounds, the weights recipe,
a run of ``igev_kitti_b1`` through the serving driver on the CPU at a tiny
size, and the three per-layer readers on hand-made windows."""

from __future__ import annotations

import copy
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from stereo_bench import counts, harness, run, synth
from stereo_bench import weights as W
from stereo_bench.families import family
from stereo_bench.families import igevstereo as fam
from stereo_bench.tests.tiny import tiny

CPU = torch.device("cpu")
CFG = harness.cell("igev_kitti_b1", harness.manifest())["config"]


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("h, w, max_disp, iters", [(64, 128, 64, 2), (96, 160, 96, 1)])
def test_eval_flops_match_the_counter(h, w, max_disp, iters):
    cfg = copy.deepcopy(CFG)
    cfg["shapes"].update(height=h, width=w, max_disp=max_disp, valid_iters=iters)
    model = fam.build(cfg, CPU)
    params = W.make_weights(model.state_dict(), cfg["weights"], 3, CPU)
    pair = synth.make_pairs(torch.Generator().manual_seed(1), 1, h, w, 1.0, 10.0, CPU)
    with FlopCounterMode(display=False) as counter:
        fam.infer(params, cfg, pair["left"], pair["right"], fam.EXACT)
    assert counter.get_total_flops() == fam.eval_flops(cfg)


def test_full_size_figures():
    """A 384x1248 pair: ~4.83 TFLOP, ~91 % of it in the 32 iterations of
    ~137 GFLOP; the lookup's 32 launches move 32 x 31.4 MB at float16
    output (~1,048 B a pixel), the volume's one 34.5 MB."""
    flops = fam.eval_flops(CFG)
    one = copy.deepcopy(CFG)
    one["shapes"]["valid_iters"] = 0
    assert flops == pytest.approx(4.825e12, rel=0.001)
    assert (flops - fam.eval_flops(one)) / 32 == pytest.approx(136.7e9, rel=0.001)
    assert (flops - fam.eval_flops(one)) / flops == pytest.approx(0.906, abs=0.001)
    form = fam.lookup_form(CFG, 1)
    assert form["bytes"] == 96 * 312 * (4 + 2 * 9 * 10 * 4 + 162 * 2)
    volume = fam.volume_form(CFG, 1)
    assert volume["bytes"] == 96 * 312 * (2 * 96 + 48 * 8) * 2
    work = fam.eval_work(CFG, 1)
    assert work["lookup_bound_s"] == 32 * form["bytes"] / counts.PEAK_BYTES_PER_S
    assert work["port_bound_s"] == work["lookup_bound_s"] + volume["bytes"] / counts.PEAK_BYTES_PER_S
    assert fam.KERNELS == ("geo_lookup_kernel", "correlation_kernel")


def test_seeded_weights_follow_the_recipe():
    """At 64x128: the same seed the same weights; every BatchNorm scale in
    ``bn_scale`` and shift in ``bn_shift`` (``norm3`` and ``downsample.1``
    one module); the transposed weights He-normal over their own fan-out;
    and on the calibration pair the initial disparity, the first update
    and the upsampling's logits at the file's spreads."""
    cfg = copy.deepcopy(CFG)
    cfg["shapes"].update(height=64, width=128, max_disp=64, valid_iters=2)
    template = fam.build(cfg, CPU).state_dict()
    params = fam.seeded_weights(cfg, template, 21, CPU)
    again = fam.seeded_weights(cfg, template, 21, CPU)
    assert all(torch.equal(params[k], again[k]) for k in params)
    spec = cfg["weights"]
    scales = fam._bn_scales(params)
    assert len(scales) == 105 + 4  # every BatchNorm, cnet's four shortcut norms under both names
    for k in scales:
        lo, hi = spec["bn_scale"]
        assert lo <= params[k].min() and params[k].max() <= hi, k
        lo, hi = spec["bn_shift"]
        bias = params[k[: -len("weight")] + "bias"]
        assert lo <= bias.min() and bias.max() <= hi, k
    assert torch.equal(params["cnet.layer2.0.norm3.weight"], params["cnet.layer2.0.downsample.1.weight"])
    deconv = params["cost_agg.conv3_up.conv.weight"]  # [48, 32, 4, 4, 4]: fan-out 32 x 64
    assert deconv.std().item() == pytest.approx((2 / (32 * 64)) ** 0.5, rel=0.1)
    pair = fam.calibration_pair(cfg, 21, CPU)
    with fam.R.strict_f32(), torch.inference_mode():
        out = fam._net(params, cfg, 1).forward(pair["left"], pair["right"])
    planes = torch.arange(out["logits"].shape[1], dtype=torch.float32).view(1, -1, 1, 1)
    init = (out["logits"].softmax(1) * planes).sum(1)
    assert init.std().item() == pytest.approx(spec["init_std"], rel=1e-3)
    assert out["deltas"][0].square().mean().sqrt().item() == pytest.approx(spec["delta_std"], rel=1e-3)
    assert out["upsampling_logits"].std(1).mean().item() == pytest.approx(spec["mask_std"], rel=1e-3)


def test_the_cell_serves_on_the_cpu():
    """``igev_kitti_b1`` cut to 64x128, max-disp 64 and 3 iterations, float32,
    through the harness and the serving driver: correct, traced, with the
    family's window."""
    spec = tiny("igev_kitti_b1")
    spec["config"]["shapes"]["valid_iters"] = 3
    assert family(spec["config"]) is fam
    line = run.measure(spec, 4_294_967_311, 1.0, True, CPU, time.perf_counter())
    assert line["correct"], line["checked"]
    assert line["attempted"] == spec["mix"]["trace_requests"] and line["failed"] == 0
    # the batch-1 serving metrics that read the host (on the CPU there is no device trace)
    assert {"mfu.b1", "graph_host_ms_per_pair.b1"} <= set(line["metrics"]) and list(line)[-1] == "checked"
    assert line["checked"]["disp_mae_px"]["value"] < 1e-4  # float32 against float32


LOOKUP = "void (anonymous namespace)::geo_lookup_kernel<__half>(...)"
VOLUME = "void (anonymous namespace)::correlation_kernel<__half, 16>(...)"
COPY = "Memcpy HtoD (Pageable -> Device)"


def _window(device, wall_us: float = 1000.0, requests: int = 2) -> dict:
    return {"device": device, "host": [], "wall_s": wall_us / 1e6, "t0": 0.0, "t1": wall_us, "requests": requests,
            "pairs": requests, "port_kernels": fam.KERNELS, "lookup_bound_s": 2 * 3 * 1e-6}


def _two_forwards() -> list:
    """Two forwards, each started by its host-to-device copies: the volume at
    50 us, three lookups from 90 us 10 us apart in the first; the volume at
    350 us, three lookups from 410 us 20 us apart in the second; each lookup
    2 us on the device."""
    dev = [(COPY, 0.0, 5.0, "gpu_memcpy"), (COPY, 5.0, 9.0, "gpu_memcpy"), (VOLUME, 50.0, 60.0, "kernel")]
    dev += [(LOOKUP, 90.0 + 10 * i, 92.0 + 10 * i, "kernel") for i in range(3)]
    dev += [("cudnn_conv", 93.0 + 10 * i, 98.0 + 10 * i, "kernel") for i in range(3)]
    dev += [(COPY, 300.0, 305.0, "gpu_memcpy"), (VOLUME, 350.0, 355.0, "kernel")]
    dev += [(LOOKUP, 410.0 + 20 * i, 412.0 + 20 * i, "kernel") for i in range(3)]
    return dev


def test_update_ms_per_iter_reads_lookup_to_lookup():
    """The gaps between lookups' starts inside a forward (not across the copy
    between forwards, and not from the volume's kernel, which is the port's
    too)."""
    reader = harness.metric_reader("update_ms_per_iter.igev")
    dev = _two_forwards()
    assert reader.iteration_us(_window(dev)) == [10.0] * 2 + [20.0] * 2
    assert reader.read([_window(dev)]) == pytest.approx(0.015)
    assert reader.read([_window([d for d in dev if d[0] != LOOKUP])]) is None  # a program without the kernel


def test_geometry_ms_per_pair_reads_volume_to_first_lookup():
    reader = harness.metric_reader("geometry_ms_per_pair.igev")
    dev = _two_forwards()
    assert reader.stage_us(_window(dev)) == [40.0, 60.0]
    assert reader.read([_window(dev)]) == pytest.approx(0.05)
    assert reader.read([_window([d for d in dev if d[0] != VOLUME])]) is None
    assert reader.read([_window([d for d in dev if d[0] != LOOKUP])]) is None


def test_geo_lookup_roofline_reads_the_lookups_alone():
    """The window's lookup bound (6 us) over the lookups' device time (six
    launches of 2 us): 50 %; the volume's kernel is not counted."""
    reader = harness.metric_reader("geo_lookup_roofline_pct.igev")
    dev = _two_forwards()
    assert reader.read([_window(dev)]) == pytest.approx(50.0)
    assert reader.read([_window([d for d in dev if d[0] != LOOKUP])]) is None
