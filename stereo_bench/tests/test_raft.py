"""The RAFT-Stereo family: its FLOP count against ``FlopCounterMode`` over
the plain reference, a run of ``raft_kitti_b1`` through the serving driver
on the CPU at a tiny size, the lookup's bound, and ``update_ms_per_iter.raft``
on a hand-made window."""

from __future__ import annotations

import copy
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from stereo_bench import counts, harness, run, synth
from stereo_bench import weights as W
from stereo_bench.families import family
from stereo_bench.families import raftstereo as fam
from stereo_bench.tests.tiny import tiny

CPU = torch.device("cpu")
CFG = harness.cell("raft_kitti_b1", harness.manifest())["config"]


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("h, w, iters", [(64, 128, 2), (96, 160, 1)])
def test_eval_flops_match_the_counter(h, w, iters):
    cfg = copy.deepcopy(CFG)
    cfg["shapes"].update(height=h, width=w, valid_iters=iters)
    model = fam.build(cfg, CPU)
    params = W.make_weights(model.state_dict(), cfg["weights"], 3, CPU)
    pair = synth.make_pairs(torch.Generator().manual_seed(1), 1, h, w, 1.0, 10.0, CPU)
    with FlopCounterMode(display=False) as counter:
        fam.infer(params, cfg, pair["left"], pair["right"], fam.EXACT)
    assert counter.get_total_flops() == fam.eval_flops(cfg)


def test_full_size_figures():
    """A 384x1248 pair: ~5.8 TFLOP, 85 % of it in the 32 iterations; the
    lookup's 32 launches move 32 x 7.07 MB at float16 output."""
    flops = fam.eval_flops(CFG)
    one = copy.deepcopy(CFG)
    one["shapes"]["valid_iters"] = 0
    assert flops == pytest.approx(5.82e12, rel=0.01)
    assert (flops - fam.eval_flops(one)) / flops == pytest.approx(0.85, abs=0.01)
    form = fam.lookup_form(CFG, 1)
    assert form["bytes"] == 96 * 312 * (4 + 4 * 10 * 4 + 36 * 2)
    work = fam.eval_work(CFG, 1)
    assert work["port_bound_s"] == 32 * form["bytes"] / counts.PEAK_BYTES_PER_S
    assert fam.KERNELS == ("corr1d_lookup_kernel",)


def test_the_cell_serves_on_the_cpu():
    """``raft_kitti_b1`` cut to 64x128 and 4 iterations, float32, through the
    harness and the serving driver: correct, traced, with the family's
    window."""
    spec = tiny("raft_kitti_b1")
    spec["config"]["shapes"]["valid_iters"] = 4
    assert family(spec["config"]) is fam
    line = run.measure(spec, 4_294_967_311, 1.0, True, CPU, time.perf_counter())
    assert line["correct"], line["checked"]
    assert line["attempted"] == spec["mix"]["trace_requests"] and line["failed"] == 0
    # the batch-1 serving metrics that read the host (on the CPU there is no device trace)
    assert {"mfu.b1", "graph_host_ms_per_pair.b1"} <= set(line["metrics"]) and list(line)[-1] == "checked"
    assert line["checked"]["disp_mae_px"]["value"] < 1e-4  # float32 against float32


def _window(device, wall_us: float = 1000.0) -> dict:
    return {"device": device, "host": [], "wall_s": wall_us / 1e6, "t0": 0.0, "t1": wall_us, "pairs": 2,
            "port_kernels": fam.KERNELS}


def test_update_ms_per_iter_reads_lookup_to_lookup():
    """Two forwards, each started by its host-to-device copies: the lookups'
    starts 10 us apart in the first and 20 us in the second; the gap across
    the copy between forwards is not an iteration."""
    lookup = "void (anonymous namespace)::corr1d_lookup_kernel<4, __half>(...)"
    dev = [("Memcpy HtoD (Pageable -> Device)", 0.0, 5.0, "gpu_memcpy"),
           ("Memcpy HtoD (Pageable -> Device)", 5.0, 9.0, "gpu_memcpy")]
    dev += [(lookup, 100.0 + 10 * i, 102.0 + 10 * i, "kernel") for i in range(4)]
    dev += [("cudnn_conv", 103.0 + 10 * i, 108.0 + 10 * i, "kernel") for i in range(4)]
    dev += [("Memcpy HtoD (Pageable -> Device)", 300.0, 305.0, "gpu_memcpy")]
    dev += [(lookup, 400.0 + 20 * i, 402.0 + 20 * i, "kernel") for i in range(3)]
    reader = harness.metric_reader("update_ms_per_iter.raft")
    assert reader.iteration_us(_window(dev)) == [10.0] * 3 + [20.0] * 2
    assert reader.read([_window(dev)]) == pytest.approx(0.014)
    assert reader.read([_window([d for d in dev if d[0] != lookup])]) is None  # a program without the kernel


def test_lower_precision_runs_the_cell_with_the_program_in_that_dtype(monkeypatch):
    """``lower_precision.run`` serves the cell with the program built in the
    dtype asked for, leaves the spec it was given as it was, and prints
    ``calibrate``'s program line: at 64x128 and 4 iterations a bfloat16 build
    already reads far above the float32 one."""
    from stereo_bench import lower_precision

    spec = tiny("raft_kitti_b1")
    spec["config"]["shapes"]["valid_iters"] = 4
    built = []
    build = fam.build
    monkeypatch.setattr(fam, "build", lambda cfg, device: built.append(cfg["dtype"]) or build(cfg, device))
    line = lower_precision.run(spec, "bfloat16", 4_294_967_311, 0.5, CPU)
    assert spec["config"]["dtype"] == "float32" and set(built) == {"bfloat16"}
    assert (line["workload"], line["dtype"]) == ("raft_kitti_b1", "bfloat16")
    # the float32 program reads below 1e-4; bfloat16 about 0.016 at this size
    assert line["program"]["disp_mae_px"] > 20 * 1e-4
