"""``ecm_torch.utils.profiling`` against ``ecm_tpu.utils.profiling``: the
FLOP and byte models equal the reference's at every shape, head count,
regression mode and activation width; ``timed`` and ``trace`` on the CPU;
and the FLOP model's terms against ``torch.utils.flop_counter`` on a small
plain forward, which shows where the formula over-counts."""

import glob
import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from ecm_torch.configs import CONFIGS
from ecm_torch.utils import profiling
from ecm_tpu.utils import profiling as ref

SHAPES = {  # (h, w, max_disp, c)
    "kitti_384x1248_d192": (384, 1248, 192, 32),
    "sceneflow_256x512_d192": (256, 512, 192, 32),
    "overfit_128x256_d48": (128, 256, 48, 32),
    "small_64x128_d64_c8": (64, 128, 64, 8),
}
REGRESS_MODES = ("fullres", "fused", "lowres")  # every branch of both models
PLAIN = dict(agg_layout="standard", agg_fused="off", use_pallas=False, regress_mode="fullres")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    from test_torch_port_util import torch_threads

    with torch_threads(1):
        yield


@pytest.mark.parametrize("regress_mode", REGRESS_MODES)
@pytest.mark.parametrize("num_heads", (1, 3))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_models_equal_the_reference(shape, num_heads, regress_mode):
    h, w, max_disp, c = SHAPES[shape]
    kw = dict(c=c, num_heads=num_heads, regress_mode=regress_mode)
    got = profiling.flops_stereo_parts(h, w, max_disp, **kw)
    want = ref.flops_stereo_parts(h, w, max_disp, **kw)
    assert list(got) == list(want)
    assert all(got[k] == want[k] for k in want), (got, want)
    for act_bytes in (2, 4):
        got = profiling.bytes_stereo_parts(h, w, max_disp, act_bytes=act_bytes, **kw)
        want = ref.bytes_stereo_parts(h, w, max_disp, act_bytes=act_bytes, **kw)
        assert list(got) == list(want)
        assert all(got[k] == want[k] for k in want), (act_bytes, got, want)
    for blocks in (16, 4):
        assert profiling.flops_stereo_forward(h, w, max_disp, c=c, layer2_blocks=blocks) == (
            ref.flops_stereo_forward(h, w, max_disp, c=c, layer2_blocks=blocks))


def test_timed_is_the_mean_over_iters_after_warmup():
    calls = []

    def fn(x):
        calls.append(x)
        return {"out": [torch.ones(2)]}

    s = profiling.timed(fn, 7, iters=5, warmup=3)
    assert calls == [7] * 8
    assert s > 0


def test_trace_on_the_cpu_writes_a_trace(tmp_path):
    with profiling.trace(logdir=str(tmp_path), device="cpu") as logdir:
        torch.randn(32, 32) @ torch.randn(32, 32)
    assert logdir == str(tmp_path)
    (path,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    events = json.load(open(path))["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)


def test_trace_without_gpu_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with profiling.trace(logdir=str(tmp_path)):
            pass
    assert not os.listdir(tmp_path)


def formula_terms(h: int, w: int, max_disp: int, c: int) -> dict:
    """The terms of ``ecm_tpu/utils/profiling.py:72-86`` (num_heads 1), one
    per module of the model; ``conv1``..``conv6`` are one hourglass's."""
    n = (max_disp // 4) * (h // 4) * (w // 4)
    return {
        "context": 2 * 9 * c * 128 * (h // 4) * (w // 4) + 2 * 128 * c * (h // 4) * (w // 4),
        "dres0_1": 2 * 27 * 64 * c * n, "dres0_2": 2 * 27 * c * c * n,
        "dres1_1": 2 * 27 * c * c * n, "dres1_2": 2 * 27 * c * c * n,
        "conv1": 2 * 27 * c * 2 * c * n / 8, "conv2": 2 * 27 * 4 * c * c * n / 8,
        "conv3": 2 * 27 * 4 * c * c * n / 64, "conv4": 2 * 27 * 4 * c * c * n / 64,
        "conv5": 2 * 27 * 4 * c * c * n / 8, "conv6": 2 * 27 * 2 * c * c * n,
        "classif3": 2 * 27 * c * c * n + 2 * 27 * c * 1 * n,
    }


def conv_flops(counts: dict, module: str) -> int:
    return int(counts[f"ECMStereo.{module}"].get(torch.ops.aten.convolution, 0))


@pytest.mark.parametrize("c", (8, 32))
def test_flop_model_against_the_counter(c):
    """One f32 eval forward of the plain standard path at 64x128, max-disp
    64 (D/16, H/16, W/16 whole), convolutions counted per module by
    ``FlopCounterMode``. The formula's terms sum to its parts; the counter
    equals them where the formula is right (context, dres0_2, dres1, the
    hourglasses' conv1-conv4, the head), and shows its over-counts: the
    transposed convs at 8x (``:82-83``, counted at the output voxels) and
    dres0_1 at c != 32 (``:76`` takes the volume's 2c channels as 64). The
    feature extractor cannot be matched term by term (its SPP branches run
    on pooled maps; ``:56-63`` counts 27 taps where a 2D 3x3 conv has 9 and
    leaves out the 1x1 downsample convs): its ratio is printed."""
    h, w, max_disp = 64, 128, 64
    model = CONFIGS["kitti_infer"].model.build(
        device="cpu", generator=torch.Generator().manual_seed(0), max_disp=max_disp,
        feature_channels=c, dtype=torch.float32, **PLAIN)
    gen = torch.Generator().manual_seed(1)
    left, right = (torch.randn(1, h, w, 3, generator=gen) for _ in range(2))
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        model(left, right)
    counts = counter.get_flop_counts()
    terms = formula_terms(h, w, max_disp, c)
    parts = ref.flops_stereo_parts(h, w, max_disp, c=c, num_heads=1)
    hg = sum(terms[f"conv{i}"] for i in range(1, 7))
    assert sum(terms[k] for k in ("dres0_1", "dres0_2", "dres1_1", "dres1_2")) + 3 * hg == parts["aggregation"]
    assert terms["classif3"] == parts["heads"] and 4 * terms["context"] == parts["context"]

    for site in range(4):
        assert conv_flops(counts, f"aggregation.context{site}") == terms["context"]
    for name in ("dres0_2", "dres1_1", "dres1_2"):
        assert conv_flops(counts, f"aggregation.{name}") == terms[name], name
    dres0_1 = conv_flops(counts, "aggregation.dres0_1")
    assert dres0_1 * 64 == terms["dres0_1"] * 2 * c, (
        "ecm_tpu/utils/profiling.py:76 counts dres0_1's input at 64 channels; the volume has 2c")
    assert conv_flops(counts, "aggregation.classif3") == terms["classif3"]
    for i in range(1, 4):
        for k in range(1, 5):
            assert conv_flops(counts, f"aggregation.hourglass{i}.conv{k}") == terms[f"conv{k}"], (i, k)
        for k in (5, 6):
            got = conv_flops(counts, f"aggregation.hourglass{i}.conv{k}")
            assert got * 8 == terms[f"conv{k}"], (
                f"hourglass{i}.conv{k}: counter {got}, formula {terms[f'conv{k}']}: "
                "ecm_tpu/utils/profiling.py:82-83 counts the transposed convs at their output voxels, 8x")
    features = conv_flops(counts, "feature")
    print(f"c={c}: features formula {parts['features']:.4g} FLOPs, counter {features:.4g}, "
          f"ratio {parts['features'] / features:.3f}")
