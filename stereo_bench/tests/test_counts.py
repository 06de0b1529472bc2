"""The benchmark's work counts against ``FlopCounterMode`` over the plain
reference, at small sizes on the CPU, and the bounds of the program's
forms."""

from __future__ import annotations

import copy
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from stereo_bench import counts, harness, synth
from stereo_bench import weights as W
from stereo_bench.families import ecmstereo
from stereo_bench.reference import ecm as R

KITTI = json.loads((harness.HERE / "configs" / "ecm_kitti.json").read_text())


def model_and_weights(width: int):
    torch.set_num_threads(2)
    cfg = copy.deepcopy(KITTI)
    cfg["shapes"]["feature_channels"] = width
    model = ecmstereo.build(cfg, torch.device("cpu"))
    return model, W.make_weights(model.state_dict(), cfg["weights"], 3, torch.device("cpu"))


@pytest.fixture(scope="module")
def params():
    return model_and_weights(KITTI["shapes"]["feature_channels"])


@pytest.mark.parametrize("h, w, max_disp", [(64, 128, 48), (32, 160, 16)])
def test_eval_flops_match_the_counter(params, h, w, max_disp):
    _, p = params
    pair = synth.make_pairs(torch.Generator().manual_seed(1), 1, h, w, 1.0, 10.0, torch.device("cpu"))
    with FlopCounterMode(display=False) as counter:
        R.infer(p, max_disp, pair["left"], pair["right"])
    assert counter.get_total_flops() == counts.eval_flops(h, w, max_disp)


def test_eval_flops_follow_the_width():
    """A configuration of another feature width: the counts take the
    file's width, as the model and the reference do."""
    _, p = model_and_weights(16)
    pair = synth.make_pairs(torch.Generator().manual_seed(1), 1, 32, 64, 1.0, 8.0, torch.device("cpu"))
    with FlopCounterMode(display=False) as counter:
        R.infer(p, 16, pair["left"], pair["right"])
    assert counter.get_total_flops() == counts.eval_flops(32, 64, 16, 16) != counts.eval_flops(32, 64, 16)


def test_train_flops_match_the_counter(params):
    model, p = params
    h, w, max_disp, batch = 32, 64, 16, 2
    pair = synth.make_pairs(torch.Generator().manual_seed(2), batch, h, w, 1.0, 12.0, torch.device("cpu"))
    with FlopCounterMode(display=False) as counter:
        R.train_steps(p, W.trainable(model), max_disp, 1e-3, [pair])
    assert counter.get_total_flops() == counts.train_flops(batch, h, w, max_disp)


def test_full_size_figures():
    """The figures PERF.md records: an eval pair at 384x1248 and a train
    step of 4x256x512, max-disp 192."""
    assert counts.eval_flops(384, 1248, 192) == pytest.approx(1196.4338176e9)
    assert counts.train_flops(4, 256, 512, 192) == pytest.approx(4464.45060096e9)


def test_form_bounds():
    """Every eval form of the grouped path and every train form has a
    positive bound; the convolutions are bound by their operations, the
    volume by its bytes, the regression by its exponentials."""
    forms = counts.eval_forms(8, 384, 1248, 192)
    assert len(forms) == 13
    for name, f in forms.items():
        t = counts.bound_s(f)
        assert t > 0
        if name.startswith(("conv3d_bn_s1.dres0_1", "fused_conv3d_pair")):
            assert t == f["ops"] / counts.PEAK_BF16_FLOPS
    assert counts.bound_s(forms["cost_volume_concat"]) == forms["cost_volume_concat"]["bytes"] / counts.PEAK_BYTES_PER_S
    reg = forms["fused_upsample_softargmin"]
    assert counts.bound_s(reg) == reg["exps"] / counts.PEAK_EXP_PER_S
    train = counts.train_forms(4, 256, 512, 192)
    assert len(train) == 14
    # the dres0_1 forward and its input gradient do the same work
    assert train["gband_conv_s1.dres0_1"] == train["gband_conv_s1_input_grad.dres0_1"]
