"""RAFT-Stereo in the port (``ecm_torch/models/raft_stereo.py``,
``ecm_torch/ops/cuda_corr1d.py``) on the CPU, at the published widths and a
small size (2x64x128, 3 iterations, float32) on the benchmark's seeded
weights: the forward against the plain reference
``stereo_bench/reference/raftstereo.py``, the plain lookup against the
equation, a forward on ``meta`` tensors (nothing read on the host), the
channels-last layout of every convolution's input and weight, the dtype
and layout the benchmark's build leaves the weights in, the
channels-last instance norm against ``F.instance_norm``, the published
state-dict names, the spans, the configuration's build and the ``test_img``
CLI."""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image
from torch import nn
from torch.profiler import ProfilerActivity, profile

from ecm_torch.cli import test_img
from ecm_torch.configs import CONFIGS
from ecm_torch.models import RAFTStereo, build_model, raft_stereo
from ecm_torch.ops import conv_gru, launches
from ecm_torch.ops.cuda_corr1d import corr1d_lookup, corr1d_lookup_torch, corr_pyramid
from ecm_torch.ops.instance_norm import instance_norm
from stereo_bench import harness, synth
from stereo_bench.weights import make_weights
from stereo_bench.families import raftstereo as fam

CPU = torch.device("cpu")
CL = torch.channels_last
H, W, ITERS = 64, 128, 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small_cfg() -> dict:
    cfg = copy.deepcopy(json.loads((harness.HERE / "configs" / "raft_kitti.json").read_text()))
    cfg["shapes"].update(height=H, width=W, valid_iters=ITERS)
    cfg["dtype"] = "float32"
    return cfg


@pytest.fixture(scope="module")
def model_and_params():
    cfg = small_cfg()
    model = fam.build(cfg, CPU)
    params = fam.seeded_weights(cfg, model.state_dict(), 11, CPU)
    model.load_state_dict(params)
    return cfg, model, params


@pytest.mark.parametrize("seed", [1, 2])
def test_forward_matches_the_reference(model_and_params, seed):
    """Both in float32: the same operations, summed in other orders (the
    BatchNorm and instance-norm formulas, the correlation's matmul against
    ``einsum``), which 3 iterations carry into the flow; observed at most
    8.1e-6 px over 6 seeds of disparities ~1 px, so 5e-5 px. A float16
    program misses by ~1e-2 px."""
    cfg, model, params = model_and_params
    pair = synth.make_pairs(torch.Generator().manual_seed(seed), 2, H, W, 1.0, 12.0, CPU)
    with torch.inference_mode():
        out = model(pair["left"], pair["right"])
    ref = fam.infer(params, cfg, pair["left"], pair["right"], fam.EXACT)
    assert len(out) == 1 and out[-1].shape == (2, H, W) and out[-1].dtype == torch.float32
    assert ref.abs().mean() > 0.1  # the iterations moved the flow
    torch.testing.assert_close(out[-1], ref, rtol=0, atol=5e-5)


def test_every_convolution_reads_channels_last(model_and_params, monkeypatch):
    """Every convolution of a forward (both encoders, the context convs, each
    iteration's) gets a channels-last input and weight, so cuDNN's NHWC
    convolutions transpose nothing, and every ``nn.Conv2d``'s weight reaches
    one: each GRU's ``convz`` and ``convr`` stacked into one bias-free
    convolution, its ``convq`` bias-free (the gates and the update add their
    biases), once an iteration; and each convolution that an eval BatchNorm
    of ``cnet`` follows bias-free (the epilogue of ``ops/bn_act.py`` adds
    its bias), ``fnet``'s, before instance norms, with its bias.
    ``is_contiguous(memory_format=...)`` ignores size-1 dimensions, so 1x1
    weights and 1-pixel maps pass as they are."""
    _, model, _ = model_and_params
    seen, real = [], F.conv2d

    def spy(x, weight, bias=None, *args, **kwargs):
        seen.append((weight, bias, x.is_contiguous(memory_format=CL), weight.is_contiguous(memory_format=CL)))
        return real(x, weight, bias, *args, **kwargs)

    monkeypatch.setattr(F, "conv2d", spy)
    pair = synth.make_pairs(torch.Generator().manual_seed(5), 1, H, W, 1.0, 12.0, CPU)
    with torch.inference_mode():
        model(pair["left"], pair["right"])
    names = {m: n for n, m in model.named_modules() if isinstance(m, nn.Conv2d)}
    ub = model.update_block
    stacked = {g: torch.cat([g.convz.weight, g.convr.weight]) for g in (ub.gru08, ub.gru16, ub.gru32)}
    blocks = [m for m in model.cnet.modules() if isinstance(m, raft_stereo.ResidualBlock)]
    bias_free = {m for g in stacked for m in (g.convz, g.convr, g.convq)} | {model.cnet.conv1} | {
        m for blk in blocks for m in (blk.conv1, blk.conv2, *(blk.downsample or ())[:1])}
    assert len(bias_free) == 9 + 1 + 28 + 4
    reached, bad = [], []
    for w, b, x_cl, w_cl in seen:
        parts = [m for m in names if w is m.weight] or [
            m for g, s in stacked.items() if torch.equal(w, s) for m in (g.convz, g.convr)]
        assert parts and (b is None) == (parts[0] in bias_free), [names[m] for m in parts]
        reached.append(parts)
        if not (x_cl and w_cl):
            bad.append(([names[m] for m in parts], x_cl, w_cl))
    assert {m for parts in reached for m in parts} == set(names)  # every convolution's weight was read
    assert sum(parts == [ub.gru08.convz, ub.gru08.convr] for parts in reached) == ITERS
    assert sum(parts == [ub.gru08.convq] for parts in reached) == ITERS
    assert not bad


@pytest.mark.parametrize("dtype", ["float16", "float32"])
def test_the_benchmarks_build_holds_convolutions_in_the_served_dtype(dtype):
    """The benchmark's path (``families/raftstereo.build``: the model on
    ``meta``, ``to_empty``, then ``load_state_dict`` of float32 tensors):
    every convolution's weight and bias is in the configuration's dtype,
    the weight channels-last, each equal to the loaded tensor cast to that
    dtype; every BatchNorm's parameters and statistics stay float32."""
    cfg = small_cfg()
    cfg["dtype"] = dtype
    model = fam.build(cfg, CPU)
    params = make_weights(model.state_dict(), cfg["weights"], 5, CPU)
    assert all(v.dtype == torch.float32 for v in params.values() if v.is_floating_point())
    model.load_state_dict(params)
    want = fam.DTYPES[dtype]
    convs = {n: m for n, m in model.named_modules() if isinstance(m, nn.Conv2d)}
    norms = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    assert len(convs) == 76 and norms
    for n, m in convs.items():
        assert m.weight.dtype == m.bias.dtype == want and m.weight.is_contiguous(memory_format=CL), n
        assert torch.equal(m.weight, params[f"{n}.weight"].to(want)), n
        assert torch.equal(m.bias, params[f"{n}.bias"].to(want)), n
    for m in norms:
        assert all(t.dtype == torch.float32 for t in (m.weight, m.bias, m.running_mean, m.running_var))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_instance_norm_keeps_channels_last(dtype):
    """Against ``F.instance_norm``: in float32 to float32 rounding; in
    float16 within one float16 rounding of ``F.instance_norm`` in float32,
    cast (both compute float32 statistics of the same float16 values and
    round once). The result stays channels-last, where the library's
    returns NCHW."""
    g = torch.Generator().manual_seed(5)
    x = 3 * torch.randn(2, 24, 9, 13, generator=g) + 4 * torch.randn(2, 24, 1, 1, generator=g)
    x = x.to(dtype, memory_format=CL)
    got = instance_norm(x)
    assert got.dtype == dtype and got.is_contiguous(memory_format=CL) and not got.is_contiguous()
    ref = F.instance_norm(x.float())
    if dtype == torch.float32:
        eps = torch.finfo(torch.float32).eps
        torch.testing.assert_close(got, ref, rtol=4 * eps, atol=4 * eps * ref.abs().max().item())
    else:
        ref = ref.to(dtype).float()
        ulp = torch.finfo(dtype).eps * torch.maximum(ref.abs(), torch.tensor(2.0**-14))
        assert ((got.float() - ref).abs() <= ulp).all()


def published_cell(g: raft_stereo.ConvGRU, h, cz, cr, cq, *xs, dtype=torch.float32) -> torch.Tensor:
    """The published ConvGRU in ``dtype`` on copies of ``g``'s weights and of
    the maps in it: three channel ``cat``s, three biased convolutions,
    sigmoid and tanh, then ``(1 - z) h + z q``, each rounded to ``dtype``."""
    conv = lambda m, x: F.conv2d(x, m.weight.to(dtype), m.bias.to(dtype), 1, 1)  # noqa: E731
    h, cz, cr, cq, *xs = (t.to(dtype) for t in (h, cz, cr, cq, *xs))
    x = torch.cat(xs, 1)
    hx = torch.cat([h, x], 1)
    z = torch.sigmoid(conv(g.convz, hx) + cz)
    r = torch.sigmoid(conv(g.convr, hx) + cr)
    q = torch.tanh(conv(g.convq, torch.cat([r * h, x], 1)) + cq)
    return (1 - z) * h + z * q


# each level's state and inputs (gru08 at 1/4: the motion features and
# gru16's state; gru16: the pooled gru08 and the upsampled gru32; gru32: the
# pooled gru16), at 1/4, 1/8, 1/16 of a 32x48 image
GRU_LEVELS = {"gru08": ((128, 128), (8, 12)), "gru16": ((128, 128), (4, 6)), "gru32": ((128,), (2, 3))}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("level", GRU_LEVELS)
def test_conv_gru_cell_is_the_published_formula(level, dtype):
    """The new cell (the pack, one bias-free convolution of the stacked z and
    r weights, the gates, a bias-free ``convq``, the update; plain versions
    on the CPU) against :func:`published_cell` on the same values: in
    float32 to float32 rounding; in float16 within 2**-10 (a float16 unit in
    the last place at 1, the state's bound: the cell rounds the
    convolutions' outputs, ``z``, ``r h`` and the state once each), and on
    average nearer float32 than the published formula computed in float16,
    which rounds after each step. Its output stays channels-last."""
    inputs, (hh, ww) = GRU_LEVELS[level]
    g = torch.Generator().manual_seed(7)
    cell = raft_stereo.ConvGRU(128, sum(inputs))
    with torch.no_grad():
        for m in (cell.convz, cell.convr, cell.convq):
            m.weight.copy_(torch.randn(m.weight.shape, generator=g) / m.weight[0].numel() ** 0.5)
            m.bias.copy_(0.5 * torch.randn(m.bias.shape, generator=g))
    cell.to(dtype, memory_format=CL)
    rnd = lambda c: torch.randn(2, c, hh, ww, generator=g).to(dtype, memory_format=CL)  # noqa: E731
    h = torch.tanh(2 * rnd(128))
    maps = (h, rnd(128), rnd(128), rnd(128), *(rnd(c) for c in inputs))
    with torch.inference_mode():
        got = cell(maps[0], cell.zr_weight(), *maps[1:])
        ref = published_cell(cell, *maps)
    assert got.dtype == dtype and got.shape == h.shape and got.is_contiguous(memory_format=CL)
    err = (got.float() - ref).abs()
    if dtype == torch.float32:
        eps = torch.finfo(torch.float32).eps
        torch.testing.assert_close(got, ref, rtol=4 * eps, atol=4 * eps)
        return
    assert err.max() <= 2.0**-10, err.max()
    with torch.inference_mode():
        rounded = published_cell(cell, *maps, dtype=dtype)
    assert err.mean() < (rounded.float() - ref).abs().mean()


@pytest.mark.parametrize("pixels, channels, block_p", [
    (29952, 128, 32), (7488, 128, 32), (1872, 128, 8),  # every kernel of the cell at 1/4, 1/8, 1/16
    (29952, 384, 8), (1872, 256, 8),  # wider rows than the cell's: TILE caps the rows of a program
    (1, 128, 1), (100003, 96, 32)])  # one row; a ragged count of rows and of channels
def test_conv_gru_tiles_follow_the_shapes(pixels, channels, block_p):
    """A program takes every channel of ``BLOCK_P`` rows: at most ``TILE``
    elements of a map, and few rows enough that a small map still gives
    two programs an SM on 132 SMs; powers of two, as ``tl.arange`` needs."""
    got_p, block_c = conv_gru.plan(pixels, channels, 132)
    assert (got_p, block_c) == (block_p, 1 << (channels - 1).bit_length())
    assert got_p * block_c <= conv_gru.TILE or got_p == 1
    programs = -(-pixels // got_p)
    assert programs >= min(2 * 132, -(-pixels // (conv_gru.TILE // block_c)))


def the_equation(pyramid: list[torch.Tensor], coords: torch.Tensor, radius: int) -> torch.Tensor:
    """The lookup written out: for level i, tap k, position x = c / 2**i + k,
    ``v(x0) (x0 + 1 - x) + v(x0 + 1) (x - x0)`` with v 0 outside the row."""
    out = []
    for i, level in enumerate(pyramid):
        w = level.shape[-1]
        for k in range(-radius, radius + 1):
            x = coords[:, 0] / 2**i + k
            x0 = x.floor()
            v = lambda p: torch.where((p >= 0) & (p < w), level.gather(-1, p.clamp(0, w - 1).long()[..., None])[..., 0],  # noqa: E731
                                      torch.zeros_like(x))
            out.append(v(x0) * (x0 + 1 - x) + v(x0 + 1) * (x - x0))
    return torch.stack(out, 1)


CASES = {
    "inside": lambda x, w: x - 3.3,
    "border": lambda x, w: torch.where(x < w / 2, torch.zeros_like(x), torch.full_like(x, w - 1.0)),
    "in (-1, 0)": lambda x, w: torch.full_like(x, -0.5) - 0.4 * (x / w),
    "beyond W_i": lambda x, w: x + w + 0.25,
}


@pytest.mark.parametrize("case", CASES)
def test_plain_lookup_is_the_equation(case):
    """At x = -0.5 the value is half of the row's first; past a level's end
    every tap reads 0 (4 levels of a 128-wide row: widths 128, 64, 32, 16)."""
    g = torch.Generator().manual_seed(4)
    f1, f2 = torch.randn(2, 16, 3, 128, generator=g), torch.randn(2, 16, 3, 128, generator=g)
    pyramid = corr_pyramid(f1, f2, 4)
    x = torch.arange(128.0).expand(2, 1, 3, 128)
    coords = torch.cat([CASES[case](x, 128), torch.zeros_like(x)], 1)
    got = corr1d_lookup(pyramid, coords, 4)
    assert got.shape == (2, 36, 3, 128)
    # grid_sample maps x to [-1, 1] and back: x moves by up to ~4 float32
    # units in the last place of the row's width, times the row's slope
    # (at most twice its largest value)
    slope = 2 * pyramid[0].abs().max().item()
    torch.testing.assert_close(got, the_equation(pyramid, coords, 4), rtol=0,
                               atol=4 * torch.finfo(torch.float32).eps * 128 * slope)
    if case == "in (-1, 0)":
        half = corr1d_lookup_torch(pyramid, torch.full_like(coords, -0.5), 4)[:, 4]
        torch.testing.assert_close(half, 0.5 * pyramid[0][..., 0], rtol=0, atol=1e-6)


def test_forward_on_meta_reads_nothing_on_the_host():
    """Every shape, the pyramid and 32 iterations on ``meta`` tensors: a
    value read on the host (``.item()``, a ``unique`` assert) or a copy
    from it would raise."""
    with torch.device("meta"):
        model = RAFTStereo(iters=32)
        left, right = torch.empty(1, 384, 1248, 3), torch.empty(1, 384, 1248, 3)
        with torch.inference_mode():
            (disp,) = model(left, right)
    assert disp.device.type == "meta" and disp.shape == (1, 384, 1248) and disp.dtype == torch.float32


def _block(prefix: str, norm: bool, shortcut: bool) -> list[str]:
    """A published ResidualBlock's entries (BatchNorm's five where ``norm``;
    instance norm has none); its shortcut's norm under both names."""
    bn = ["weight", "bias", "running_mean", "running_var", "num_batches_tracked"] if norm else []
    norms = ["norm1", "norm2"] + (["norm3", "downsample.1"] if shortcut else [])
    convs = ["conv1", "conv2"] + (["downsample.0"] if shortcut else [])
    return [f"{prefix}.{c}.{p}" for c in convs for p in ("weight", "bias")] + [
        f"{prefix}.{n}.{p}" for n in norms for p in bn]


# the published module tree at the evaluation defaults
TRUNK = [("layer1.0", False), ("layer1.1", False), ("layer2.0", True), ("layer2.1", False), ("layer3.0", True),
         ("layer3.1", False)]
CNET_BLOCKS = TRUNK + [("layer4.0", True), ("layer4.1", False), ("layer5.0", True), ("layer5.1", False),
                       ("outputs08.0.0", False), ("outputs08.1.0", False), ("outputs16.0.0", False),
                       ("outputs16.1.0", False)]
CONVS = ["fnet.conv1", "fnet.conv2", "cnet.conv1", "cnet.outputs08.0.1", "cnet.outputs08.1.1", "cnet.outputs16.0.1",
         "cnet.outputs16.1.1", "cnet.outputs32.0", "cnet.outputs32.1", "context_zqr_convs.0", "context_zqr_convs.1",
         "context_zqr_convs.2", "update_block.encoder.convc1", "update_block.encoder.convc2",
         "update_block.encoder.convf1", "update_block.encoder.convf2", "update_block.encoder.conv",
         *(f"update_block.gru{lvl}.conv{g}" for lvl in ("08", "16", "32") for g in "zrq"),
         "update_block.flow_head.conv1", "update_block.flow_head.conv2", "update_block.mask.0", "update_block.mask.2"]


def test_state_dict_names_are_the_published():
    names = [f"{c}.{p}" for c in CONVS for p in ("weight", "bias")]
    names += [f"cnet.norm1.{p}" for p in ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")]
    names += [n for b, s in TRUNK for n in _block(f"fnet.{b}", False, s)]
    names += [n for b, s in CNET_BLOCKS for n in _block(f"cnet.{b}", True, s)]
    with torch.device("meta"):
        sd = RAFTStereo().state_dict()
    assert sorted(sd) == sorted(names) and len(sd) == 337
    assert sd["update_block.encoder.convc1.weight"].shape == (64, 36, 1, 1)
    assert sd["update_block.gru08.convz.weight"].shape == (128, 384, 3, 3)
    assert sd["update_block.mask.2.weight"].shape == (144, 256, 1, 1)
    assert sd["fnet.conv1.weight"].shape == (64, 3, 7, 7)


def test_spans_one_update_an_iteration(model_and_params):
    """The eager forward's spans: ``ecm.raft.encode``, ``.volume``, one
    ``.update`` an iteration, ``.upsample``; on CPU tensors no kernel
    launches."""
    _, model, _ = model_and_params
    pair = synth.make_pairs(torch.Generator().manual_seed(3), 1, H, W, 1.0, 12.0, CPU)
    launches.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof, torch.inference_mode():
        model(pair["left"], pair["right"])
    names = [e.name for e in sorted(prof.events(), key=lambda e: e.time_range.start) if e.name.startswith("ecm.raft.")]
    assert names == ["ecm.raft.encode", "ecm.raft.volume", *["ecm.raft.update"] * ITERS, "ecm.raft.upsample"]
    assert launches.read_counts() == dict.fromkeys(launches.COUNTERS, 0)


def test_configuration_builds_raft_with_its_own_arguments():
    """``ModelConfig.build`` hands RAFT-Stereo none of ECM's knobs: the
    published sizes, float16 where ``bf16`` is set, float32 without."""
    cfg = dataclasses.replace(CONFIGS["kitti_infer"].model, name="raft_stereo")
    with torch.device("meta"):
        half = cfg.build(device="meta", generator=torch.Generator())
        full = dataclasses.replace(cfg, bf16=False).build(device="meta", generator=torch.Generator(), iters=4)
    assert isinstance(half, RAFTStereo) and half.dtype == torch.float16 and half.iters == 32
    assert full.dtype == torch.float32 and full.iters == 4 and not full.training
    with pytest.raises(TypeError):
        build_model("raft_stereo", device="meta", max_disp=192)


def test_test_img_serves_raft(tmp_path):
    """``test_img --model raft_stereo`` on a small pair from files, through
    ``make_infer_fn``, in float32 on the CPU."""
    rng = np.random.default_rng(0)
    paths = []
    for side in ("left", "right"):
        path = tmp_path / f"{side}.png"
        Image.fromarray(rng.integers(0, 255, (40, 70, 3), dtype=np.uint8)).save(path)
        paths.append(str(path))
    out = tmp_path / "disp.png"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        test_img.main(["--left", paths[0], "--right", paths[1], "--out", str(out), "--model", "raft_stereo",
                       "--device", "cpu", "--no-bf16"])
    assert "wrote" in buf.getvalue()
    assert np.asarray(Image.open(out)).shape == (40, 70) and (tmp_path / "disp_vis.png").exists()
