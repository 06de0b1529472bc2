"""IGEV-Stereo in the port (``ecm_torch/models/igev_stereo.py``, the
group-wise volume of ``ecm_torch/ops/cuda_cost_volume.py`` and the lookup of
``ecm_torch/ops/cuda_geo_lookup.py``) on the CPU, at the published widths and
a small size (64x128, max-disp 64, 3 iterations, float32) on the
benchmark's seeded weights: the forward against the plain reference
``stereo_bench/reference/igevstereo.py`` at batch 1 and 2, the plain volume
against a loop over groups and against ECM's one-group volume, the plain
lookup against the published ``grid_sample`` form and the equation, the
channels-last layout of every convolution, the reference's imports, the
dtype and layout the benchmark's build leaves the weights in, the published
state-dict names and the parameter count, the spans and counters, the
configuration's build and the ``test_img`` CLI."""

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
from ecm_torch.models import IGEVStereo, build_model, igev_stereo
from ecm_torch.ops import launches
from ecm_torch.ops.cuda_corr1d import corr_pyramid
from ecm_torch.ops.cuda_cost_volume import cost_volume_correlation, cost_volume_correlation_torch
from ecm_torch.ops.cuda_geo_lookup import geo_lookup, geo_lookup_torch, geo_pyramid
from stereo_bench import harness, synth
from stereo_bench.families import igevstereo as fam
from stereo_bench.weights import make_weights
from test_torch_port_util import torch_threads

CPU = torch.device("cpu")
CL, CL3 = torch.channels_last, torch.channels_last_3d
H, W, MAX_DISP, ITERS = 64, 128, 64, 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    with torch_threads(1):
        yield


def small_cfg() -> dict:
    cfg = copy.deepcopy(json.loads((harness.HERE / "configs" / "igev_kitti.json").read_text()))
    cfg["shapes"].update(height=H, width=W, max_disp=MAX_DISP, valid_iters=ITERS)
    cfg["dtype"] = "float32"
    return cfg


@pytest.fixture(scope="module")
def model_and_params():
    cfg = small_cfg()
    model = fam.build(cfg, CPU)
    params = fam.seeded_weights(cfg, model.state_dict(), 11, CPU)
    model.load_state_dict(params)
    return cfg, model, params


@pytest.mark.parametrize("batch, seed", [(1, 1), (2, 2)])
def test_forward_matches_the_reference(model_and_params, batch, seed):
    """Both in float32: the same operations, summed in other orders (the
    norms' formulas, the volume's kernel-order mean against the published
    loop, the correlation's matmul against ``einsum``), which the soft-argmin
    and 3 iterations carry into the disparity; observed at most 1.4e-5 px
    over 6 seeds of disparities of 20-40 px, so 1e-4 px. A float16 program
    misses by ~1e-2 px."""
    cfg, model, params = model_and_params
    pair = synth.make_pairs(torch.Generator().manual_seed(seed), batch, H, W, 1.0, 12.0, CPU)
    with torch.inference_mode():
        out = model(pair["left"], pair["right"])
    ref = fam.infer(params, cfg, pair["left"], pair["right"], fam.EXACT)
    assert len(out) == 1 and out[-1].shape == (batch, H, W) and out[-1].dtype == torch.float32
    assert ref.std() > 0.1  # a disparity field, not a constant
    torch.testing.assert_close(out[-1], ref, rtol=0, atol=1e-4)


def _loop_volume(fl: torch.Tensor, fr: torch.Tensor, max_disp: int, groups: int) -> torch.Tensor:
    """The published ``build_gwc_volume`` on ``[B, H, W, C]`` maps, as a loop
    over groups of ECM's one-group volume."""
    c = fl.shape[-1] // groups
    return torch.cat([cost_volume_correlation_torch(fl[..., g * c:(g + 1) * c], fr[..., g * c:(g + 1) * c], max_disp)
                      for g in range(groups)], -1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_wise_volume_is_a_loop_over_groups(dtype):
    """Each group the mean of its 12 channels' products, zero left of the
    disparity, bit for bit the one-group volume of the group's channels; the
    wrapper on the CPU is the plain version and launches nothing."""
    g = torch.Generator().manual_seed(3)
    fl, fr = (torch.randn(2, 5, 37, 96, generator=g).to(dtype) for _ in range(2))
    launches.reset_counts()
    got = cost_volume_correlation(fl, fr, 12, groups=8)
    assert got.shape == (2, 12, 5, 37, 8) and got.dtype == dtype
    assert torch.equal(got, cost_volume_correlation_torch(fl, fr, 12, groups=8))
    assert torch.equal(got, _loop_volume(fl, fr, 12, 8))
    assert (got[:, 7, :, :7] == 0).all() and launches.read_counts() == dict.fromkeys(launches.COUNTERS, 0)
    with pytest.raises(ValueError, match="divide"):
        cost_volume_correlation(fl, fr, 12, groups=7)
    with pytest.raises(NotImplementedError):
        cost_volume_correlation_torch(fl.float().requires_grad_(), fr.float(), 12, groups=8).sum().backward()


def test_one_group_is_ecms_volume_bit_for_bit():
    """``groups`` 1 (the default) is ECM's correlation volume as it was
    written before groups: ``prod.mean(-1, keepdim=True)`` a plane, with its
    closed-form VJP."""
    g = torch.Generator().manual_seed(4)
    fl, fr = (torch.randn(1, 6, 29, 32, generator=g).bfloat16() for _ in range(2))
    want = fl.new_zeros(1, 10, 6, 29, 1)
    for d in range(10):
        prod = fl[:, :, d:].float() * fr[:, :, : 29 - d].float()
        want[:, d, :, d:] = prod.mean(-1, keepdim=True).to(fl.dtype)
    assert torch.equal(cost_volume_correlation_torch(fl, fr, 10), want)
    assert torch.equal(cost_volume_correlation_torch(fl, fr, 10, groups=1), want)
    x = fl.float().requires_grad_()
    cost_volume_correlation_torch(x, fr.float(), 10, groups=1).sum().backward()
    assert x.grad is not None and x.grad.abs().sum() > 0


def published_lookup(gev: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor, disp: torch.Tensor,
                     levels: int = 2, radius: int = 4) -> torch.Tensor:
    """The published ``Combined_Geo_Encoding_Volume`` (its ``__init__`` and
    ``__call__``, ``bilinear_sampler``): ``[B, L (C + 1) (2r + 1), H, W]``."""
    b, c, d, h, w = gev.shape
    geo = [gev.permute(0, 3, 4, 1, 2).reshape(b * h * w, c, 1, d)]
    corr = [torch.einsum("aijk,aijh->ajkh", f1, f2).reshape(b * h * w, 1, 1, w)]
    for _ in range(levels - 1):
        geo.append(F.avg_pool2d(geo[-1], [1, 2], stride=[1, 2]))
        corr.append(F.avg_pool2d(corr[-1], [1, 2], stride=[1, 2]))
    coords = torch.arange(w).float().reshape(1, 1, w, 1).repeat(b, h, 1, 1)

    def sample(img, xy):
        x, y = xy.split([1, 1], -1)
        return F.grid_sample(img, torch.cat([2 * x / (img.shape[-1] - 1) - 1, y], -1), align_corners=True)

    out = []
    for i in range(levels):
        dx = torch.linspace(-radius, radius, 2 * radius + 1).view(1, 1, 2 * radius + 1, 1)
        x0 = dx + disp.reshape(b * h * w, 1, 1, 1) / 2**i
        out.append(sample(geo[i], torch.cat([x0, torch.zeros_like(x0)], -1)).view(b, h, w, -1))
        x0 = coords.reshape(b * h * w, 1, 1, 1) / 2**i - disp.reshape(b * h * w, 1, 1, 1) / 2**i + dx
        out.append(sample(corr[i], torch.cat([x0, torch.zeros_like(x0)], -1)).view(b, h, w, -1))
    return torch.cat(out, -1).permute(0, 3, 1, 2).contiguous()


def the_equation(geo: list[torch.Tensor], corr: list[torch.Tensor], disp: torch.Tensor, radius: int = 4):
    """The lookup written out: for level i, tap k, geometry channel c at
    u = delta / 2**i + k and the correlation at x / 2**i - delta / 2**i + k,
    ``v(u0) (u0 + 1 - u) + v(u0 + 1) (u - u0)`` with v 0 outside the row."""
    b, _, h, w = disp.shape
    delta = disp.reshape(-1)
    x = torch.arange(w, dtype=torch.float32).repeat(b * h)

    def lin(rows, u):
        n = rows.shape[-1]
        u0 = u.floor()
        v = lambda p: torch.where((p >= 0) & (p < n), rows.gather(-1, p.clamp(0, n - 1).long()[:, None])[:, 0],  # noqa: E731
                                  torch.zeros_like(u))
        return v(u0) * (u0 + 1 - u) + v(u0 + 1) * (u - u0)

    out = []
    for i, (g, c) in enumerate(zip(geo, corr)):
        for ch in range(g.shape[-1]):
            out += [lin(g[:, :, ch], delta / 2**i + k) for k in range(-radius, radius + 1)]
        out += [lin(c.reshape(b * h * w, -1), x / 2**i - delta / 2**i + k) for k in range(-radius, radius + 1)]
    return torch.stack(out, 1).view(b, h, w, -1).permute(0, 3, 1, 2)


def test_plain_lookup_is_the_published_form_and_the_equation():
    """At disparities inside, at -0.5 (half the first plane), fractional, and
    past both ends of both rows (every tap 0): the plain lookup equals the
    published form bit for bit and the equation to ``grid_sample``'s
    rounding (a position moves by up to ~4 float32 units in the last place of
    the row's length, times the row's slope); the wrapper on the CPU is the
    plain version, channels-last, launching nothing."""
    g = torch.Generator().manual_seed(5)
    b, h, w, d = 2, 3, 40, 16
    gev = torch.randn(b, 8, d, h, w, generator=g)
    f1, f2 = torch.randn(b, 24, h, w, generator=g), torch.randn(b, 24, h, w, generator=g)
    disp = (torch.rand(b, 1, h, w, generator=g) * 1.4 - 0.2) * d
    disp.view(-1)[:8] = torch.tensor([-0.5, 0.0, 3.25, d - 1.0, d + 4.5, -4.5, w + 5.0, -w - 5.0])
    geo, corr = geo_pyramid(gev, 2), corr_pyramid(f1, f2, 2, scaled=False)
    launches.reset_counts()
    got = geo_lookup(geo, corr, disp, 4)
    assert got.shape == (b, 162, h, w) and got.is_contiguous(memory_format=CL)
    assert launches.read_counts() == dict.fromkeys(launches.COUNTERS, 0)
    assert torch.equal(got, geo_lookup_torch(geo, corr, disp, 4))
    assert torch.equal(got, published_lookup(gev, f1, f2, disp))
    slope = 2 * max(t.abs().max().item() for t in (*geo, *corr))
    torch.testing.assert_close(got, the_equation(geo, corr, disp), rtol=0,
                               atol=4 * torch.finfo(torch.float32).eps * w * slope)
    # -0.5: half the first plane at tap 0 of level 0; d + 4.5: every level-0 geometry tap past the end
    torch.testing.assert_close(got[0, 4:72:9, 0, 0], 0.5 * geo[0][0, 0], rtol=0, atol=1e-6)
    assert (got[0, :72, 0, 4] == 0).all()
    assert geo_lookup(geo, corr, disp, 4, torch.bfloat16).dtype == torch.bfloat16


def test_every_convolution_reads_channels_last(model_and_params, monkeypatch):
    """Every 2-D convolution of a forward (plain, depthwise and transposed)
    gets a channels-last input and weight, so cuDNN's NHWC kernels transpose
    nothing; every 3-D one a ``channels_last_3d`` weight, and the first (the
    volume's stem) a ``channels_last_3d`` input (the CPU's 3-D convolution
    returns NCDHW, cuDNN's NDHWC: the card test holds the rest); and every
    convolution's weight reaches one: each GRU's ``convz`` and ``convr``
    stacked, once an iteration. ``is_contiguous(memory_format=...)`` ignores
    size-1 dimensions, so 1x1 weights and 1-channel maps pass as they are."""
    _, model, _ = model_and_params
    seen = []
    for name in ("conv2d", "conv3d", "conv_transpose2d", "conv_transpose3d"):
        real = getattr(F, name)

        def spy(x, weight, *args, real=real, **kwargs):
            fmt = CL3 if x.ndim == 5 else CL
            seen.append((weight, x.is_contiguous(memory_format=fmt), weight.is_contiguous(memory_format=fmt)))
            return real(x, weight, *args, **kwargs)

        monkeypatch.setattr(F, name, spy)
    pair = synth.make_pairs(torch.Generator().manual_seed(5), 1, H, W, 1.0, 12.0, CPU)
    with torch.inference_mode():
        model(pair["left"], pair["right"])
    convs = {m: n for n, m in model.named_modules() if isinstance(m, nn.modules.conv._ConvNd)}
    ub = model.update_block
    stacked = {g: torch.cat([g.convz.weight, g.convr.weight]) for g in (ub.gru04, ub.gru08, ub.gru16)}
    reached, bad = set(), []
    first_3d = next(i for i, (w, _, _) in enumerate(seen) if w.ndim == 5)
    for i, (w, x_cl, w_cl) in enumerate(seen):
        x_cl = x_cl or (w.ndim == 5 and i != first_3d)
        parts = [m for m in convs if w is m.weight] or [
            m for g, s in stacked.items() if torch.equal(w, s) for m in (g.convz, g.convr)]
        assert parts
        reached.update(parts)
        if not (x_cl and w_cl):
            bad.append(([convs[m] for m in parts], x_cl, w_cl))
    assert reached == set(convs) and len(convs) == 152  # every convolution's weight was read
    assert not bad


@pytest.mark.parametrize("dtype", ["float16", "float32"])
def test_the_benchmarks_build_holds_convolutions_in_the_served_dtype(dtype):
    """The benchmark's path (``families/igevstereo.build``: the model on
    ``meta``, ``to_empty``, then ``load_state_dict`` of float32 tensors):
    every convolution's weight (and bias) in the configuration's dtype, the
    weight channels-last (``channels_last_3d`` in 3-D), each equal to the
    loaded tensor cast to that dtype; every BatchNorm's parameters and
    statistics float32. ``check_sizes`` takes the file's sizes."""
    cfg = small_cfg()
    cfg["dtype"] = dtype
    model = fam.build(cfg, CPU)
    fam.check_sizes(model, cfg)
    params = make_weights(model.state_dict(), cfg["weights"], 5, CPU)
    model.load_state_dict(params)
    want = fam.DTYPES[dtype]
    convs = {n: m for n, m in model.named_modules() if isinstance(m, nn.modules.conv._ConvNd)}
    norms = [m for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    assert len(convs) == 152 and len(norms) == 105
    for n, m in convs.items():
        fmt = CL3 if m.weight.ndim == 5 else CL
        assert m.weight.dtype == want and m.weight.is_contiguous(memory_format=fmt), n
        assert torch.equal(m.weight, params[f"{n}.weight"].to(want)), n
        if m.bias is not None:
            assert m.bias.dtype == want and torch.equal(m.bias, params[f"{n}.bias"].to(want)), n
    for m in norms:
        assert all(t.dtype == torch.float32 for t in (m.weight, m.bias, m.running_mean, m.running_var))


def test_check_sizes_reads_the_files_sizes():
    cfg = small_cfg()
    model = fam.build(cfg, CPU)
    fam.check_sizes(model, cfg)
    cfg["shapes"]["valid_iters"] = 4
    with pytest.raises(AssertionError):
        fam.check_sizes(model, cfg)


def test_state_dict_names_are_the_published_and_the_parameter_count():
    """The published module tree's names (timm's MobileNetV2 under
    ``feature.block*``, ``BasicConv``'s ``conv``/``bn``, the hourglass, the
    update block), ``cnet``'s heads by RAFT's names; 12,513,817 parameters:
    the 12,513,801 the forward applies and the 16 of ``cost_agg.conv1_up.bn``,
    a BatchNorm that the published ``BasicConv`` registers where it applies
    none. A state dict with IGEV's own ``cnet`` names (``outputs04/08/16``)
    loads into the same tensors."""
    with torch.device("meta"):
        model = IGEVStereo()
    sd = model.state_dict()
    assert sum(p.numel() for p in model.parameters()) == 12_513_817
    assert sum(p.numel() for n, p in model.named_parameters() if not n.startswith("cost_agg.conv1_up.bn.")) \
        == 12_513_801
    tops = {k.split(".")[0] for k in sd}
    assert tops == {"feature", "stem_2", "stem_4", "conv", "desc", "corr_stem", "corr_feature_att", "cost_agg",
                    "classifier", "cnet", "context_zqr_convs", "update_block", "spx_2_gru", "spx_gru"}
    for name, shape in {
        "feature.conv_stem.weight": (32, 3, 3, 3), "feature.block0.0.0.conv_dw.weight": (32, 1, 3, 3),
        "feature.block1.0.1.conv_pw.weight": (144, 24, 1, 1), "feature.block3.1.2.conv_pwl.weight": (96, 576, 1, 1),
        "feature.block4.0.2.bn3.running_var": (160,), "feature.deconv32_16.conv1.conv.weight": (160, 96, 4, 4),
        "feature.conv4.conv.weight": (48, 48, 3, 3), "stem_2.0.conv.weight": (32, 3, 3, 3),
        "stem_4.1.weight": (48, 48, 3, 3), "desc.bias": (96,), "corr_stem.bn.weight": (8,),
        "corr_feature_att.feat_att.1.weight": (8, 48, 1, 1), "cost_agg.conv3_up.conv.weight": (48, 32, 4, 4, 4),
        "cost_agg.agg_0.0.conv.weight": (32, 64, 1, 1, 1), "cost_agg.feature_att_32.feat_att.0.conv.weight":
        (80, 160, 1, 1), "classifier.weight": (1, 8, 3, 3, 3), "cnet.outputs08.0.1.weight": (128, 128, 3, 3),
        "update_block.encoder.convc1.weight": (64, 162, 1, 1), "update_block.encoder.convd1.weight": (64, 1, 7, 7),
        "update_block.encoder.conv.weight": (127, 128, 3, 3), "update_block.gru04.convz.weight": (128, 384, 3, 3),
        "update_block.disp_head.conv2.weight": (1, 256, 3, 3), "update_block.mask_feat_4.0.weight": (32, 128, 3, 3),
        "spx_2_gru.conv1.bn.weight": (32,), "spx_gru.0.weight": (64, 9, 4, 4),
    }.items():
        assert sd[name].shape == shape, name
    assert not any(k.startswith(("spx.", "spx_2.", "spx_4.")) or ".IN." in k for k in sd)
    # IGEV's names for cnet's heads, by the scale each serves
    heads = {"outputs08": "outputs04", "outputs16": "outputs08", "outputs32": "outputs16"}
    g = torch.Generator().manual_seed(0)
    ours = {k: torch.randn(v.shape, generator=g) if v.is_floating_point() else torch.zeros(v.shape, dtype=v.dtype)
            for k, v in sd.items()}
    ours.update({k: ours[k.replace(".norm3.", ".downsample.1.")] for k in ours if ".norm3." in k})  # one module
    published = {}
    for k, v in ours.items():
        parts = k.split(".")
        if parts[0] == "cnet" and parts[1] in heads:
            parts[1] = heads[parts[1]]
        published[".".join(parts)] = v
    model = IGEVStereo(dtype=torch.float32)
    model.load_state_dict(published)
    assert all(torch.equal(model.state_dict()[k], v) for k, v in ours.items())


def test_spans_and_counters(model_and_params):
    """The eager forward's spans: ``ecm.igev.encode``, ``.context``,
    ``.geometry``, one ``.update`` an iteration, ``.upsample``; on CPU
    tensors no kernel launches, and the two new counters are the port's."""
    _, model, _ = model_and_params
    assert {"geo_lookup", "gwc_volume"} <= set(launches.COUNTERS)
    pair = synth.make_pairs(torch.Generator().manual_seed(3), 1, H, W, 1.0, 12.0, CPU)
    launches.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof, torch.inference_mode():
        model(pair["left"], pair["right"])
    names = [e.name for e in sorted(prof.events(), key=lambda e: e.time_range.start) if e.name.startswith("ecm.igev.")]
    assert names == ["ecm.igev.encode", "ecm.igev.context", "ecm.igev.geometry", *["ecm.igev.update"] * ITERS,
                     "ecm.igev.upsample"]
    assert launches.read_counts() == dict.fromkeys(launches.COUNTERS, 0)


def test_reference_imports_nothing_of_the_program():
    """The plain reference is independent of the port: its imports are
    torch, the standard library and its sibling references (relative
    imports), never ``ecm_torch`` or JAX."""
    from stereo_bench.tests.test_imports import imported_tops

    tops = imported_tops(harness.HERE / "reference" / "igevstereo.py")
    assert tops <= {"__future__", "torch"} and not tops & {"ecm_torch", "ecm_tpu", "jax", "flax"}


def test_configuration_builds_igev_with_its_own_arguments():
    """``ModelConfig.build`` hands IGEV-Stereo, as RAFT-Stereo, none of ECM's
    knobs (``models.DTYPE_ONLY``): the published sizes, float16 where
    ``bf16`` is set, float32 without."""
    cfg = dataclasses.replace(CONFIGS["kitti_infer"].model, name="igev_stereo")
    with torch.device("meta"):
        half = cfg.build(device="meta", generator=torch.Generator())
        full = dataclasses.replace(cfg, bf16=False).build(device="meta", generator=torch.Generator(), iters=4)
    assert isinstance(half, IGEVStereo) and half.dtype == torch.float16 and half.iters == 32
    assert half.max_disp == 192 and (half.corr_levels, half.corr_radius) == (2, 4)
    assert full.dtype == torch.float32 and full.iters == 4 and not full.training
    with pytest.raises(TypeError):
        build_model("igev_stereo", device="meta", agg_layout="grouped")
    with pytest.raises(ValueError, match="max_disp"):
        igev_stereo.IGEVStereo(max_disp=100)


def test_test_img_serves_igev(tmp_path):
    """``test_img --model igev_stereo`` on a small pair from files (padded to
    multiples of 32), through ``make_infer_fn``, in float32 on the CPU."""
    rng = np.random.default_rng(0)
    paths = []
    for side in ("left", "right"):
        path = tmp_path / f"{side}.png"
        Image.fromarray(rng.integers(0, 255, (40, 70, 3), dtype=np.uint8)).save(path)
        paths.append(str(path))
    out = tmp_path / "disp.png"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        test_img.main(["--left", paths[0], "--right", paths[1], "--out", str(out), "--model", "igev_stereo",
                       "--device", "cpu", "--no-bf16"])
    assert "wrote" in buf.getvalue()
    assert np.asarray(Image.open(out)).shape == (40, 70) and (tmp_path / "disp_vis.png").exists()
