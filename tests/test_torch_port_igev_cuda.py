"""IGEV-Stereo's kernels and its forward through CUDA graphs on the card:
the combined geometry lookup (``ecm_torch/csrc/geo_lookup.cu``) and the
group-wise correlation volume (``csrc/cost_volume.cu``'s
``correlation_kernel`` at 8 groups) against their plain versions at the
``igev_kitti_b1`` cell's shapes (a 96x312 grid, 48 disparities, 96
descriptor channels), ECM's one-group launch beside them, the eval
BatchNorm epilogue (``ops/bn_act.py``) against its plain version at the
cell's MobileNetV2, ``BasicConv`` (2-D and 3-D) sites, and the graphed
forward against the eager one at 64x128 with the published 32 iterations,
in float16: its 104 epilogues a forward, no library BatchNorm in a replay,
and a replay that reads a BatchNorm's statistics as they are.

Marked ``cuda``: skipped without a GPU. The machine with the card has no
JAX, so run these there without the JAX test setup:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_igev_cuda.py``.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ecm_torch.models import build_model
from ecm_torch.ops import bn_act as bak
from ecm_torch.ops import cuda_cost_volume as cvk
from ecm_torch.ops.cuda_corr1d import corr_pyramid
from ecm_torch.ops.cuda_geo_lookup import geo_lookup, geo_lookup_torch, geo_pyramid
from ecm_torch.ops.launches import COUNTERS, read_counts, read_replayed, reset_counts
from ecm_torch.train.steps import make_infer_fn

pytestmark = pytest.mark.cuda

ITERS = 32
GRU = ("conv_gru_pack", "conv_gru_gate", "conv_gru_update")
# a forward's instance norms: the feature decoder's 7, the stems' 4 and the
# descriptor's conv's 1, each on both images in one call
NORMS = 12
# a forward's eval BatchNorm epilogues: MobileNetV2's 48, cnet's 33, the
# 2-D and 3-D BasicConvs' 23 (the volume's stem and excitation 2, the
# hourglass 19, the upsampling's Conv2x 2)
BN_SITES = 104
LIBRARY_BN = ("bn_fw", "batch_norm")  # cuDNN's and ATen's BatchNorm kernels


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def lookup_inputs(dev, b: int = 1, h: int = 96, w: int = 312, d: int = 48, c: int = 96):
    """Both pyramids and disparities that reach every case: inside, on and
    past both ends of each row, at -0.5, fractional."""
    g = torch.Generator(device=dev).manual_seed(7)
    gev = torch.randn(b, 8, d, h, w, generator=g, device=dev).half().contiguous(memory_format=torch.channels_last_3d)
    f1, f2 = (torch.randn(b, c, h, w, generator=g, device=dev) for _ in range(2))
    disp = (torch.rand(b, 1, h, w, generator=g, device=dev) * 1.4 - 0.2) * d
    flat = disp.view(-1)
    flat[:12] = torch.tensor([-0.5, -1.0, 0.0, d - 1.0, d - 0.5, float(d), -3.7, d + 4.2, 0.25, 12.5, 1e-3, -4.5],
                             device=dev)
    flat[-4:] = torch.tensor([w - 1.0, w + 0.5, -float(w), 2.5], device=dev)
    return geo_pyramid(gev, 2), corr_pyramid(f1, f2, 2, scaled=False), disp.contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_geo_lookup_kernel_matches_plain(dev, dtype):
    """The plain version's ``grid_sample`` maps a position to [-1, 1] and
    back, which moves it by up to ~4 float32 units in the last place of the
    row's length (312 for the correlation), times the row's slope (at most
    twice its largest value); the kernel does not. float16 and bfloat16
    round once more. The output is channels-last; the wrapper counts one
    launch."""
    geo, corr, disp = lookup_inputs(dev)
    reset_counts()
    out = geo_lookup(geo, corr, disp, 4, dtype)
    torch.cuda.synchronize()
    assert read_counts()["geo_lookup"] == 1
    ref = geo_lookup_torch(geo, corr, disp, 4)
    assert out.shape == (1, 162, 96, 312) and out.dtype == dtype
    assert out.is_contiguous(memory_format=torch.channels_last)
    largest = max(t.abs().max().item() for t in (*geo, *corr))
    atol = 4 * torch.finfo(torch.float32).eps * 312 * 2 * largest
    rtol = 0.0 if dtype == torch.float32 else torch.finfo(dtype).eps
    torch.testing.assert_close(out.float(), ref, rtol=rtol, atol=atol)
    # at disparity d + 4.2 every level-0 geometry tap is past the row's end
    assert (ref[0, :72, 0, 7] == 0).all() and (out[0, :72, 0, 7] == 0).all()


def test_geo_lookup_raises_on_what_it_does_not_take(dev):
    geo, corr, disp = lookup_inputs(dev, h=8, w=64)
    with pytest.raises(ValueError, match="radius"):
        geo_lookup(geo, corr, disp, 3)
    with pytest.raises(ValueError, match="float32"):
        geo_lookup(geo, corr, disp.double(), 4)
    with pytest.raises(ValueError, match="writes"):
        geo_lookup(geo, corr, disp, 4, torch.float64)
    with pytest.raises(ValueError, match="level 1"):
        geo_lookup([geo[0], geo[0]], corr, disp, 4)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32])
def test_group_wise_volume_matches_plain(dev, dtype):
    """8 groups of 12 channels at the cell's shape: the kernel sums the same
    float32 products in another order and rounds once, so within one
    rounding of the format (and float32's few) of the plain version; the
    wrapper counts a group launch, not ECM's."""
    g = torch.Generator(device=dev).manual_seed(3)
    fl, fr = (torch.randn(1, 96, 312, 96, generator=g, device=dev).to(dtype) for _ in range(2))
    reset_counts()
    out = cvk.cost_volume_correlation(fl, fr, 48, groups=8)
    torch.cuda.synchronize()
    counts = read_counts()
    assert (counts["gwc_volume"], counts["cost_volume_correlation"]) == (1, 0)
    ref = cvk.cost_volume_correlation_torch(fl, fr, 48, groups=8)
    assert out.shape == (1, 48, 96, 312, 8) and out.dtype == dtype
    eps = torch.finfo(torch.float32).eps
    torch.testing.assert_close(out.float(), ref.float(), rtol=torch.finfo(dtype).eps, atol=16 * eps)
    assert (out[:, 5, :, :5] == 0).all()


def test_one_group_is_ecms_launch(dev):
    """``groups`` 1 is ECM's volume: ``[B, D, H, W, 1]``, counted as ECM's
    launch, within one bfloat16 rounding of its plain version, and the same
    bits as the kernel called without ``groups``."""
    g = torch.Generator(device=dev).manual_seed(4)
    fl, fr = (torch.randn(1, 96, 312, 32, generator=g, device=dev).bfloat16() for _ in range(2))
    reset_counts()
    one = cvk.cost_volume_correlation(fl, fr, 48, groups=1)
    default = cvk.cost_volume_correlation(fl, fr, 48)
    counts = read_counts()
    assert (counts["cost_volume_correlation"], counts["gwc_volume"]) == (2, 0)
    assert one.shape == (1, 48, 96, 312, 1) and torch.equal(one, default)
    ref = cvk.cost_volume_correlation_torch(fl, fr, 48)
    torch.testing.assert_close(one.float(), ref.float(), rtol=torch.finfo(torch.bfloat16).eps, atol=1e-6)


def test_replay_equals_eager(dev):
    """Eager on the first call, captured on the second, replayed after; every
    answer equal to the eager forward bit for bit; the eager forward, the
    capture and each replay run one group-wise volume, ``ITERS`` lookups,
    ``NORMS`` instance norms, ``3 ITERS`` ConvGRU cells and ``BN_SITES``
    BatchNorm epilogues and no other kernel of the port, a replay's counted
    as replayed."""
    model = build_model("igev_stereo", device=dev, generator=torch.Generator().manual_seed(0),
                        dtype=torch.float16, iters=ITERS)
    infer = make_infer_fn(model)
    g = torch.Generator(device=dev).manual_seed(3)
    reqs = [tuple(torch.randn(1, 64, 128, 3, generator=g, device=dev) for _ in range(2)) for _ in range(3)]
    want = (dict.fromkeys(COUNTERS, 0) | {"geo_lookup": ITERS, "gwc_volume": 1, "instance_norm": NORMS,
                                          "bn_act": BN_SITES} | dict.fromkeys(GRU, 3 * ITERS))
    reset_counts()
    first = infer(*reqs[0])
    assert not infer.graphs and read_counts() == want
    second = infer(*reqs[0])
    (captured,) = infer.graphs.values()
    assert captured.launches == want
    reset_counts()
    outs = [infer(*r) for r in reqs]
    torch.cuda.synchronize()
    assert read_counts() == dict.fromkeys(COUNTERS, 0) and read_replayed() == {k: 3 * n for k, n in want.items()}
    assert captured.replays == 3 and infer.discards == 0
    with torch.inference_mode():
        eager = [model(*r)[-1] for r in reqs]
    assert torch.equal(first, eager[0]) and torch.equal(second, first)
    for out, ref in zip(outs, eager):
        assert out.shape == (1, 64, 128) and out.dtype == torch.float32 and torch.isfinite(out).all()
        assert torch.equal(out, ref)
    assert not torch.equal(outs[0], outs[1])


def test_every_convolution_reads_channels_last_on_the_card(dev, monkeypatch):
    """On the card every convolution of an eager float16 forward, 2-D and
    3-D, plain, depthwise and transposed, gets a channels-last input
    (``channels_last_3d`` in 3-D) as cuDNN's NHWC kernels read it; and the
    profiled second forward lists the layout transposes cuDNN still runs
    (``nchwToNhwc``, ``nhwcToNchw``): none in 2-D, where RAFT-Stereo's test
    holds it, and those of the 3-D stage's small-channel convolutions, which
    cuDNN runs by an NCDHW algorithm (``implicit_convolveNd_sgemm``)."""
    import torch.nn.functional as F

    model = build_model("igev_stereo", device=dev, generator=torch.Generator().manual_seed(0),
                        dtype=torch.float16, iters=2)
    g = torch.Generator(device=dev).manual_seed(4)
    left, right = (torch.randn(1, 64, 128, 3, generator=g, device=dev) for _ in range(2))
    bad = []
    for name in ("conv2d", "conv3d", "conv_transpose2d", "conv_transpose3d"):
        real = getattr(F, name)

        def spy(x, weight, *args, real=real, name=name, **kwargs):
            fmt = torch.channels_last_3d if x.ndim == 5 else torch.channels_last
            if not (x.is_contiguous(memory_format=fmt) and weight.is_contiguous(memory_format=fmt)):
                bad.append((name, tuple(weight.shape)))
            return real(x, weight, *args, **kwargs)

        monkeypatch.setattr(F, name, spy)
    with torch.inference_mode():
        model(left, right)
        torch.cuda.synchronize()
        monkeypatch.undo()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            model(left, right)
            torch.cuda.synchronize()
    assert not bad
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any("geo_lookup" in k for k in kernels), sorted(set(kernels))  # the profiler saw the card
    transposes = [k for k in kernels if "nchwToNhwc" in k or "nhwcToNchw" in k]
    print("layout transposes a forward:", len(transposes), sorted(set(transposes)))


# the igev_kitti_b1 cell's epilogue forms (384x1248, max-disp 192; the
# feature trunk on both images): (shape, act, residual); no bias, as every
# convolution before a BatchNorm in IGEV-Stereo is bias-free
BN_FORMS = {
    "stem_1/2": ((2, 32, 192, 624), "relu6", False),
    "expand_1/2": ((2, 96, 192, 624), "relu6", False),
    "project_skip_1/4": ((2, 24, 96, 312), None, True),
    "depthwise_1/4": ((2, 144, 96, 312), "relu6", False),
    "expand_1/32": ((2, 960, 12, 39), "relu6", False),
    "project_skip_1/32": ((2, 160, 12, 39), None, True),
    "basic_conv_2d_1/4": ((1, 48, 96, 312), "leaky_relu", False),
    "spx_2_gru_1/2": ((1, 64, 192, 624), "leaky_relu", False),
    "corr_stem_3d": ((1, 8, 48, 96, 312), "leaky_relu", False),
    "hourglass_3d_1/8": ((1, 16, 24, 48, 156), "leaky_relu", False),
    "hourglass_3d_1/32": ((1, 48, 6, 12, 39), "leaky_relu", False),
    "no_act_3d": ((1, 16, 24, 48, 156), None, False),
}


@pytest.mark.parametrize("form", BN_FORMS)
def test_bn_act_kernel_matches_plain(dev, form):
    """The kernel against the plain version on the same values (the same
    float32 expression, the card's ``rsqrt`` and fused multiply-adds a few
    float32 units in the last place apart, at most one float16 unit after
    the rounding); in place, in the map's layout, one launch counted."""
    shape, act, with_res = BN_FORMS[form]
    g = torch.Generator(device=dev).manual_seed(10)
    c, fmt = shape[1], torch.channels_last if len(shape) == 4 else torch.channels_last_3d
    bn = (torch.nn.BatchNorm2d if len(shape) == 4 else torch.nn.BatchNorm3d)(c).to(dev).eval().requires_grad_(False)
    bn.running_mean.copy_(2 * torch.randn(c, generator=g, device=dev))
    bn.running_var.copy_(0.1 + 3 * torch.rand(c, generator=g, device=dev))
    bn.weight.copy_(torch.randn(c, generator=g, device=dev))
    bn.bias.copy_(torch.randn(c, generator=g, device=dev) + 3)
    y, res = ((s * torch.randn(shape, generator=g, device=dev)).half().contiguous(memory_format=fmt) for s in (3, 1))
    res = res if with_res else None
    ref = bak.bn_act_torch(y.clone(), bn, None, act, res)
    reset_counts()
    got = bak.bn_act(y, bn, None, act, res)
    torch.cuda.synchronize()
    assert got is y and got.is_contiguous(memory_format=fmt)
    assert read_counts() == dict.fromkeys(COUNTERS, 0) | {"bn_act": 1}
    eps = torch.finfo(torch.float32).eps
    torch.testing.assert_close(got.float(), ref.float(), rtol=torch.finfo(torch.float16).eps + 8 * eps,
                               atol=16 * eps * ref.float().abs().max().item())


def test_replay_runs_no_library_batchnorm_and_reads_the_statistics(dev):
    """A profiled replay of the eval forward runs ``BN_SITES`` epilogues and
    no cuDNN or ATen BatchNorm kernel; MobileNetV2's stem BatchNorm's running
    variance changed in place is read by the next replay, which equals the
    eager forward under the new statistics bit for bit."""
    model = build_model("igev_stereo", device=dev, generator=torch.Generator().manual_seed(0),
                        dtype=torch.float16, iters=2)
    infer = make_infer_fn(model)
    g = torch.Generator(device=dev).manual_seed(5)
    left, right = (torch.randn(1, 64, 128, 3, generator=g, device=dev) for _ in range(2))
    infer(left, right)
    infer(left, right)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        before = infer(left, right)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("bn_act_kernel" in k for k in kernels) == BN_SITES, sorted(set(kernels))
    assert not [k for k in kernels if any(b in k for b in LIBRARY_BN)]
    with torch.no_grad():
        model.feature.bn1.running_var.mul_(4.0)
    after = infer(left, right)
    (captured,) = infer.graphs.values()
    with torch.inference_mode():
        eager = model(left, right)[-1]
    assert captured.replays == 2 and infer.discards == 0
    assert not torch.equal(after, before) and torch.equal(after, eager)
