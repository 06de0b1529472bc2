"""RAFT-Stereo's lookup kernel (``ecm_torch/csrc/corr1d.cu``) and its forward
through CUDA graphs on the card: the kernel against its plain version at
the served size (384x1248: a 96x312 grid, 4 levels, radius 4), and the
graphed forward against the eager one at 64x128 with the published 32
iterations, in float16, an eager forward's kernels (no layout transpose: the
model is channels-last, as cuDNN's float16 convolutions run), the
channels-last instance norm's Triton kernels against ``F.instance_norm``,
the ConvGRU's three Triton kernels (``ops/conv_gru.py``) against their
plain versions at the served size's three levels, and ``cnet``'s eval
BatchNorm epilogue (``ops/bn_act.py``) against its plain version at the
served size's sites, its 33 launches a forward, no library BatchNorm in a
replay, and a replay that reads a BatchNorm's statistics as they are.

Marked ``cuda``: skipped without a GPU. The machine with the card has no
JAX, so run these there without the JAX test setup:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_raft_cuda.py``.
"""

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from ecm_torch.models import build_model
from ecm_torch.ops import bn_act as bak
from ecm_torch.ops import conv_gru as cg
from ecm_torch.ops.cuda_corr1d import corr1d_lookup, corr1d_lookup_torch, corr_pyramid
from ecm_torch.ops.instance_norm import instance_norm
from ecm_torch.ops.launches import COUNTERS, read_counts, read_replayed, reset_counts
from ecm_torch.train.steps import make_infer_fn

pytestmark = pytest.mark.cuda

ITERS = 32
CL = torch.channels_last
GRU = ("conv_gru_pack", "conv_gru_gate", "conv_gru_update")  # the ConvGRU's counters, one a kernel
BN_SITES = 33  # cnet's eval BatchNorms: the stem's, 2 in each of 14 residual blocks, 4 shortcuts
LIBRARY_BN = ("bn_fw", "batch_norm")  # cuDNN's and ATen's BatchNorm kernels


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, b: int = 1, h: int = 96, w: int = 312, c: int = 256, levels: int = 4):
    """A pyramid of the features' correlation and coordinates that reach
    every case: inside, on and past both borders, in (-1, 0)."""
    g = torch.Generator(device=dev).manual_seed(7)
    f1, f2 = (torch.randn(b, c, h, w, generator=g, device=dev) for _ in range(2))
    pyramid = corr_pyramid(f1, f2, levels)
    x = torch.arange(w, device=dev, dtype=torch.float32).expand(b, 1, h, w)
    flow = (torch.rand(b, 1, h, w, generator=g, device=dev) - 0.7) * 1.4 * w
    xs = torch.cat([x[..., : w // 2] + flow[..., : w // 2], torch.full_like(x[..., w // 2:], -0.5)], -1)
    xs[..., -8:] = torch.tensor([-1.0, 0.0, w - 1.0, w - 0.5, float(w), -3.7, w + 4.2, -0.25], device=dev)
    ys = torch.arange(h, device=dev, dtype=torch.float32).view(1, 1, h, 1).expand(b, 1, h, w)
    return pyramid, torch.cat([xs, ys], 1).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_kernel_matches_plain(dev, dtype):
    """The plain version's ``grid_sample`` maps x to [-1, 1] and back, which
    moves it by up to ~4 float32 units in the last place of the row's width
    (312), times the row's slope (at most twice its largest value); the
    kernel does not. float16 and bfloat16 round that once more: one unit in
    the last place of the format besides."""
    pyramid, coords = _inputs(dev)
    reset_counts()
    out = corr1d_lookup(pyramid, coords, 4, dtype)
    torch.cuda.synchronize()
    assert read_counts()["corr1d_lookup"] == 1
    ref = corr1d_lookup_torch(pyramid, coords, 4)
    assert out.shape == (1, 36, 96, 312) and out.dtype == dtype
    atol = 4 * torch.finfo(torch.float32).eps * 312 * 2 * pyramid[0].abs().max().item()
    rtol = 0.0 if dtype == torch.float32 else torch.finfo(dtype).eps
    torch.testing.assert_close(out.float(), ref, rtol=rtol, atol=atol)


def test_kernel_raises_on_what_it_does_not_take(dev):
    pyramid, coords = _inputs(dev, h=8, w=64)
    with pytest.raises(ValueError, match="radius"):
        corr1d_lookup(pyramid, coords, 3)
    with pytest.raises(ValueError, match="float32"):
        corr1d_lookup(pyramid, coords.double(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        corr1d_lookup([pyramid[0].transpose(2, 3).contiguous().transpose(2, 3), *pyramid[1:]], coords, 4)
    with pytest.raises(ValueError, match="writes"):
        corr1d_lookup(pyramid, coords, 4, torch.float64)
    with pytest.raises(ValueError, match="level 1"):
        corr1d_lookup([pyramid[0], pyramid[2]], coords, 4)


def test_replay_equals_eager_and_runs_32_lookups(dev):
    """Eager on the first call, captured on the second, replayed after; every
    answer equal to the eager forward bit for bit; the eager forward, the
    capture and each replay run ``ITERS`` lookups, ``fnet``'s 15 instance
    norms, ``3 ITERS`` ConvGRU cells (each of its kernels ``3 ITERS``
    times) and ``cnet``'s ``BN_SITES`` BatchNorm epilogues, and no other
    kernel of the port, a replay's counted as replayed."""
    model = build_model("raft_stereo", device=dev, generator=torch.Generator().manual_seed(0),
                        dtype=torch.float16, iters=ITERS)
    infer = make_infer_fn(model)
    g = torch.Generator(device=dev).manual_seed(3)
    reqs = [tuple(torch.randn(1, 64, 128, 3, generator=g, device=dev) for _ in range(2)) for _ in range(3)]
    want = dict.fromkeys(COUNTERS, 0) | {"corr1d_lookup": ITERS, "instance_norm": 15, "bn_act": BN_SITES} \
        | dict.fromkeys(GRU, 3 * ITERS)
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
        assert out.shape == (1, 64, 128) and out.dtype == torch.float32 and torch.equal(out, ref)
    assert not torch.equal(outs[0], outs[1])


def test_eager_forward_runs_no_layout_transpose(dev):
    """cuDNN runs float16 convolutions NHWC and transposes an NCHW input,
    weight or output (``nchwToNhwc``, ``nhwcToNchw``); the channels-last
    model gives it none to transpose. The second forward is profiled, after
    the weights' packs and cuDNN's first calls."""
    model = build_model("raft_stereo", device=dev, generator=torch.Generator().manual_seed(0),
                        dtype=torch.float16, iters=2)
    g = torch.Generator(device=dev).manual_seed(4)
    left, right = (torch.randn(1, 64, 128, 3, generator=g, device=dev) for _ in range(2))
    with torch.inference_mode():
        model(left, right)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            model(left, right)
            torch.cuda.synchronize()
    kernels = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}
    assert any("corr1d_lookup" in k for k in kernels), sorted(kernels)  # the profiler saw the card
    assert not [k for k in kernels if "nchwToNhwc" in k or "nhwcToNchw" in k]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 64, 384, 1248), (2, 96, 17, 23), (1, 128, 5, 3)])
def test_instance_norm_kernel_matches_the_library(dev, dtype, shape):
    """``fnet``'s full-size map and ragged ones (channels and pixels not a
    multiple of a tile) against ``F.instance_norm`` in float32 on the same
    values, to a few float32 roundings of the largest output (the kernels
    sum in another order and divide by Triton's float32 division) and, in
    float16 and bfloat16, one rounding of the format besides (the kernels
    normalise in float32 and round once). The result stays channels-last;
    the wrapper counts one launch (of its three kernels)."""
    g = torch.Generator(device=dev).manual_seed(6)
    b, c = shape[:2]
    x = 3 * torch.randn(shape, generator=g, device=dev) + 4 * torch.randn(b, c, 1, 1, generator=g, device=dev)
    x = x.to(dtype, memory_format=torch.channels_last)
    reset_counts()
    got = instance_norm(x)
    assert read_counts()["instance_norm"] == 1
    assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
    ref = F.instance_norm(x.float().contiguous())
    atol = 8 * torch.finfo(torch.float32).eps * ref.abs().max().item()
    rtol = 8 * torch.finfo(torch.float32).eps if dtype == torch.float32 else torch.finfo(dtype).eps
    torch.testing.assert_close(got.float(), ref, rtol=rtol, atol=atol)
    with pytest.raises(ValueError, match="channels-last"):
        instance_norm(x.contiguous())


# the raft_kitti_b1 cell's GRU levels at 1/4, 1/8, 1/16 of 384x1248: the
# inputs' channels beside the 128 of the state, and the map's size
CELL_LEVELS = {"gru08": ((128, 128), 96, 312), "gru16": ((128, 128), 48, 156), "gru32": ((128,), 24, 78)}


def _cell_maps(dev, dtype, inputs, h, w, seed=8):
    """A state in (-1, 1), inputs, context thirds, biases and the two
    convolutions' outputs (``zr`` of 256 channels, ``q``), channels-last."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        t = scale * torch.randn(*shape, generator=g, device=dev)
        return t.to(dtype, memory_format=torch.channels_last) if t.ndim == 4 else t.to(dtype)

    return dict(h=torch.tanh(rnd(1, 128, h, w, scale=2.0)), xs=tuple(rnd(1, c, h, w) for c in inputs),
                zr=rnd(1, 256, h, w, scale=2.0), q=rnd(1, 128, h, w, scale=2.0), cz=rnd(1, 128, h, w),
                cr=rnd(1, 128, h, w), cq=rnd(1, 128, h, w), bz=rnd(128, scale=0.5), br=rnd(128, scale=0.5),
                bq=rnd(128, scale=0.5))


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32])
@pytest.mark.parametrize("level", CELL_LEVELS)
def test_conv_gru_kernels_match_plain(dev, level, dtype):
    """The pack bit for bit; the gates and the update against the plain
    versions, which compute the same float32 expressions in the same order:
    the kernels' exponential, division and tanh (Triton's and libdevice's)
    and a fused multiply-add differ by a few float32 units in the last place,
    which a rounding to float16 turns into at most one float16 unit. The
    gates leave ``hx``'s input channels as they were. Each wrapper counts
    its one launch."""
    m = _cell_maps(dev, dtype, *CELL_LEVELS[level])
    eps = torch.finfo(torch.float32).eps
    close = dict(rtol=torch.finfo(dtype).eps + 8 * eps, atol=8 * eps)
    reset_counts()
    hx = cg.conv_gru_pack(m["h"], m["xs"])
    plain_hx = cg.conv_gru_pack_torch(m["h"], m["xs"])
    torch.cuda.synchronize()
    assert hx.is_contiguous(memory_format=torch.channels_last) and torch.equal(hx, plain_hx)
    gates = (m["zr"], m["bz"], m["br"], m["cz"], m["cr"], m["h"])
    z = cg.conv_gru_gate(*gates, hx)
    plain_z = cg.conv_gru_gate_torch(*gates, plain_hx)
    torch.testing.assert_close(z, plain_z, **close)
    torch.testing.assert_close(hx[:, :128], plain_hx[:, :128], **close)
    assert torch.equal(hx[:, 128:], torch.cat(m["xs"], 1))
    new = cg.conv_gru_update(m["q"], m["bq"], m["cq"], plain_z, m["h"])
    plain_new = cg.conv_gru_update_torch(m["q"], m["bq"], m["cq"], plain_z, m["h"])
    torch.cuda.synchronize()
    assert new.dtype == dtype and new.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(new, plain_new, **close)
    assert read_counts() == dict.fromkeys(COUNTERS, 0) | dict.fromkeys(GRU, 1)


def test_conv_gru_raises_on_what_it_does_not_take(dev):
    m = _cell_maps(dev, torch.float16, (128,), 6, 10)
    with pytest.raises(ValueError, match="channels-last"):
        cg.conv_gru_pack(m["h"].contiguous(), m["xs"])
    with pytest.raises(ValueError, match="channels-last"):
        cg.conv_gru_update(m["q"].contiguous(), m["bq"], m["cq"], m["h"], m["h"])
    with pytest.raises(ValueError, match="one of"):
        cg.conv_gru_update(m["q"].double(), m["bq"], m["cq"], m["h"], m["h"])
    with pytest.raises(RuntimeError, match="requires grad"):
        cg.conv_gru_update(m["q"], m["bq"], m["cq"], m["h"], m["h"].clone().requires_grad_())
    with pytest.raises(RuntimeError, match="requires grad"):
        cg.conv_gru_gate(m["zr"], m["bz"].clone().requires_grad_(), m["br"], m["cz"], m["cr"], m["h"],
                         cg.conv_gru_pack(m["h"], m["xs"]))


# cnet's epilogue forms at the raft_kitti_b1 size (384x1248, n_downsample 2):
# the stem and layer1 at full size, layer2 at 1/2, layer3 at 1/4 and the
# 1/4 heads, layer4 at 1/8, layer5 at 1/16; every convolution has a bias
BN_FORMS = {
    "stem": ((1, 64, 384, 1248), "relu", False, None),
    "block_end": ((1, 64, 384, 1248), "relu", True, "relu"),
    "shortcut": ((1, 96, 192, 624), None, False, None),
    "block_end_1/4": ((1, 128, 96, 312), "relu", True, "relu"),
    "conv1_1/8": ((1, 128, 48, 156), "relu", False, None),
    "block_end_1/16": ((1, 128, 24, 78), "relu", True, "relu"),
}


def bn_site(dev, shape, dtype, seed=9):
    """An eval BatchNorm far from identity, a conv bias, a map and a
    residual of ``shape``, channels-last."""
    g = torch.Generator(device=dev).manual_seed(seed)
    c = shape[1]
    bn = torch.nn.BatchNorm2d(c).to(dev).eval().requires_grad_(False)
    bn.running_mean.copy_(2 * torch.randn(c, generator=g, device=dev))
    bn.running_var.copy_(0.1 + 3 * torch.rand(c, generator=g, device=dev))
    bn.weight.copy_(torch.randn(c, generator=g, device=dev))
    bn.bias.copy_(torch.randn(c, generator=g, device=dev))
    rnd = lambda scale: (scale * torch.randn(shape, generator=g, device=dev)).to(dtype, memory_format=CL)  # noqa: E731
    return bn, (0.5 * torch.randn(c, generator=g, device=dev)).to(dtype), rnd(3.0), rnd(1.0)


def assert_epilogue_matches_plain(bn, cb, y, res, act, post):
    """The kernel's output against the plain version's on the same values:
    the same float32 expression, with the card's ``rsqrt`` (a few float32
    units in the last place) and fused multiply-adds, which a rounding to
    the format turns into at most one unit of it. In place, channels-last,
    one launch counted."""
    ref = bak.bn_act_torch(y.clone(), bn, cb, act, res, post)
    reset_counts()
    got = bak.bn_act(y, bn, cb, act, res, post)
    torch.cuda.synchronize()
    assert got is y and read_counts() == dict.fromkeys(COUNTERS, 0) | {"bn_act": 1}
    assert got.is_contiguous(memory_format=torch.channels_last if y.ndim == 4 else torch.channels_last_3d)
    eps = torch.finfo(torch.float32).eps
    torch.testing.assert_close(got.float(), ref.float(), rtol=torch.finfo(y.dtype).eps + 8 * eps,
                               atol=16 * eps * ref.float().abs().max().item())


@pytest.mark.parametrize("form", BN_FORMS)
def test_bn_act_kernel_matches_plain(dev, form):
    shape, act, with_res, post = BN_FORMS[form]
    bn, cb, y, res = bn_site(dev, shape, torch.float16)
    assert_epilogue_matches_plain(bn, cb, y, res if with_res else None, act, post)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_act_kernel_matches_plain_in_other_dtypes(dev, dtype):
    bn, cb, y, res = bn_site(dev, (2, 96, 17, 23), dtype)
    assert_epilogue_matches_plain(bn, cb, y, res, "relu", "relu")


def test_bn_act_raises_on_what_it_does_not_take(dev):
    bn, cb, y, res = bn_site(dev, (1, 64, 6, 10), torch.float16)
    with pytest.raises(ValueError, match="channels-last"):
        bak.bn_act(y.contiguous(), bn, cb, "relu")
    with pytest.raises(ValueError, match="one of"):
        bak.bn_act(y.double(), bn, None, "relu")
    with pytest.raises(ValueError, match="on cpu"):
        bak.bn_act(y, bn.cpu(), None, "relu")
    bn.to(dev)
    with pytest.raises(ValueError, match="res"):
        bak.bn_act(y, bn, cb, "relu", res[:, :, :3].contiguous(memory_format=CL), "relu")
    with pytest.raises(RuntimeError, match="no backward"):
        bak.bn_act(y, bn.requires_grad_(True), cb, "relu")


def test_replay_runs_no_library_batchnorm_and_reads_the_statistics(dev):
    """A profiled replay of the eval forward runs ``cnet``'s ``BN_SITES``
    epilogues and no cuDNN or ATen BatchNorm kernel; a BatchNorm's running
    variance changed in place is read by the next replay, which equals the
    eager forward under the new statistics bit for bit."""
    model = build_model("raft_stereo", device=dev, generator=torch.Generator().manual_seed(0),
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
        model.cnet.layer1[0].norm2.running_var.mul_(4.0)
    after = infer(left, right)
    (captured,) = infer.graphs.values()
    with torch.inference_mode():
        eager = model(left, right)[-1]
    assert captured.replays == 2 and infer.discards == 0
    assert not torch.equal(after, before) and torch.equal(after, eager)
