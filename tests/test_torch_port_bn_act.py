"""Eval BatchNorm as one epilogue (``ecm_torch/ops/bn_act.py``) on the CPU:
the plain version against ``nn.BatchNorm2d``/``3d`` in eval followed by the
plain activation, residual sum and ReLU, in every form the kernel takes;
the kernel's tiles; what the wrapper refuses; and which sites reach it: the
eval BatchNorms of RAFT-Stereo's ``cnet`` and of IGEV-Stereo, and no
instance norm, training-mode BatchNorm or ECM's ``ConvBN``. The Triton
kernel itself runs on the card (``tests/test_torch_port_raft_cuda.py``,
``tests/test_torch_port_igev_cuda.py``)."""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from ecm_torch.models import build_model, igev_stereo, layers
from ecm_torch.ops import bn_act as bak
from test_torch_port_util import torch_threads

CL = {4: torch.channels_last, 5: torch.channels_last_3d}
ACTS = {None: lambda t: t, "relu": F.relu, "relu6": F.relu6, "leaky_relu": nn.LeakyReLU(0.01)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    with torch_threads(1):
        yield


def batch_norm(ndim: int, c: int, g: torch.Generator) -> nn.Module:
    """An eval BatchNorm with statistics and an affine far from identity."""
    bn = (nn.BatchNorm2d if ndim == 4 else nn.BatchNorm3d)(c).eval()
    with torch.no_grad():
        bn.running_mean.copy_(2 * torch.randn(c, generator=g))
        bn.running_var.copy_(0.1 + 3 * torch.rand(c, generator=g))
        bn.weight.copy_(torch.randn(c, generator=g))
        bn.bias.copy_(torch.randn(c, generator=g))
    return bn


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("shape", [(2, 24, 5, 7), (1, 16, 3, 4, 6)], ids=["2d", "3d"])
@pytest.mark.parametrize("post", [None, "relu"])
@pytest.mark.parametrize("with_res", [False, True], ids=["no_res", "res"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("act", list(ACTS), ids=lambda a: a or "none")
def test_plain_version_is_batchnorm_then_the_activation(act, with_bias, with_res, post, shape, dtype):
    """``post(res + act(BatchNorm(y + conv_bias)))`` with the library's eval
    BatchNorm in float32 on the same values: in float32 to a few roundings
    (the library normalises as ``x alpha + beta``, the epilogue as
    ``(x - mean) alpha + bias``); in float16 within one float16 rounding of
    that (float32 inside, one rounding). ``y`` is written in place and keeps
    its channels-last layout."""
    g = torch.Generator().manual_seed(len(shape) * 7 + list(ACTS).index(act))
    c, ndim = shape[1], len(shape)
    bn = batch_norm(ndim, c, g)
    y = (3 * torch.randn(shape, generator=g)).to(dtype, memory_format=CL[ndim])
    cb = (0.5 * torch.randn(c, generator=g)).to(dtype) if with_bias else None
    res = torch.randn(shape, generator=g).to(dtype, memory_format=CL[ndim]) if with_res else None
    view = (1, c) + (1,) * (ndim - 2)
    with torch.no_grad():
        ref = ACTS[act](bn(y.float() + (cb.float().view(view) if with_bias else 0)))
        ref = ACTS[post](ref + res.float() if with_res else ref)
    before = y.data_ptr()
    got = bak.bn_act_torch(y, bn, cb, act, res, post)
    assert got is y and y.data_ptr() == before and got.dtype == dtype and got.is_contiguous(memory_format=CL[ndim])
    eps = torch.finfo(torch.float32).eps
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=8 * eps, atol=8 * eps * ref.abs().max().item())
    else:
        rounded = ref.to(dtype).float()
        ulp = torch.finfo(dtype).eps * torch.maximum(rounded.abs(), torch.tensor(2.0**-14))
        assert ((got.float() - ref).abs() <= ulp).all()


@pytest.mark.parametrize("channels, lanes", [
    (64, 64), (128, 64), (96, 32),  # cnet
    (32, 32), (24, 8), (144, 16), (192, 64), (576, 64), (960, 64), (160, 32),  # MobileNetV2
    (8, 8), (16, 16), (48, 16), (80, 16),  # the BasicConvs, 2-D and 3-D
    (3, 1), (6, 2), (1024, 64)])  # odd and wide channels
def test_rows_are_runs_of_channels(channels, lanes):
    """A row of a program's tile is the widest power-of-two run of channels
    (at most ``LANES``) that divides the channels, so a row never straddles
    two pixels and a program's ``TILE`` elements are whole rows; powers of
    two, as ``tl.arange`` needs."""
    assert bak.lanes(channels) == lanes
    assert channels % lanes == 0 and lanes & (lanes - 1) == 0 and bak.TILE % lanes == 0
    assert lanes == bak.LANES or (channels // lanes) % 2 == 1


def test_wrapper_refuses_what_the_kernel_does_not_take():
    g = torch.Generator().manual_seed(1)
    bn = batch_norm(4, 16, g)
    y = torch.randn(1, 16, 4, 5, generator=g).half().contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        bak._check(y, bn, None, "relu", y.clone(), "relu")  # takes this
        for args, match in [
            ((y.contiguous(), bn, None, None, None, None), "channels-last"),
            ((y.double(), bn, None, None, None, None), "float64"),
            ((y, bn, None, "gelu", None, None), "act"),
            ((y, bn, None, None, None, "relu6"), "post"),
            ((y, batch_norm(4, 16, g).train(), None, None, None, None), "eval"),
            ((y, bn, torch.zeros(8).half(), None, None, None), "contiguous of 16"),
            ((y, bn, None, None, y.float(), None), "res"),
            ((y, bn, None, None, y[:, :, :2].contiguous(memory_format=torch.channels_last), None), "res"),
        ]:
            with pytest.raises(ValueError, match=match):
                bak._check(*args)
    with pytest.raises(RuntimeError, match="no backward"):  # the norm's parameters require grad
        bak._check(y, bn, None, None, None, None)
    with pytest.raises(ValueError, match="bias to its convolution"):
        bak.norm_act(y.float(), nn.InstanceNorm2d(16), conv_bias=torch.zeros(16))


def test_epilogue_reaches_eval_batchnorms_alone(monkeypatch):
    """A recorder in place of ``bn_act``: an eval forward of IGEV-Stereo
    reaches it at every BatchNorm it applies (104: MobileNetV2's 48, ``cnet``'s
    33, the ``BasicConv``s' 23), each with its own norm; RAFT-Stereo's ``cnet``
    at its 33; ``fnet``'s instance norms, ``BasicConvIN``, a training-mode
    ``cnet`` and ECM's ``ConvBN`` never."""
    calls = []
    real = bak.bn_act
    monkeypatch.setattr(bak, "bn_act", lambda y, norm, *a: calls.append(norm) or real(y, norm, *a))
    g = torch.Generator().manual_seed(2)
    igev = build_model("igev_stereo", device="cpu", generator=g, dtype=torch.float32, max_disp=64, iters=1)
    left, right = torch.randn(1, 64, 128, 3, generator=g), torch.randn(1, 64, 128, 3, generator=g)
    with torch.inference_mode():
        igev(left, right)
    applied = [m for n, m in igev.named_modules() if bak.is_eval_bn(m) and n != "cost_agg.conv1_up.bn"]
    assert len(calls) == len(applied) == 104 and set(map(id, calls)) == set(map(id, applied))
    img = torch.randn(1, 3, 32, 64, generator=g).contiguous(memory_format=torch.channels_last)
    raft = build_model("raft_stereo", device="cpu", generator=g, dtype=torch.float32)
    with torch.inference_mode():
        calls.clear()
        raft.cnet(img)
        assert len(calls) == 33
        calls.clear()
        raft.fnet(img)
        igev_stereo.BasicConvIN(3, 8, kernel_size=3, padding=1).to(memory_format=torch.channels_last)(img)
        layers.ConvBN(3, 8).eval()(img.permute(0, 2, 3, 1))
        layers.ConvBN(3, 8, ndim=3).eval()(torch.randn(1, 4, 6, 8, 3, generator=g))
        raft.cnet.train()(img)
    assert calls == []
