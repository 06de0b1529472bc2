"""Each CUDA kernel against its plain version on the card, at small shapes.

Marked ``cuda``: skipped without a GPU. The machine with the card has no
JAX, so run these there without the JAX test setup:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py``.
"""

import pytest
import torch

from ecm_torch.ops.cuda_cost_volume import (
    cost_volume_concat,
    cost_volume_concat_torch,
    cost_volume_correlation,
    cost_volume_correlation_torch,
)
from ecm_torch.ops.cuda_fused_agg import fused_conv3d_pair, fused_conv3d_pair_torch, pair_route
from ecm_torch.ops.cuda_gband import (
    conv3d_bn_down,
    conv3d_bn_s1,
    conv3d_bn_torch,
    conv_route,
    gband_conv_s1,
    gband_conv_s1_input_grad,
    gband_conv_s1_torch,
)
from ecm_torch.ops.cuda_gdeconv import deconv3d_bn, deconv3d_bn_torch
from ecm_torch.ops.cuda_regression import (
    fused_upsample_softargmin,
    fused_upsample_softargmin_torch,
    regression_plan,
)
from ecm_torch.ops.upsample import upsample_trilinear

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,c", [(torch.bfloat16, 32), (torch.float32, 3), (torch.bfloat16, 5)])
def test_cost_volume_kernel(dev, dtype, c):
    g = torch.Generator().manual_seed(0)
    fl, fr = (torch.randn(2, 5, 40, c, generator=g).to(dev, dtype) for _ in range(2))
    n = cost_volume_concat.launches
    out = cost_volume_concat(fl, fr, 12)
    torch.cuda.synchronize()
    assert cost_volume_concat.launches == n + 1
    assert torch.equal(out, cost_volume_concat_torch(fl, fr, 12))


# (Cin, Cm, Cout) and shape [B, D, H, W]: the small forms and the odd one on
# the CUDA cores; the main paths' three forms (tc_*) on the wgmma route, at a
# shape that crosses (H, W) tile edges (2 or 4 rows; W 37 and 131 against
# tiles of 62) and, with the card's slab plan, D slabs
PAIR_FORMS = {
    "ctx": ((16, 8, 8), (2, 6, 10, 19)),
    "residual": ((8, 8, 8), (2, 6, 10, 19)),
    "classif": ((8, 8, 1), (2, 6, 10, 19)),
    "odd": ((6, 5, 3), (2, 6, 10, 19)),
    "tc_ctx": ((64, 32, 32), (2, 19, 11, 37)),
    "tc_residual": ((32, 32, 32), (2, 19, 11, 37)),
    "tc_classif": ((32, 32, 1), (2, 19, 11, 37)),
    "tc_wide_ctx": ((64, 32, 32), (2, 19, 11, 131)),
    "tc_wide_residual": ((32, 32, 32), (2, 19, 11, 131)),
    "tc_wide_classif": ((32, 32, 1), (2, 19, 11, 131)),
}


def _pair_case(dev, form, dtype, seed=1):
    g = torch.Generator().manual_seed(seed)
    (cin, cm, cout), (b, d, h, w) = PAIR_FORMS[form]
    kind = form.removeprefix("tc_").removeprefix("wide_")
    x = torch.randn(b, d, h, w, cin, generator=g).to(dev, dtype)
    k1 = torch.randn(cm, cin, 3, 3, 3, generator=g) * 0.2
    k2 = torch.randn(cout, cm, 3, 3, 3, generator=g) * 0.2
    s1, b1 = torch.rand(cm, generator=g) + 0.5, torch.randn(cm, generator=g)
    s2, b2 = torch.rand(cout, generator=g) + 0.5, torch.randn(cout, generator=g)
    ctx = torch.randn(b, h, w, cout, generator=g).to(dev, dtype) if kind == "ctx" else None
    opts = {"residual": {"relu2": False, "residual": True}, "classif": {"relu2": False}}.get(kind, {})
    return [x] + [v.to(dev) for v in (k1, s1, b1, k2, s2, b2)] + [ctx], opts


@pytest.mark.parametrize(
    "form,dtype",
    [pytest.param(f, dt, id=f"dtype{i}-{f}")
     for i, dt in enumerate((torch.float32, torch.bfloat16)) for f in ("ctx", "residual", "classif", "odd")]
    + [pytest.param(f, torch.bfloat16, id=f"dtype1-{f}") for f in PAIR_FORMS if f.startswith("tc_")],
)
def test_fused_pair_kernel(dev, form, dtype):
    args, opts = _pair_case(dev, form, dtype)
    (cin, cm, cout), _ = PAIR_FORMS[form]
    route = "wgmma" if form.startswith("tc_") else "cuda_cores"
    assert pair_route(dtype, cin, cm, cout) == route
    n, by_route = fused_conv3d_pair.launches, dict(fused_conv3d_pair.route_launches)
    out = fused_conv3d_pair(*args, **opts)
    torch.cuda.synchronize()
    assert fused_conv3d_pair.launches == n + 1
    assert fused_conv3d_pair.route_launches[route] == by_route[route] + 1
    ref = fused_conv3d_pair_torch(*args, **opts)
    err = (out.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert err <= (2e-2 if dtype == torch.bfloat16 else 1e-5), err


@pytest.mark.parametrize("form", ["tc_ctx", "tc_residual", "tc_classif"])
def test_fused_pair_kernel_on_a_halo_2_slab(dev, form):
    """A disp rank's slab: its 6 planes with 2 of each neighbour's on either
    side. The wgmma kernel on the slab gives the whole volume's outputs on
    the slab's own planes (the plain version on the whole volume)."""
    args, opts = _pair_case(dev, form, torch.bfloat16, seed=2)
    x, ctx = args[0], args[-1]
    slab = x[:, 4:14].contiguous()
    n = fused_conv3d_pair.route_launches["wgmma"]
    out = fused_conv3d_pair(slab, *args[1:-1], ctx, **opts)
    torch.cuda.synchronize()
    assert fused_conv3d_pair.route_launches["wgmma"] == n + 1
    ref = fused_conv3d_pair_torch(x, *args[1:-1], ctx, **opts)[:, 6:12]
    err = (out[:, 2:-2].float() - ref.float()).abs().max() / ref.float().abs().max()
    assert err <= 2e-2, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_regression_kernel(dev, dtype):
    g = torch.Generator().manual_seed(2)
    c4 = torch.randn(2, 12, 7, 9, generator=g).to(dev, dtype)
    out = fused_upsample_softargmin(c4, 48)
    torch.cuda.synchronize()
    ref = fused_upsample_softargmin_torch(c4, 48)
    assert (out - ref).abs().max() <= 1e-3


def _rel(out, ref):
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def _tol(dtype):
    return 2e-2 if dtype == torch.bfloat16 else 1e-5


@pytest.mark.parametrize("form", ["plain", "ctx", "residual", "odd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3d_bn_s1_kernel(dev, form, dtype):
    g = torch.Generator().manual_seed(3)
    cin, cout = {"plain": (16, 8), "ctx": (8, 8), "residual": (8, 24), "odd": (5, 3)}[form]
    b, d, h, w = 2, 5, 6, 13
    x = torch.randn(b, d, h, w, cin, generator=g).to(dev, dtype)
    k = (torch.randn(cout, cin, 3, 3, 3, generator=g) * 0.2).to(dev)
    s, bb = (torch.rand(cout, generator=g) + 0.5).to(dev), torch.randn(cout, generator=g).to(dev)
    add = {"ctx": (b, 1, h, w, cout), "residual": (b, d, h, w, cout)}.get(form)
    add = None if add is None else torch.randn(*add, generator=g).to(dev, dtype)
    relu = form != "residual"
    n = conv3d_bn_s1.launches
    out = conv3d_bn_s1(x, k, s, bb, add, relu=relu)
    torch.cuda.synchronize()
    assert conv3d_bn_s1.launches == n + 1
    assert _rel(out, conv3d_bn_torch(x, k, s, bb, add, relu=relu)) <= _tol(dtype)


@pytest.mark.parametrize("cin,cout", [(8, 16), (5, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3d_bn_down_kernel(dev, cin, cout, dtype):
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 7, 6, 11, cin, generator=g).to(dev, dtype)
    k = (torch.randn(cout, cin, 3, 3, 3, generator=g) * 0.2).to(dev)
    s, bb = (torch.rand(cout, generator=g) + 0.5).to(dev), torch.randn(cout, generator=g).to(dev)
    n = conv3d_bn_down.launches
    out = conv3d_bn_down(x, k, s, bb)
    torch.cuda.synchronize()
    assert conv3d_bn_down.launches == n + 1
    assert out.shape == (2, 4, 3, 6, cout)
    assert _rel(out, conv3d_bn_torch(x, k, s, bb, stride=2)) <= _tol(dtype)


@pytest.mark.parametrize("cin,cout,with_add", [(16, 8, True), (16, 8, False), (5, 3, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deconv3d_bn_kernel(dev, cin, cout, with_add, dtype):
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 3, 5, 7, cin, generator=g).to(dev, dtype)
    k = (torch.randn(cin, cout, 3, 3, 3, generator=g) * 0.2).to(dev)
    s, bb = (torch.rand(cout, generator=g) + 0.5).to(dev), torch.randn(cout, generator=g).to(dev)
    add = torch.randn(2, 6, 10, 14, cout, generator=g).to(dev, dtype) if with_add else None
    n = deconv3d_bn.launches
    out = deconv3d_bn(x, k, s, bb, add)
    torch.cuda.synchronize()
    assert deconv3d_bn.launches == n + 1
    assert _rel(out, deconv3d_bn_torch(x, k, s, bb, add)) <= _tol(dtype)


@pytest.mark.parametrize("cin,cout", [(16, 8), (8, 16), (5, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gband_conv_s1_kernel(dev, cin, cout, dtype):
    """Forward and input gradient through the kernel (one launch each),
    against the plain version's autograd; the weight gradient (cuDNN) too."""
    g = torch.Generator().manual_seed(6)
    x = torch.randn(2, 5, 6, 13, cin, generator=g).to(dev, dtype)
    w = (torch.randn(cout, cin, 3, 3, 3, generator=g) * 0.2).to(dev)
    dy = torch.randn(2, 5, 6, 13, cout, generator=g).to(dev, dtype)
    n = (gband_conv_s1.launches, gband_conv_s1.backward_launches, conv3d_bn_s1.launches)
    xk, wk = x.clone().requires_grad_(), w.clone().requires_grad_()
    out = gband_conv_s1(xk, wk)
    out.backward(dy)
    torch.cuda.synchronize()
    assert (gband_conv_s1.launches, gband_conv_s1.backward_launches, conv3d_bn_s1.launches) == (
        n[0] + 1, n[1] + 1, n[2])
    xp, wp = x.clone().requires_grad_(), w.clone().requires_grad_()
    ref = gband_conv_s1_torch(xp, wp)
    ref.backward(dy)
    assert _rel(out, ref) <= _tol(dtype)
    assert _rel(xk.grad, xp.grad) <= _tol(dtype)
    assert _rel(wk.grad, wp.grad) <= _tol(dtype)


@pytest.mark.parametrize("dtype,c", [(torch.bfloat16, 32), (torch.float32, 5)])
def test_correlation_kernel(dev, dtype, c):
    """The correlation kernel against the plain builder (f32 sums of the
    same products: rel 1e-5 in f32, one bf16 rounding in bf16), and its
    Function backward (the plain builder's VJP) against autograd."""
    g = torch.Generator().manual_seed(7)
    fl, fr = (torch.randn(2, 5, 40, c, generator=g).to(dev, dtype) for _ in range(2))
    n = cost_volume_correlation.launches
    a, b = fl.clone().requires_grad_(), fr.clone().requires_grad_()
    out = cost_volume_correlation(a, b, 12)
    torch.cuda.synchronize()
    assert cost_volume_correlation.launches == n + 1
    ref = cost_volume_correlation_torch(fl, fr, 12)
    assert out.shape == (2, 12, 5, 40, 1)
    assert _rel(out, ref) <= (1e-2 if dtype == torch.bfloat16 else 1e-5)
    gout = torch.randn(out.shape, generator=g).to(dev, dtype)
    out.backward(gout)
    ap, bp = fl.clone().requires_grad_(), fr.clone().requires_grad_()
    cost_volume_correlation_torch(ap, bp, 12).backward(gout)
    assert torch.equal(a.grad, ap.grad) and torch.equal(b.grad, bp.grad)


@pytest.mark.parametrize("d_start,planes", [(0, 6), (6, 6), (9, 5), (38, 4), (45, 3)])
@pytest.mark.parametrize("w", [40, 100])
@pytest.mark.parametrize("mode,dtype,c", [("concat", torch.bfloat16, 32), ("concat", torch.float32, 3),
                                          ("correlation", torch.bfloat16, 32), ("correlation", torch.float32, 5)])
def test_cost_volume_kernels_over_a_range(dev, mode, dtype, c, w, d_start, planes):
    """Both kernels over planes ``d_start .. d_start + planes`` (a rank's
    range; past the image's width the planes are zero), one tile of columns
    and two: against the plain builder over the range (concat bit for bit,
    correlation as ``test_correlation_kernel``) and equal to the kernel's
    whole volume's planes; the range's backward is the plain builder's."""
    g = torch.Generator().manual_seed(11)
    fl, fr = (torch.randn(2, 3, w, c, generator=g).to(dev, dtype) for _ in range(2))
    kernel, plain = {"concat": (cost_volume_concat, cost_volume_concat_torch),
                     "correlation": (cost_volume_correlation, cost_volume_correlation_torch)}[mode]
    a, b = fl.clone().requires_grad_(), fr.clone().requires_grad_()
    out = kernel(a, b, planes, d_start)
    torch.cuda.synchronize()
    ref = plain(fl, fr, planes, d_start)
    assert out.shape == ref.shape
    if mode == "concat":
        assert torch.equal(out, ref)
    else:
        assert _rel(out, ref) <= (1e-2 if dtype == torch.bfloat16 else 1e-5) or ref.abs().max() == 0
    assert torch.equal(out, kernel(fl, fr, d_start + planes)[:, d_start:])
    gout = torch.randn(out.shape, generator=g).to(dev, dtype)
    out.backward(gout)
    ap, bp = fl.clone().requires_grad_(), fr.clone().requires_grad_()
    plain(ap, bp, planes, d_start).backward(gout)
    assert torch.equal(a.grad, ap.grad) and torch.equal(b.grad, bp.grad)


# the tensor-core conv core (csrc/conv_wgmma.cuh) at ragged shapes: W not a
# multiple of the 16-wide tile, D = 1, odd H, B = 2; (mode, [B, D, H, W], Cin, Cout)
RAGGED = {
    "s1_w37": ("s1", (2, 5, 9, 37), 32, 32),
    "s1_d1": ("s1", (2, 1, 7, 21), 64, 32),
    "s1_oddh": ("s1", (2, 4, 11, 16), 32, 64),
    "s2_w37": ("s2", (2, 5, 9, 37), 32, 64),
    "s2_d1": ("s2", (2, 1, 7, 21), 32, 64),
    "s2_oddh": ("s2", (2, 6, 11, 18), 16, 24),
    "t_w19": ("transposed", (2, 3, 5, 19), 64, 32),
    "t_d1": ("transposed", (2, 1, 7, 9), 64, 32),
    "t_oddh": ("transposed", (2, 2, 9, 16), 32, 16),
}


@pytest.mark.parametrize(
    "form,with_add",
    [(f, a) for f in sorted(RAGGED) for a in (False, True) if not (a and f.startswith("s2"))],
)
def test_conv_core_ragged(dev, form, with_add):
    """Each mode of the conv core against its plain version where the tiles,
    slabs and ring meet the volume's edges, with and without the add."""
    mode, (b, d, h, w), cin, cout = RAGGED[form]
    assert conv_route(mode, torch.bfloat16, cin, cout) == "tensor_cores"
    g = torch.Generator().manual_seed(8)
    x = torch.randn(b, d, h, w, cin, generator=g).to(dev, torch.bfloat16)
    s, bb = (torch.rand(cout, generator=g) + 0.5).to(dev), torch.randn(cout, generator=g).to(dev)
    if mode == "transposed":
        k = (torch.randn(cin, cout, 3, 3, 3, generator=g) * 0.2).to(dev)
        add = torch.randn(b, 2 * d, 2 * h, 2 * w, cout, generator=g).to(dev, torch.bfloat16) if with_add else None
        out = deconv3d_bn(x, k, s, bb, add)
        ref = deconv3d_bn_torch(x, k, s, bb, add)
    else:
        k = (torch.randn(cout, cin, 3, 3, 3, generator=g) * 0.2).to(dev)
        if mode == "s2":  # takes no add
            out = conv3d_bn_down(x, k, s, bb)
            ref = conv3d_bn_torch(x, k, s, bb, stride=2)
        else:
            add = torch.randn(b, d, h, w, cout, generator=g).to(dev, torch.bfloat16) if with_add else None
            out = conv3d_bn_s1(x, k, s, bb, add, relu=not with_add)
            ref = conv3d_bn_torch(x, k, s, bb, add, relu=not with_add)
    torch.cuda.synchronize()
    assert out.shape == ref.shape
    assert _rel(out, ref) <= 2e-2


def test_gband_input_grad_ragged(dev):
    """The input gradient 32 -> 64 through the conv core at a ragged shape."""
    g = torch.Generator().manual_seed(9)
    wt = (torch.randn(32, 64, 3, 3, 3, generator=g) * 0.1).to(dev, torch.bfloat16)
    dy = torch.randn(2, 3, 9, 37, 32, generator=g).to(dev, torch.bfloat16)
    dx = gband_conv_s1_input_grad(dy, wt)
    torch.cuda.synchronize()
    assert _rel(dx, gband_conv_s1_torch(dy, wt.flip(2, 3, 4).transpose(0, 1))) <= 2e-2


# the redesigned regression at ragged shapes: D/4 = 1, H/4 = 1, W/4 not a
# multiple of the plan's tile (several tiles, the last one partly idle)
@pytest.mark.parametrize("shape", [(1, 1, 5, 37), (2, 12, 1, 9), (1, 48, 3, 100), (2, 6, 4, 37)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_regression_kernel_ragged(dev, shape, dtype):
    b, d4, h4, w4 = shape
    plan = regression_plan(*shape)
    assert plan.tw % 8 == 0 and plan.blocks == b * h4 * -(-w4 // plan.tw)
    g = torch.Generator().manual_seed(10)
    c4 = torch.randn(*shape, generator=g).to(dev, dtype)
    n = fused_upsample_softargmin.launches
    out = fused_upsample_softargmin(c4, 4 * d4)
    torch.cuda.synchronize()
    assert fused_upsample_softargmin.launches == n + 1
    assert out.shape == (b, 4 * h4, 4 * w4)
    assert (out - fused_upsample_softargmin_torch(c4, 4 * d4)).abs().max() <= 1e-3


@pytest.mark.parametrize("shape", [(2, 12, 7, 9), (1, 48, 3, 37)])
def test_regression_kernel_hard_argmin(dev, shape):
    """Costs scaled by 1e6 (random init gives 1e6-1e8): the softmax is a hard
    argmin. The output is finite everywhere and equals the index of the
    plain version's full-resolution minimum wherever that minimum leads the
    next value by more than 1e3 (1e-3 of the scale; the two versions' values
    differ by f32 roundings of 1e6, about 0.1), to 1e-4 px."""
    b, d4, h4, w4 = shape
    g = torch.Generator().manual_seed(11)
    c4 = (torch.randn(*shape, generator=g) * 1e6).to(dev)
    out = fused_upsample_softargmin(c4, 4 * d4)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    up = upsample_trilinear(c4, (4 * d4, 4 * h4, 4 * w4))
    low = up.topk(2, dim=1, largest=False)
    unique = (low.values[:, 1] - low.values[:, 0]) > 1e3
    assert unique.float().mean() > 0.5
    # the kernel's num / den is d * e / e with e = ex2(0): equal up to f32 rounding
    torch.testing.assert_close(out[unique], low.indices[:, 0][unique].float(), rtol=0, atol=1e-4)


# the redesigned correlation kernel (test_correlation_kernel above takes W
# = 40, below the 64-column tile): W < D, and several tiles with a ragged
# last one; f32 at C = 5, bf16 at C = 32
@pytest.mark.parametrize("w,d", [(10, 24), (150, 48)], ids=["w_lt_d", "tiles"])
@pytest.mark.parametrize("dtype,c", [(torch.bfloat16, 32), (torch.float32, 5)])
def test_correlation_kernel_ragged(dev, dtype, c, w, d):
    g = torch.Generator().manual_seed(12)
    fl, fr = (torch.randn(2, 3, w, c, generator=g).to(dev, dtype) for _ in range(2))
    n = cost_volume_correlation.launches
    out = cost_volume_correlation(fl, fr, d)
    torch.cuda.synchronize()
    assert cost_volume_correlation.launches == n + 1
    ref = cost_volume_correlation_torch(fl, fr, d)
    assert out.shape == ref.shape == (2, d, 3, w, 1)
    assert _rel(out, ref) <= (1e-2 if dtype == torch.bfloat16 else 1e-5)
    mask = torch.arange(w, device=dev) < torch.arange(d, device=dev)[:, None]  # [D, W]: w < d
    assert torch.count_nonzero(out[:, mask.nonzero()[:, 0], :, mask.nonzero()[:, 1]]) == 0


def test_conv_core_cout1(dev):
    """The tensor-core conv core at Cout = 1: ``conv3d_bn_s1`` 32 -> 1 and
    the input gradient 32 -> 1 of ``gband_conv_s1`` (dres0_1 of the
    correlation model, whose volume has one channel), at a ragged shape."""
    assert conv_route("s1", torch.bfloat16, 32, 1) == "tensor_cores"
    g = torch.Generator().manual_seed(13)
    x = torch.randn(2, 5, 9, 37, 32, generator=g).to(dev, torch.bfloat16)
    k = (torch.randn(1, 32, 3, 3, 3, generator=g) * 0.2).to(dev)
    s, bb = (torch.rand(1, generator=g) + 0.5).to(dev), torch.randn(1, generator=g).to(dev)
    out = conv3d_bn_s1(x, k, s, bb)
    wt = (torch.randn(32, 1, 3, 3, 3, generator=g) * 0.2).to(dev, torch.bfloat16)
    n = gband_conv_s1.backward_launches
    dx = gband_conv_s1_input_grad(x, wt)
    torch.cuda.synchronize()
    assert gband_conv_s1.backward_launches == n + 1
    assert out.shape == dx.shape == (2, 5, 9, 37, 1)
    assert _rel(out, conv3d_bn_torch(x, k, s, bb)) <= 2e-2
    assert _rel(dx, gband_conv_s1_torch(x, wt.flip(2, 3, 4).transpose(0, 1))) <= 2e-2
