"""The conv kernels' route, tile plan and packed weights
(``ecm_torch/ops/cuda_gband.py``: ``conv_route``, ``conv_plan``,
``pack_conv_wgmma``) and the BatchNorm fold (``models/layers.fold_bn``):
pure functions of dtypes, shapes and weights, which decide what the CUDA
kernels are given."""

import pytest
import torch
import torch.nn as nn

from ecm_torch.models.layers import _fold_bn, fold_bn
from ecm_torch.ops.cuda_gband import (
    SMEM_PER_BLOCK,
    conv_plan,
    conv_route,
    pack_conv_wgmma,
)

# the main paths' conv forms: (mode, x [B, D, H, W], Cin, Cout)
MAIN_FORMS = {
    "dres0_1": ("s1", (1, 48, 96, 312), 64, 32),
    "dres_32": ("s1", (1, 48, 96, 312), 32, 32),
    "dres0_1_b8": ("s1", (8, 48, 96, 312), 64, 32),
    "dres_32_b8": ("s1", (8, 48, 96, 312), 32, 32),
    "train_fwd_64": ("s1", (4, 48, 64, 128), 64, 32),
    "train_fwd_32": ("s1", (4, 48, 64, 128), 32, 32),
    "train_dgrad_64": ("s1", (4, 48, 64, 128), 32, 64),
    "down": ("s2", (1, 48, 96, 312), 32, 64),
    "down_b8": ("s2", (8, 48, 96, 312), 32, 64),
    "transposed": ("transposed", (1, 24, 48, 156), 64, 32),
    "transposed_b8": ("transposed", (8, 24, 48, 156), 64, 32),
}


def _out_dims(mode, d, h, w):
    if mode == "s2":
        return (d - 1) // 2 + 1, (h - 1) // 2 + 1, (w - 1) // 2 + 1
    return (d, h, w) if mode == "s1" else (2 * d, 2 * h, 2 * w)


@pytest.mark.parametrize("form", sorted(MAIN_FORMS))
def test_plan_of_the_main_paths(form):
    """Each main-path form runs on the tensor cores, fits in a block's shared
    memory with a ring that holds the planes of one step (the planes a step
    reads are waited for one by one, so a third plane loads under the first
    two's products), tiles the whole volume, and keeps the card busy: one
    block per SM, or one per work item where there are fewer."""
    mode, (b, d, h, w), cin, cout = MAIN_FORMS[form]
    plan = conv_plan(mode, torch.bfloat16, b, d, h, w, cin, cout)
    assert plan.route == "tensor_cores"
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    assert plan.ring >= (2 if mode == "transposed" else 3)
    th, tw = plan.tile
    # the tiles cover the (H, W) extent, the slabs the steps along D
    do, ho, wo = _out_dims(mode, d, h, w)
    steps, (eh, ew) = (d, (h, w)) if mode == "transposed" else (do, (ho, wo))
    tiles = -(-eh // th) * -(-ew // tw)
    assert -(-eh // th) * th >= eh and -(-ew // tw) * tw >= ew
    assert plan.items == b * tiles * -(-steps // plan.sd)
    assert plan.sd * -(-steps // plan.sd) >= steps > plan.sd * (-(-steps // plan.sd) - 1)
    assert plan.blocks == min(plan.items, 132)
    # the resident weights and the ring: 27 taps x Cin_pad x Cout_pad bf16
    assert plan.cin_pad == -(-cin // 16) * 16 and plan.cout_pad in (16, 32, 64)
    assert plan.smem_bytes > 27 * plan.cin_pad * plan.cout_pad * 2


def test_plan_weights_are_the_issues_sizes():
    """The resident weight of 64->32 and 32->64 is 110,592 B, of 32->32
    55,296 B; the stride-2 form (32->64) fits with its 1 x 64 tile and one
    warpgroup, where two output rows (a 5 x 129 halo) would not hold the
    three planes a step reads beside the weights."""
    for mode, cin, cout, wbytes in (("s1", 64, 32, 110_592), ("s1", 32, 64, 110_592),
                                     ("s1", 32, 32, 55_296), ("s2", 32, 64, 110_592)):
        plan = conv_plan(mode, torch.bfloat16, 1, 48, 96, 312, cin, cout)
        assert 27 * plan.cin_pad * plan.cout_pad * 2 == wbytes
    down = conv_plan("s2", torch.bfloat16, 1, 48, 96, 312, 32, 64)
    assert down.tile == (1, 64) and down.threads == 256
    plane = (2 * 1 + 1) * (2 * 64 + 1) * 32 * 2
    assert down.ring == 4 and down.smem_bytes == 128 + 110_592 + 4 * plane <= SMEM_PER_BLOCK
    assert 128 + 110_592 + 3 * (2 * 2 + 1) * (2 * 64 + 1) * 32 * 2 > SMEM_PER_BLOCK


@pytest.mark.parametrize(
    "mode,dtype,cin,cout,route",
    [
        ("s1", torch.bfloat16, 64, 32, "tensor_cores"),
        ("s1", torch.bfloat16, 32, 64, "tensor_cores"),
        ("s1", torch.bfloat16, 8, 24, "tensor_cores"),
        ("s1", torch.bfloat16, 40, 3, "tensor_cores"),
        ("s2", torch.bfloat16, 32, 64, "tensor_cores"),
        ("transposed", torch.bfloat16, 64, 32, "tensor_cores"),
        ("s1", torch.float32, 64, 32, "cuda_cores"),
        ("s1", torch.bfloat16, 5, 3, "cuda_cores"),
        ("s1", torch.bfloat16, 12, 16, "cuda_cores"),
        ("s1", torch.bfloat16, 72, 32, "cuda_cores"),
        ("s1", torch.bfloat16, 32, 72, "cuda_cores"),
        ("s1", torch.bfloat16, 64, 64, "cuda_cores"),
        ("transposed", torch.float32, 16, 8, "cuda_cores"),
    ],
)
def test_route_by_dtype_and_channels(mode, dtype, cin, cout, route):
    """bf16 with Cin % 8 == 0, Cin and Cout up to 64 and weights that fit
    beside the ring take the tensor cores; f32, odd Cin and the rest the
    CUDA cores."""
    assert conv_route(mode, dtype, cin, cout) == route
    assert conv_plan(mode, dtype, 2, 5, 6, 13, cin, cout).route == route


@pytest.mark.parametrize("cin,cout", [(64, 32), (32, 32), (32, 64), (8, 16), (40, 24)])
def test_pack_conv_wgmma_unpacks_to_the_weights(cin, cout):
    """Element (tap, ci, co) of the packed weight sits at [tap, ci // 16, co
    // 8, (ci % 16) // 8, co % 8, ci % 8], zero in the pads."""
    g = torch.Generator().manual_seed(cin + cout)
    k = torch.randn(cout, cin, 3, 3, 3, generator=g)
    p = pack_conv_wgmma(k)
    cin_pad, cout_pad = -(-cin // 16) * 16, 16 if cout <= 16 else 32 if cout <= 32 else 64
    assert p.dtype == torch.bfloat16 and p.is_contiguous()
    assert p.shape == (27, cin_pad // 16, cout_pad // 8, 2, 8, 8)
    # (tap, ks, j, h, r, e) -> [co = 8 j + r, ci = 16 ks + 8 h + e, kd, kh, kw]
    u = p.permute(2, 4, 1, 3, 5, 0).reshape(cout_pad, cin_pad, 3, 3, 3)
    assert torch.equal(u[:cout, :cin], k.bfloat16())
    assert not u[cout:].any() and not u[:, cin:].any()


def test_fold_bn_is_kept_without_grad_and_follows_updates():
    """The fold is ``_fold_bn`` of the module's four tensors as they are at
    each call, with grad and without, before and after in-place updates of
    the scale and the statistics: nothing is kept from one call to the
    next."""
    bn = nn.BatchNorm3d(4)
    with torch.no_grad():
        bn.running_var.uniform_(0.5, 2.0)
        bn.running_mean.uniform_(-1.0, 1.0)
    folds = []
    for update in (lambda: None, lambda: bn.weight.mul_(2.0), lambda: bn.running_var.mul_(4.0)):
        with torch.no_grad():
            update()
            scale, bias = fold_bn(bn)
            want = _fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var)
            assert torch.equal(scale, want[0]) and torch.equal(bias, want[1]) and not scale.requires_grad
            assert fold_bn(bn)[0] is not scale
        with_grad = fold_bn(bn)
        assert with_grad[0].requires_grad and torch.equal(with_grad[0], scale) and torch.equal(with_grad[1], bias)
        folds.append(scale)
    assert torch.equal(folds[1], 2 * folds[0]) and (folds[2] < folds[1]).all()
