"""The fused pair's route choice, the tensor-core route's weight packing and
its tile plan (``ecm_torch/ops/cuda_fused_agg.py``): pure functions of
dtypes and shapes, which decide what the CUDA kernel is given."""

import pytest
import torch

from ecm_torch.ops.cuda_fused_agg import pack_pair_mma, pair_plan, pair_route

SMEM_PER_BLOCK = 232_448  # the dynamic shared memory an H100 block may have

# the main paths' forms at kitti_infer (48 x 96 x 312 volume): (Cin, Cm, Cout)
MAIN_FORMS = {"dres0": (64, 32, 32), "dres1": (32, 32, 32), "classif3": (32, 32, 1)}


@pytest.mark.parametrize(
    "dtype,cin,cm,cout,route",
    [
        (torch.bfloat16, 64, 32, 32, "tensor_cores"),
        (torch.bfloat16, 32, 32, 32, "tensor_cores"),
        (torch.bfloat16, 32, 32, 1, "tensor_cores"),
        (torch.bfloat16, 8, 32, 24, "tensor_cores"),
        (torch.bfloat16, 40, 32, 8, "tensor_cores"),
        (torch.float32, 64, 32, 32, "cuda_cores"),
        (torch.float32, 32, 32, 1, "cuda_cores"),
        (torch.bfloat16, 6, 5, 3, "cuda_cores"),
        (torch.bfloat16, 12, 32, 32, "cuda_cores"),
        (torch.bfloat16, 32, 16, 32, "cuda_cores"),
        (torch.bfloat16, 32, 32, 4, "cuda_cores"),
        (torch.bfloat16, 32, 32, 64, "cuda_cores"),
    ],
)
def test_route_by_dtype_and_channels(dtype, cin, cm, cout, route):
    assert pair_route(dtype, cin, cm, cout) == route
    assert pair_plan(dtype, 1, 5, 6, 7, cin, cm, cout).route == route


@pytest.mark.parametrize("cin,cout", [(64, 32), (32, 1), (40, 24), (8, 8)])
def test_pack_pair_mma_unpacks_to_the_weights(cin, cout):
    g = torch.Generator().manual_seed(cin + cout)
    k1 = torch.randn(32, cin, 3, 3, 3, generator=g)
    k2 = torch.randn(cout, 32, 3, 3, 3, generator=g)
    k1p, k2p = pack_pair_mma(k1, k2)
    nch, cout_pad = -(-cin // 32), 8 if cout == 1 else cout
    assert k1p.dtype == k2p.dtype == torch.bfloat16
    assert k1p.shape == (3, nch, 9, 32, 40) and k2p.shape == (27, cout_pad, 40)
    assert k1p.is_contiguous() and k2p.is_contiguous()
    # k1p[kd, c, kh * 3 + kw, o, i] = k1[o, 32 c + i, kd, kh, kw]
    k1u = k1p[..., :32].reshape(3, nch, 3, 3, 32, 32).permute(4, 1, 5, 0, 2, 3).reshape(32, 32 * nch, 3, 3, 3)
    assert torch.equal(k1u[:, :cin], k1.bfloat16())
    assert not k1u[:, cin:].any() and not k1p[..., 32:].any()
    # k2p[(kd * 3 + kh) * 3 + kw, o, i] = k2[o, i, kd, kh, kw]
    k2u = k2p[..., :32].reshape(3, 3, 3, cout_pad, 32).permute(3, 4, 0, 1, 2)
    assert torch.equal(k2u[:cout], k2.bfloat16())
    assert not k2u[cout:].any() and not k2p[..., 32:].any()


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("form", sorted(MAIN_FORMS))
def test_tile_plan_of_the_main_path(form, batch):
    """Each main-path form runs the tensor-core route, fits in a block's
    shared memory, fills the card at batch 1 (two blocks or more per SM of
    132), and recomputes less of stage 1 than the CUDA-core route's tile."""
    cin, cm, cout = MAIN_FORMS[form]
    plan = pair_plan(torch.bfloat16, batch, 48, 96, 312, cin, cm, cout)
    assert plan.route == "tensor_cores"
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    assert plan.blocks >= 264 * batch
    assert plan.tile == (16, 8, 16) and plan.blocks == batch * 3 * 12 * 20
    assert plan.recompute == pytest.approx(10 * 18 / 128 * 18 / 16)
    assert plan.recompute < pair_plan(torch.float32, batch, 48, 96, 312, cin, cm, cout).recompute


@pytest.mark.parametrize("d,sd", [(19, 10), (16, 16), (17, 9), (48, 16), (5, 5), (1, 1)])
def test_d_slabs_are_even(d, sd):
    plan = pair_plan(torch.bfloat16, 2, d, 11, 37, 32, 32, 32)
    assert plan.tile[0] == sd
    assert plan.blocks == 2 * -(-d // sd) * 2 * 3
