"""The fused pair's route choice, the ``wgmma`` route's weight packing, its
tile plan and its operands (``ecm_torch/ops/cuda_fused_agg.py``): pure
functions of dtypes, shapes and weights, which decide what the CUDA kernel
is given."""

import pytest
import torch

from ecm_torch.ops.cuda_fused_agg import pack_pair_wgmma, pair_operands, pair_plan, pair_route

SMEM_PER_BLOCK = 232_448  # the dynamic shared memory an H100 block may have
SMS = 132

# the main paths' forms at kitti_infer (48 x 96 x 312 volume): (Cin, Cm, Cout)
MAIN_FORMS = {"dres0": (64, 32, 32), "dres1": (32, 32, 32), "classif3": (32, 32, 1)}
# what csrc/fused_conv3d_pair.cu's header states for them: output rows a
# tile, k1 resident, shared memory a block (the kernel checks the same count)
MAIN_LAYOUT = {"dres0": (2, False, 216_192), "dres1": (2, True, 225_408), "classif3": (4, True, 229_760)}


@pytest.mark.parametrize(
    "dtype,cin,cm,cout,route",
    [
        (torch.bfloat16, 64, 32, 32, "wgmma"),
        (torch.bfloat16, 32, 32, 32, "wgmma"),
        (torch.bfloat16, 32, 32, 1, "wgmma"),
        (torch.bfloat16, 8, 32, 24, "wgmma"),
        (torch.bfloat16, 40, 32, 8, "wgmma"),
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
    plan = pair_plan(dtype, 1, 5, 6, 7, cin, cm, cout)
    assert plan.route == route
    assert plan.smem_bytes <= SMEM_PER_BLOCK


def _decode(packed: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """Read a packed B operand back through the descriptor address formula:
    per (tap, 16-channel k-step) a block of n x 16 bf16 whose element (r, k)
    lies at start + (r/8)*SBO + (k/8)*LBO + (r%8)*16 + (k%8)*2 bytes, LBO =
    128 and SBO = 256 (as the kernel's descriptors say). Returns [27, n, k]."""
    flat = packed.reshape(-1)
    ks = k // 16
    r = torch.arange(n).view(n, 1)
    kk = torch.arange(16).view(1, 16)
    inner = (r // 8) * 256 + (kk // 8) * 128 + (r % 8) * 16 + (kk % 8) * 2
    out = torch.empty(27, n, k, dtype=packed.dtype)
    for tap in range(27):
        for s in range(ks):
            start = (tap * ks + s) * n * 16 * 2
            out[tap, :, 16 * s:16 * (s + 1)] = flat[(start + inner) // 2]
    return out


@pytest.mark.parametrize("cin,cout", [(64, 32), (32, 1), (40, 24), (8, 8), (16, 16)])
def test_pack_pair_wgmma_decodes_to_the_weights(cin, cout):
    g = torch.Generator().manual_seed(cin + cout)
    k1 = torch.randn(32, cin, 3, 3, 3, generator=g)
    k2 = torch.randn(cout, 32, 3, 3, 3, generator=g)
    k1p, k2p = pack_pair_wgmma(k1, k2)
    cin_pad, n2 = -(-cin // 16) * 16, 8 if cout <= 8 else 16 if cout <= 16 else 32
    assert k1p.dtype == k2p.dtype == torch.bfloat16
    assert k1p.shape == (27, cin_pad // 16, 4, 2, 8, 8) and k2p.shape == (27, 2, n2 // 8, 2, 8, 8)
    assert k1p.is_contiguous() and k2p.is_contiguous()
    # decoded [tap, out channel, in channel] = k[o, i, kd, kh, kw], tap = (kd * 3 + kh) * 3 + kw
    k1u = _decode(k1p, 32, cin_pad)
    assert torch.equal(k1u[:, :, :cin], k1.bfloat16().permute(2, 3, 4, 0, 1).reshape(27, 32, cin))
    assert not k1u[:, :, cin:].any()
    k2u = _decode(k2p, n2, 32)
    assert torch.equal(k2u[:, :cout], k2.bfloat16().permute(2, 3, 4, 0, 1).reshape(27, cout, 32))
    assert not k2u[:, cout:].any()


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("form", sorted(MAIN_FORMS))
def test_tile_plan_of_the_main_path(form, batch):
    """Each main-path form runs the wgmma route with the layout the source
    states, fits in a block's shared memory, gives every SM a work item, and
    computes stage 1 over the tile's halo, its D slab's two extra planes and
    the ragged last W tile (312 = 5 x 62 + 2): the stated recompute."""
    cin, cm, cout = MAIN_FORMS[form]
    d, h, w = 48, 96, 312
    plan = pair_plan(torch.bfloat16, batch, d, h, w, cin, cm, cout)
    th, resident, smem = MAIN_LAYOUT[form]
    assert plan.route == "wgmma"
    assert (plan.tile[1:], plan.resident, plan.smem_bytes) == ((th, 62), resident, smem)
    assert plan.smem_bytes <= SMEM_PER_BLOCK and plan.ring == 5
    sd = plan.tile[0]
    nsd = -(-d // sd)
    assert plan.items == batch * nsd * (h // th) * 6 >= SMS
    assert plan.blocks == SMS
    assert plan.recompute == pytest.approx((d + 2 * nsd) * (h // th) * 6 * (th + 2) * 64 / (d * h * w))
    # the slabs chosen at this shape (rounds of 132 blocks x planes an item walks)
    assert sd == ({1: 12, 8: 48} if form == "classif3" else {1: 16, 8: 48})[batch]


@pytest.mark.parametrize(
    "d,sms,sd",
    [(19, 8, 10), (16, 8, 8), (17, 8, 9), (48, 8, 24), (5, 8, 5), (1, 8, 1)],
)
def test_d_slabs_are_even(d, sms, sd):
    """The D slab is an even split that minimises the rounds of blocks times
    the y planes an item computes (its slab and two)."""
    plan = pair_plan(torch.bfloat16, 2, d, 11, 37, 32, 32, 32, sms)
    assert plan.tile == (sd, 2, 62)
    assert plan.items == 2 * -(-d // sd) * 6 * 1 and plan.blocks == min(plan.items, sms)
    rounds = -(-plan.items // plan.blocks)
    for n in range(1, d + 1):
        other = -(-d // n)
        items = 2 * n * 6
        assert rounds * (sd + 2) <= -(-items // min(items, sms)) * (other + 2)


@pytest.mark.parametrize("w,ntw", [(62, 1), (63, 2), (124, 2), (131, 3), (312, 6)])
def test_ragged_w_tiles(w, ntw):
    """W is cut into tiles of 62 outputs (64 y columns less the halo); the
    last one takes what is left."""
    plan = pair_plan(torch.bfloat16, 1, 6, 4, w, 32, 32, 1)
    assert plan.tile[1:] == (4, 62)
    assert plan.items == -(-6 // plan.tile[0]) * ntw
    assert plan.recompute == pytest.approx((6 + 2 * -(-6 // plan.tile[0])) * ntw * 6 * 64 / (6 * 4 * w))


def test_pair_operands_pack_once_per_version():
    """The pair's operands are made from k1, k2 and the vectors as they are
    at each call: after an in-place update of k1, of k2 or of a scale, the
    packed weights decode to the new values and the vectors are the new
    values in f32."""
    g = torch.Generator().manual_seed(0)
    k1, k2 = torch.randn(32, 64, 3, 3, 3, generator=g), torch.randn(1, 32, 3, 3, 3, generator=g)
    # bf16 vectors, so that the f32 copy is a new tensor
    s1, b1, s2, b2 = (torch.randn(n, generator=g).bfloat16() for n in (32, 32, 1, 1))

    def check():
        k1p, k2p, *vecs = pair_operands(k1, s1, b1, k2, s2, b2, "cpu")
        assert torch.equal(_decode(k1p, 32, 64), k1.bfloat16().permute(2, 3, 4, 0, 1).reshape(27, 32, 64))
        assert torch.equal(_decode(k2p, 8, 32)[:, :1], k2.bfloat16().permute(2, 3, 4, 0, 1).reshape(27, 1, 32))
        assert all(v.dtype == torch.float32 and torch.equal(v, w.float()) for v, w in zip(vecs, (s1, b1, s2, b2)))

    check()
    for update in (lambda: k1.add_(1.0), lambda: k2.mul_(-2.0), lambda: s2.mul_(2.0)):
        update()
        check()
