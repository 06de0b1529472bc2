"""The port's kernel modules against the JAX package's Pallas kernels (run in
interpret mode on the CPU): each plain PyTorch version, which is what a
wrapper runs for a CPU tensor, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecm_tpu.ops.pallas_cost_volume import cost_volume_pallas
from ecm_tpu.ops.pallas_fused_agg import fused_conv3d_pair as jax_fused_pair
from ecm_tpu.ops.pallas_regression import fused_upsample_softargmin as jax_regression
from ecm_torch.ops import cost_volume as cv
from ecm_torch.ops.cuda_cost_volume import cost_volume_concat, cost_volume_concat_torch
from ecm_torch.ops.cuda_fused_agg import fused_conv3d_pair, fused_conv3d_pair_torch
from ecm_torch.ops.cuda_regression import (
    fused_upsample_softargmin,
    fused_upsample_softargmin_torch,
    regression_plan,
)
from test_torch_port_util import t, to_torch_kernel


@pytest.mark.parametrize("max_disp", [5, 12])
def test_cost_volume_concat_bit_identical(max_disp):
    rng = np.random.default_rng(0)
    fl = rng.normal(size=(2, 3, 10, 4)).astype(np.float32)
    fr = rng.normal(size=(2, 3, 10, 4)).astype(np.float32)
    ref = np.asarray(cost_volume_pallas(jnp.asarray(fl), jnp.asarray(fr), max_disp, mode="concat"))
    out = cost_volume_concat_torch(t(fl), t(fr), max_disp)
    assert torch.equal(out, torch.from_numpy(np.array(ref)))


def test_cost_volume_dispatch():
    rng = np.random.default_rng(1)
    fl, fr = t(rng.normal(size=(1, 2, 6, 3))), t(rng.normal(size=(1, 2, 6, 3)))
    assert torch.equal(cv.cost_volume(fl, fr, 4, use_pallas=True), cv.cost_volume(fl, fr, 4))
    corr = cv.cost_volume(fl, fr, 4, mode="correlation")
    assert corr.shape == (1, 4, 2, 6, 1)
    torch.testing.assert_close(corr[0, 2, :, 2:, 0], (fl[0, :, 2:] * fr[0, :, :4]).mean(-1))
    assert torch.count_nonzero(corr[0, 2, :, :2]) == 0
    # use_pallas=True takes the correlation kernel's wrapper: on the CPU, the
    # plain builder
    assert torch.equal(cv.cost_volume(fl, fr, 4, mode="correlation", use_pallas=True), corr)


@pytest.fixture(scope="module")
def pair_inputs():
    rng = np.random.default_rng(0)
    b, d, h, w, cin, cm = 1, 6, 6, 10, 6, 5
    return {
        "rng": rng,
        "x": rng.normal(size=(b, d, h, w, cin)).astype(np.float32),
        "k1": rng.normal(size=(3, 3, 3, cin, cm)).astype(np.float32) * 0.2,
        "s1": rng.uniform(0.5, 1.5, cm).astype(np.float32),
        "b1": rng.normal(size=cm).astype(np.float32),
    }


@pytest.mark.parametrize("form", ["ctx", "residual", "classif"])
def test_fused_pair_matches_pallas(pair_inputs, form):
    """The three forms the model runs: dres0 (+ctx), dres1 (relu2 off +
    residual), classif (Cout=1 + bias), with random BN folds."""
    p = pair_inputs
    rng = np.random.default_rng({"ctx": 1, "residual": 2, "classif": 3}[form])
    b, d, h, w, cin = p["x"].shape
    cm = p["k1"].shape[-1]
    cout = 1 if form == "classif" else 4
    k2 = rng.normal(size=(3, 3, 3, cm, cout)).astype(np.float32) * 0.2
    s2 = np.ones(cout, np.float32) if form == "classif" else rng.uniform(0.5, 1.5, cout).astype(np.float32)
    b2 = rng.normal(size=cout).astype(np.float32)
    ctx = rng.normal(size=(b, h, w, cout)).astype(np.float32) if form == "ctx" else None
    opts = {"ctx": {}, "residual": {"relu2": False, "residual": True}, "classif": {"relu2": False}}[form]
    ref = jax_fused_pair(
        jnp.asarray(p["x"]), jnp.asarray(p["k1"]), jnp.asarray(p["s1"]), jnp.asarray(p["b1"]),
        jnp.asarray(k2), jnp.asarray(s2), jnp.asarray(b2),
        None if ctx is None else jnp.asarray(ctx), tile_d=3, tile_h=3, **opts,
    )
    out = fused_conv3d_pair_torch(
        t(p["x"]), to_torch_kernel(p["k1"]), t(p["s1"]), t(p["b1"]),
        to_torch_kernel(k2), t(s2), t(b2), None if ctx is None else t(ctx), **opts,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_regression_matches_pallas():
    """Fixed N(0, 1) cost map (a model output would make the soft-argmin a
    hard argmax at random init)."""
    cost4 = np.random.default_rng(0).normal(size=(2, 6, 5, 7)).astype(np.float32)
    ref = np.asarray(jax_regression(jnp.asarray(cost4), 24))
    out = fused_upsample_softargmin_torch(t(cost4), 24)
    assert out.shape == (2, 20, 28)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)


def test_classif_form_matches_gband_classif_reference():
    """The NDHWC function of the grouped head ``gband_classif_head`` is the
    fused pair in classif form: equal through to_grouped / ungroup_cost."""
    from ecm_tpu.ops.grouped3d import to_grouped, ungroup_cost
    from ecm_tpu.ops.pallas_gband import gband_classif_reference

    rng = np.random.default_rng(4)
    c = 4
    x = rng.normal(size=(1, 8, 4, 6, c)).astype(np.float32)
    k1 = rng.normal(size=(3, 3, 3, c, c)).astype(np.float32) * 0.3
    s1 = rng.uniform(0.5, 1.5, c).astype(np.float32)
    b1 = rng.normal(size=c).astype(np.float32)
    k2 = rng.normal(size=(3, 3, 3, c, 1)).astype(np.float32) * 0.3
    b2 = rng.normal(size=1).astype(np.float32)
    ref = gband_classif_reference(
        to_grouped(jnp.asarray(x)), jnp.asarray(k1), jnp.asarray(s1), jnp.asarray(b1),
        jnp.asarray(k2), jnp.asarray(b2),
    )
    out = fused_conv3d_pair_torch(
        t(x), to_torch_kernel(k1), t(s1), t(b1), to_torch_kernel(k2), torch.ones(1), t(b2),
        relu2=False,
    )
    np.testing.assert_allclose(out[..., 0].numpy(), np.asarray(ungroup_cost(ref)), rtol=1e-4, atol=1e-4)


def test_wrappers_on_cpu_take_the_plain_version():
    """A CPU tensor gets the plain result and no launch is counted."""
    rng = np.random.default_rng(5)
    before = (cost_volume_concat.launches, fused_conv3d_pair.launches, fused_upsample_softargmin.launches)
    fl, fr = t(rng.normal(size=(1, 2, 6, 3))), t(rng.normal(size=(1, 2, 6, 3)))
    assert torch.equal(cost_volume_concat(fl, fr, 3), cost_volume_concat_torch(fl, fr, 3))
    x = t(rng.normal(size=(1, 3, 4, 5, 2)))
    k1, k2 = t(rng.normal(size=(2, 2, 3, 3, 3))), t(rng.normal(size=(1, 2, 3, 3, 3)))
    args = (x, k1, torch.ones(2), torch.zeros(2), k2, torch.ones(1), torch.zeros(1))
    assert torch.equal(fused_conv3d_pair(*args, relu2=False), fused_conv3d_pair_torch(*args, relu2=False))
    c4 = t(rng.normal(size=(1, 2, 3, 4)))
    assert torch.equal(fused_upsample_softargmin(c4, 8), fused_upsample_softargmin_torch(c4, 8))
    after = (cost_volume_concat.launches, fused_conv3d_pair.launches, fused_upsample_softargmin.launches)
    assert after == before == (0, 0, 0)


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(1, 3, 4, 5, 2)
    k1, k2 = torch.zeros(2, 2, 3, 3, 3), torch.zeros(4, 2, 3, 3, 3)
    with pytest.raises(ValueError, match="residual"):
        fused_conv3d_pair(x, k1, torch.ones(2), torch.zeros(2), k2, torch.ones(4), torch.zeros(4), residual=True)
    with pytest.raises(ValueError, match="ctx"):
        fused_conv3d_pair(x, k1, torch.ones(2), torch.zeros(2), k2, torch.ones(4), torch.zeros(4),
                          ctx=torch.zeros(1, 4, 5, 3))
    with pytest.raises(ValueError):
        fused_upsample_softargmin(torch.zeros(1, 3, 2, 2), 8)
    with pytest.raises(ValueError):
        cost_volume_concat(torch.zeros(1, 2, 3, 4), torch.zeros(1, 2, 3, 5), 2)


@pytest.mark.parametrize(
    "shape,tw",
    [((1, 48, 96, 312), 24), ((8, 48, 96, 312), 24), ((4, 48, 64, 128), 64), ((2, 12, 7, 9), 16), ((1, 1, 1, 5), 8)],
)
def test_regression_plan(shape, tw):
    """The regression kernel's tiling: 4 * tw threads in whole warps, the
    fewest idle threads (none at the serving and training widths), its
    shared memory of three staged f32 rows per plane; too many planes
    raise."""
    b, d4, h4, w4 = shape
    plan = regression_plan(*shape)
    tiles = -(-w4 // plan.tw)
    assert plan.tw == tw and (4 * plan.tw) % 32 == 0
    assert plan.blocks == b * h4 * tiles
    assert plan.idle_threads == 4 * (tiles * plan.tw - w4) * b * h4
    assert plan.smem_bytes == d4 * 3 * (plan.tw + 2) * 4
    if w4 in (312, 128):
        assert plan.idle_threads == 0
    assert regression_plan(1, 1500, 2, 312).tw == 8
    with pytest.raises(ValueError, match="shared memory"):
        regression_plan(1, 2000, 2, 312)
