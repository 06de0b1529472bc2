"""The port's layer-kernel ("grouped") path against the JAX package's grouped
Pallas kernels, which run in interpret mode on the CPU: each new plain
version (what a wrapper runs for a CPU tensor) through ``from_grouped`` on
the same numpy inputs, the whole grouped ``ECMStereo`` forward, ``ECMBasic``,
and how ``agg_layout`` resolves."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ecm_tpu.models.grouped_layers as gl
from ecm_tpu.models import build_model as jax_build_model
from ecm_tpu.ops.grouped3d import from_grouped, to_grouped
from ecm_tpu.ops.pallas_cost_volume import cost_volume_concat_grouped_pallas
from ecm_tpu.ops.pallas_gband import gband_conv_bn_s1, gband_down_conv_bn
from ecm_tpu.ops.pallas_gdeconv import gdeconv4_bn
from ecm_torch.configs import CONFIGS
from ecm_torch.configs.base import SLICE2_OVERRIDES
from ecm_torch.models import build_model
from ecm_torch.ops.cuda_cost_volume import cost_volume_concat_torch
from ecm_torch.ops.cuda_gband import conv3d_bn_down, conv3d_bn_s1, conv3d_bn_torch
from ecm_torch.ops.cuda_gdeconv import deconv3d_bn, deconv3d_bn_torch
from ecm_torch.weights import load_flax
from test_torch_port_util import assert_close_rel, flax_variables, t, to_torch_kernel

PLAIN = dict(agg_layout="standard", agg_fused="off", use_pallas=False, regress_mode="fullres")


def _bn(rng, c):
    return rng.uniform(0.5, 1.5, c).astype(np.float32), rng.normal(size=c).astype(np.float32)


def _deconv_kernel(k: np.ndarray) -> torch.Tensor:
    """flax transposed-conv kernel [3,3,3,I,O] -> torch ConvTranspose3d
    [I, O, 3, 3, 3] with every spatial dim flipped (the weight bridge's rule)."""
    return t(np.flip(np.transpose(k, (3, 4, 0, 1, 2)), axis=(2, 3, 4)))


@pytest.mark.parametrize("add", [None, "ctx", "residual"])
@pytest.mark.parametrize("relu", [True, False])
def test_conv3d_bn_s1_matches_gband(relu, add):
    """``gband_conv_bn_s1`` (g=4, its rolling-DMA form at W=8) through
    from_grouped, Cin != Cout, with each post-activation add."""
    rng = np.random.default_rng(0)
    b, d, h, w, cin, cout = 1, 8, 5, 8, 6, 4
    x = rng.normal(size=(b, d, h, w, cin)).astype(np.float32)
    k = rng.normal(size=(3, 3, 3, cin, cout)).astype(np.float32) * 0.2
    scale, bias = _bn(rng, cout)
    a, a_g = None, None
    if add == "ctx":
        a = rng.normal(size=(b, 1, h, w, cout)).astype(np.float32)
        a_g = jnp.tile(jnp.asarray(a), (1, 1, 1, 1, 4))
    elif add == "residual":
        a = rng.normal(size=(b, d, h, w, cout)).astype(np.float32)
        a_g = to_grouped(jnp.asarray(a))
    ref = gband_conv_bn_s1(
        to_grouped(jnp.asarray(x)), jnp.asarray(k), jnp.asarray(scale), jnp.asarray(bias),
        relu=relu, add=a_g,
    )
    out = conv3d_bn_s1(t(x), to_torch_kernel(k), t(scale), t(bias), None if a is None else t(a), relu=relu)
    np.testing.assert_allclose(out.numpy(), np.asarray(from_grouped(ref)), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("relu", [True, False])
def test_conv3d_bn_down_matches_gband(relu):
    """``gband_down_conv_bn`` (g=4 in, g=2 out) through from_grouped(., 2)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 8, 6, 8, 6)).astype(np.float32)
    k = rng.normal(size=(3, 3, 3, 6, 5)).astype(np.float32) * 0.2
    scale, bias = _bn(rng, 5)
    ref = gband_down_conv_bn(
        to_grouped(jnp.asarray(x)), jnp.asarray(k), jnp.asarray(scale), jnp.asarray(bias), relu=relu
    )
    out = conv3d_bn_down(t(x), to_torch_kernel(k), t(scale), t(bias), relu=relu)
    assert out.shape == (1, 4, 3, 4, 5)
    np.testing.assert_allclose(out.numpy(), np.asarray(from_grouped(ref, 2)), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("with_add", [False, True])
def test_deconv3d_bn_matches_gdeconv(with_add):
    """``gdeconv4_bn`` (ungrouped in, g=4 out) through from_grouped; the
    port reads torch's flipped ConvTranspose3d weight with torch's index
    rule, so a wrong flip fails here."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 4, 3, 5, 6)).astype(np.float32)
    k = rng.normal(size=(3, 3, 3, 6, 4)).astype(np.float32) * 0.2
    scale, bias = _bn(rng, 4)
    a = rng.normal(size=(1, 8, 6, 10, 4)).astype(np.float32) if with_add else None
    ref = gdeconv4_bn(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(scale), jnp.asarray(bias),
        add=None if a is None else to_grouped(jnp.asarray(a)),
    )
    out = deconv3d_bn(t(x), _deconv_kernel(k), t(scale), t(bias), None if a is None else t(a))
    assert out.shape == (1, 8, 6, 10, 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(from_grouped(ref)), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("max_disp", [4, 12])
def test_cost_volume_concat_is_the_grouped_kernels_function(max_disp):
    """Kernel 3 (``cost_volume_concat_grouped_pallas``) is kernel 1's concat
    volume in the disparity-folded layout: bit-identical through from_grouped."""
    rng = np.random.default_rng(3)
    fl, fr = (rng.normal(size=(2, 3, 10, 4)).astype(np.float32) for _ in range(2))
    ref = cost_volume_concat_grouped_pallas(jnp.asarray(fl), jnp.asarray(fr), max_disp)
    out = cost_volume_concat_torch(t(fl), t(fr), max_disp)
    assert torch.equal(out, torch.from_numpy(np.array(from_grouped(ref))))


GROUPED = dict(max_disp=64, feature_channels=8)


@pytest.fixture(scope="module")
def grouped_run():
    """One JAX forward of the grouped ECMStereo at 32x64 (W/4 = 16 takes the
    padded-flow branch of the dres chain), its gband kernels forced on."""
    rng = np.random.default_rng(4)
    images = [rng.normal(size=(1, 32, 64, 3)).astype(np.float32) for _ in range(2)]
    variables = flax_variables(
        jax_build_model("stackhourglass", remat=False, **PLAIN, **GROUPED), *map(jnp.asarray, images)
    )
    jm = jax_build_model("stackhourglass", remat=False, **SLICE2_OVERRIDES, **GROUPED)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gl, "_GBAND_DEFAULT", "on")
        (disp,), state = jm.apply(
            variables, *map(jnp.asarray, images), train=False,
            capture_intermediates=True, mutable=["intermediates"],
        )
    (cost,) = state["intermediates"]["aggregation"]["__call__"][0]
    return images, variables, np.asarray(cost), np.asarray(disp)


def test_grouped_path_matches_jax(grouped_run):
    """The port's grouped path on the CPU (every wrapper's plain version)
    against the JAX grouped path with its Pallas kernels: cost map at rel
    1e-4, disparity at 1e-3 px."""
    images, variables, j_cost, j_disp = grouped_run
    tm = CONFIGS["kitti_infer"].model.build(device="cpu", **SLICE2_OVERRIDES, **GROUPED, dtype=torch.float32)
    load_flax(tm, jax.tree.map(np.asarray, variables))
    with torch.inference_mode():
        (cost,) = tm.cost_maps(*map(t, images))
        (disp,) = tm(*map(t, images))
    assert cost.shape == (1, 16, 8, 16) and disp.shape == (1, 32, 64)
    assert_close_rel(cost.numpy(), j_cost, 1e-4)
    np.testing.assert_allclose(disp.numpy(), j_disp, rtol=0, atol=1e-3)


def test_grouped_path_equals_standard_path(grouped_run):
    """The layer kernels compute the standard chain's function: the same
    weights through both layouts agree on the CPU."""
    images, variables, _, _ = grouped_run
    costs = {}
    for layout in ("grouped", "standard"):
        tm = build_model(device="cpu", agg_layout=layout, **GROUPED)
        load_flax(tm, jax.tree.map(np.asarray, variables))
        with torch.inference_mode():
            (costs[layout],) = tm.cost_maps(*map(t, images))
    assert_close_rel(costs["grouped"].numpy(), costs["standard"].numpy(), 1e-4)


@pytest.mark.parametrize(
    "overrides", [dict(use_pallas=True, regress_mode="fused"), dict(use_pallas=False, regress_mode="fullres")],
    ids=["kernels", "plain"],
)
def test_ecm_basic_matches_jax(overrides):
    """``ECMBasic`` at max_disp 16, width 8, f32: cost map at rel 1e-4,
    disparity at 1e-3 px; the weight bridge loads its flax tree strictly."""
    rng = np.random.default_rng(5)
    images = [rng.normal(size=(1, 32, 48, 3)).astype(np.float32) for _ in range(2)]
    small = dict(max_disp=16, feature_channels=8)
    jm = jax_build_model("basic", remat=False, **overrides, **small)
    variables = flax_variables(jm, *map(jnp.asarray, images))
    (j_disp,), state = jm.apply(
        variables, *map(jnp.asarray, images), train=False,
        capture_intermediates=True, mutable=["intermediates"],
    )
    (j_cost,) = state["intermediates"]["classif"]["__call__"]
    tm = build_model("basic", device="cpu", **overrides, **small)
    load_flax(tm, jax.tree.map(np.asarray, variables))
    with torch.inference_mode():
        (cost,) = tm.cost_maps(*map(t, images))
        (disp,) = tm(*map(t, images))
    assert cost.shape == (1, 4, 8, 12) and disp.shape == (1, 32, 48)
    assert_close_rel(cost.numpy(), np.asarray(j_cost)[..., 0], 1e-4)
    np.testing.assert_allclose(disp.numpy(), np.asarray(j_disp), rtol=0, atol=1e-3)


def test_agg_layout_resolution():
    """"auto" is "standard" on the CPU and "grouped" on CUDA when
    max_disp/4 % 16 == 0; "grouped" with another max_disp raises."""
    m = CONFIGS["kitti_infer"].model.build(device="cpu", max_disp=64, feature_channels=8)
    assert m.agg_layout == "auto"
    assert m.resolve_layout(torch.device("cpu")) == "standard"
    assert m.resolve_layout(torch.device("cuda")) == "grouped"
    assert build_model(device="cpu", max_disp=16, feature_channels=8).resolve_layout(torch.device("cuda")) == "standard"
    assert CONFIGS["overfit_gate_grouped"].model.build(device="cpu").resolve_layout(torch.device("cpu")) == "grouped"
    with pytest.raises(ValueError, match="max_disp/4 % 16"):
        build_model(device="cpu", max_disp=16, feature_channels=8, agg_layout="grouped")
    with pytest.raises(ValueError, match="agg_layout"):
        build_model(device="cpu", max_disp=64, feature_channels=8, agg_layout="folded")


def test_new_wrappers_on_cpu_take_the_plain_version():
    """A CPU tensor gets the plain result and no launch is counted."""
    rng = np.random.default_rng(6)
    before = (conv3d_bn_s1.launches, conv3d_bn_down.launches, deconv3d_bn.launches)
    x = t(rng.normal(size=(1, 4, 4, 6, 3)))
    w, s, b = t(rng.normal(size=(2, 3, 3, 3, 3))), torch.ones(2), torch.zeros(2)
    res = t(rng.normal(size=(1, 4, 4, 6, 2)))
    assert torch.equal(conv3d_bn_s1(x, w, s, b, res, relu=False), conv3d_bn_torch(x, w, s, b, res, relu=False))
    assert torch.equal(conv3d_bn_down(x, w, s, b), conv3d_bn_torch(x, w, s, b, stride=2))
    wt = t(rng.normal(size=(3, 2, 3, 3, 3)))
    assert torch.equal(deconv3d_bn(x, wt, s, b), deconv3d_bn_torch(x, wt, s, b))
    after = (conv3d_bn_s1.launches, conv3d_bn_down.launches, deconv3d_bn.launches)
    assert after == before == (0, 0, 0)


def test_new_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(1, 4, 4, 6, 3)
    w, s, b = torch.zeros(2, 3, 3, 3, 3), torch.ones(2), torch.zeros(2)
    with pytest.raises(ValueError, match="weight"):
        conv3d_bn_s1(x, torch.zeros(2, 4, 3, 3, 3), s, b)
    with pytest.raises(ValueError, match="scale/bias"):
        conv3d_bn_down(x, w, torch.ones(3), b)
    with pytest.raises(ValueError, match="add"):
        conv3d_bn_s1(x, w, s, b, torch.zeros(1, 2, 4, 6, 2))
    with pytest.raises(ValueError, match="add"):
        conv3d_bn_s1(x, w, s, b, torch.zeros(1, 4, 4, 6, 2, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="x must be"):
        conv3d_bn_s1(torch.zeros(4, 4, 6, 3), w, s, b)
    with pytest.raises(ValueError, match="weight"):
        deconv3d_bn(x, torch.zeros(2, 3, 3, 3, 3), s, b)
    with pytest.raises(ValueError, match="add"):
        deconv3d_bn(x, torch.zeros(3, 2, 3, 3, 3), s, b, torch.zeros(1, 8, 8, 12, 3))
