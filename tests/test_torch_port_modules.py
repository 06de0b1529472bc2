"""The port's model modules against the JAX package's flax modules, with the
JAX variables carried over through ``ecm_torch.weights``: same numpy inputs,
f32, rtol/atol 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecm_tpu.models import aggregation as jagg
from ecm_tpu.models import context as jctx
from ecm_tpu.models import features as jfeat
from ecm_tpu.models import layers as jlayers
from ecm_tpu.ops import softargmin as jsoft
from ecm_tpu.ops import upsample as jup
from ecm_torch.models import aggregation, context, features, layers
from ecm_torch.ops import softargmin, upsample
from ecm_torch.weights import load_flax
from test_torch_port_util import flax_variables, t


def _run(jmod, tmod, *inputs, seed=0, **kw):
    """Apply the flax module (eval) and the port module with the same
    variables and inputs; return both outputs as numpy."""
    variables = flax_variables(jmod, *map(jnp.asarray, inputs), seed=seed, **kw)
    ref = jmod.apply(variables, *map(jnp.asarray, inputs), train=False, **kw)
    load_flax(tmod, variables).eval()
    with torch.inference_mode():
        out = tmod(*map(t, inputs))
    return out, ref


def _close(out, ref):
    if isinstance(out, (list, tuple)):
        assert len(out) == len(ref)
        for o, r in zip(out, ref):
            _close(o, r)
        return
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize(
    "ndim,stride,dilation,kernel", [(2, 1, 1, 3), (2, 2, 1, 3), (2, 1, 2, 3), (2, 1, 1, 1), (3, 1, 1, 3), (3, 2, 1, 3)]
)
def test_convbn(ndim, stride, dilation, kernel):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1,) + (6,) * (ndim - 1) + (10, 5)).astype(np.float32)
    jm = jlayers.ConvBN(7, kernel_size=kernel, strides=stride, dilation=dilation)
    tm = layers.ConvBN(5, 7, kernel, stride=stride, dilation=dilation, ndim=ndim)
    _close(*_run(jm, tm, x))


def test_conv_transpose_bn_flips_the_kernel():
    """Deconv3DOpt's [3,3,3,I,O] kernel -> ConvTranspose3d [I,O,3,3,3] with
    every spatial dim flipped; the output doubles each dim."""
    x = np.random.default_rng(1).normal(size=(1, 3, 4, 5, 6)).astype(np.float32)
    out, ref = _run(jlayers.ConvTransposeBN(4), layers.ConvTransposeBN(6, 4), x)
    assert out.shape == (1, 6, 8, 10, 4)
    _close(out, ref)


@pytest.mark.parametrize("cin,cout,stride,dilation", [(8, 8, 1, 2), (6, 8, 2, 1)])
def test_basic_block(cin, cout, stride, dilation):
    x = np.random.default_rng(2).normal(size=(1, 8, 12, cin)).astype(np.float32)
    jm = jlayers.BasicBlock(cout, strides=stride, dilation=dilation)
    _close(*_run(jm, layers.BasicBlock(cin, cout, stride, dilation), x))


def test_feature_extraction():
    x = np.random.default_rng(3).normal(size=(1, 32, 48, 3)).astype(np.float32)
    out, ref = _run(jfeat.FeatureExtraction(8), features.FeatureExtraction(8), x)
    assert out.shape == (1, 8, 12, 8)
    _close(out, ref)


@pytest.mark.parametrize("fusion", ["add", "film", "both", "none"])
def test_context_mapping(fusion):
    rng = np.random.default_rng(4)
    ctx2d = rng.normal(size=(2, 4, 6, 5)).astype(np.float32)
    vol = rng.normal(size=(2, 3, 4, 6, 7)).astype(np.float32)
    jm = jctx.ContextMapping(7, fusion=fusion)
    tm = context.ContextMapping(5, 7, fusion=fusion)
    if fusion == "none":
        out = tm(t(ctx2d), t(vol))
        assert torch.equal(out, t(vol))
        return
    _close(*_run(jm, tm, ctx2d, vol))


def test_context_return_map():
    ctx2d = np.random.default_rng(5).normal(size=(1, 4, 6, 5)).astype(np.float32)
    jm = jctx.ContextMapping(7, return_map=True)
    variables = flax_variables(jm, jnp.asarray(ctx2d), None)
    ref = jm.apply(variables, jnp.asarray(ctx2d), None, train=False)
    tm = load_flax(context.ContextMapping(5, 7), variables).eval()
    with torch.inference_mode():
        _close(tm(t(ctx2d), return_map=True), ref)


@pytest.mark.parametrize("fused", ["off", "on"])
def test_aggregation(fused):
    """Standard layout, eval: the plain chain and the fused pairs (the JAX
    side runs its Pallas pair kernel in interpret mode)."""
    rng = np.random.default_rng(6)
    c = 4
    vol = rng.normal(size=(1, 4, 8, 12, 2 * c)).astype(np.float32)
    ctx2d = rng.normal(size=(1, 8, 12, c)).astype(np.float32)
    jm = jagg.ECMAggregation(channels=c, remat=False, fused=fused)
    variables = flax_variables(jm, jnp.asarray(vol), jnp.asarray(ctx2d))
    ref = jm.apply(variables, jnp.asarray(vol), jnp.asarray(ctx2d), train=False)
    tm = load_flax(aggregation.ECMAggregation(channels=c, fused=fused), variables).eval()
    with torch.inference_mode():
        out = tm(t(vol), t(ctx2d))
    assert len(out) == 1 and out[0].shape == (1, 4, 8, 12)
    _close(out, ref)


def test_upsample_and_softargmin():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    _close(upsample.upsample_trilinear(t(x), (12, 16, 20)), jup.upsample_trilinear(jnp.asarray(x), (12, 16, 20)))
    f = rng.normal(size=(1, 3, 5, 2)).astype(np.float32)
    _close(upsample.upsample_bilinear(t(f), (12, 15)), jup.upsample_bilinear(jnp.asarray(f), (12, 15)))
    cost = rng.normal(size=(2, 12, 4, 5)).astype(np.float32)
    _close(softargmin.disparity_regression(t(cost), 12), jsoft.disparity_regression(jnp.asarray(cost), 12))
