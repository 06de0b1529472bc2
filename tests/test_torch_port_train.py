"""The port's training slice against ``ecm_tpu.train`` on the CPU, f32, same
numpy inputs and variables: one whole train step (loss, predictions, every
parameter gradient and the new BatchNorm statistics) of ``ECMStereo``
grouped and standard, of ``ECMStereo`` on the correlation volume and of
``ECMBasic``, and the presets' ``remat``. The f64 step, ``remat``, the
trainer, data, loss and optimizer are in ``test_torch_port_train_loop.py``
(split so that no file of the suite is its long pole).

The whole-step cases run one 32x32 pair, with the BatchNorm shifts drawn in
[1, 2]. At a size the CPU can afford, each 2D feature channel holds a few
hundred values, so one activation that the two packages' f32 rounding puts
on different sides of a ReLU moves a weight gradient by up to a few per
cent (seen at 32x64 with shifts around 0). Positive shifts keep the
activations away from the kink. At 32x32 every SPP branch pools to one value
per channel, where both packages give the exact result (flax's
``E[x^2] - E[x]^2`` variance in f32 is ill-conditioned at 2 values)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ecm_tpu.models.grouped_layers as gl
from ecm_tpu.data.synthetic import make_batch
from ecm_tpu.models import build_model as jax_build_model
from ecm_torch.configs import CONFIGS
from ecm_torch.models import build_model
from ecm_torch.ops.cuda_fused_agg import fused_conv3d_pair
from ecm_torch.ops.cuda_gband import conv3d_bn_down, conv3d_bn_s1, gband_conv_s1
from ecm_torch.ops.cuda_gdeconv import deconv3d_bn
from ecm_torch.weights import from_flax, load_flax
from test_torch_port_util import (
    assert_grads_match,
    assert_stats_match,
    flax_variables,
    jax_train_grads,
    torch_threads,
    torch_train_grads,
)

PLAIN = dict(use_pallas=False, regress_mode="fullres")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six loaded test processes share the cores (``torch_threads``)."""
    with torch_threads(1):
        yield


# name, model kwargs (both packages), port-only kwargs, crop max disparity
MODELS = {
    # grouped at width 32: JAX's GConv3D takes gband_conv_s1 (4 * 32 lanes)
    "grouped": ("stackhourglass", dict(max_disp=64, feature_channels=32, agg_layout="grouped", remat=False), 40.0),
    "standard": ("stackhourglass", dict(max_disp=16, feature_channels=8, agg_layout="standard", remat=False), 12.0),
    "basic": ("basic", dict(max_disp=16, feature_channels=8), 12.0),
    # the correlation volume: its closed-form VJP feeds the feature net
    "correlation": (
        "stackhourglass",
        dict(max_disp=16, feature_channels=8, agg_layout="standard", remat=False, cost_mode="correlation"),
        12.0,
    ),
}


@pytest.fixture(scope="module", params=list(MODELS))
def train_step_pair(request):
    """One training forward + backward of the same variables and batch
    through both packages (JAX's gband_conv_s1 forced on, interpret mode)."""
    name, kw, gt_max = MODELS[request.param]
    batch = make_batch(7, 1, h=32, w=32, max_disp=gt_max)
    jm = jax_build_model(name, **PLAIN, **kw)
    variables = flax_variables(jm, jnp.asarray(batch["left"]), jnp.asarray(batch["right"]), bn_bias=(1.0, 2.0))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gl, "_GBAND_TRAIN_DEFAULT", "on")
        ref = jax_train_grads(jm, variables, batch, kw["max_disp"])
    tm = build_model(name, device="cpu", **PLAIN, **kw)
    load_flax(tm, jax.tree.map(np.asarray, variables))
    counters = (gband_conv_s1, conv3d_bn_s1, conv3d_bn_down, deconv3d_bn, fused_conv3d_pair)
    before = [f.launches for f in counters]
    out = torch_train_grads(tm, batch, kw["max_disp"])
    assert [f.launches for f in counters] == before  # CPU tensors launch nothing
    return request.param, ref, out, tm


def test_train_step_loss_and_predictions_match_jax(train_step_pair):
    """Loss at rel 1e-5; each stage's disparity at 1e-3 px (3 for
    ECMStereo, 1 for ECMBasic)."""
    name, (j_loss, j_preds, _, _), (loss, preds, _, _), _ = train_step_pair
    assert len(preds) == len(j_preds) == (1 if name == "basic" else 3)
    assert abs(loss - j_loss) <= 1e-5 * abs(j_loss), (loss, j_loss)
    for p, jp in zip(preds, j_preds):
        assert p.shape == (1, 32, 32)
        np.testing.assert_allclose(p, jp, rtol=0, atol=1e-3)


def test_train_step_gradients_match_jax(train_step_pair):
    """Every parameter gradient at max|diff|/max|ref| <= 1e-3 per tensor
    (the JAX gradient tree mapped through the weight bridge)."""
    _, (_, _, j_grads, j_stats), (_, _, grads, sd), _ = train_step_pair
    assert_grads_match(grads, from_flax({"params": j_grads, "batch_stats": j_stats}, sd), 1e-3)


def test_train_step_batch_stats_match_jax(train_step_pair):
    """The running statistics after the step at rel 1e-5: flax folds in
    the biased batch variance, once per BatchNorm call."""
    _, (_, _, j_grads, j_stats), (_, _, _, sd), _ = train_step_pair
    assert_stats_match(sd, from_flax({"params": j_grads, "batch_stats": j_stats}, sd), 1e-5)


def test_built_models_carry_the_preset_remat():
    """``ModelConfig.build`` passes ``remat`` to ``ECMStereo`` as ecm_tpu's
    does; ``ECMBasic`` keeps its default, True."""
    single = CONFIGS["sceneflow_single"].model.build(device="cpu", max_disp=16, feature_channels=8)
    assert single.remat is False and single.aggregation.remat is False
    infer = CONFIGS["kitti_infer"].model.build(device="cpu", max_disp=16, feature_channels=8)
    assert infer.remat is True and infer.aggregation.remat is True
    cfg = dataclasses.replace(CONFIGS["sceneflow_single"].model, name="basic")
    assert cfg.remat is False
    assert cfg.build(device="cpu", max_disp=16, feature_channels=8).remat is True
