"""The slice as a whole: ``ECMStereo`` eval forward of the port against the
JAX model at 32x48, max_disp 16, feature_channels 8 (f32, same variables and
inputs), and the weight bridge's strictness."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecm_tpu.models import build_model as jax_build_model
from ecm_torch.configs import CONFIGS
from ecm_torch.configs.base import SLICE_OVERRIDES
from ecm_torch.models import build_model
from ecm_torch.weights import from_flax, load_flax
from test_torch_port_util import assert_close_rel, flax_variables, t

SMALL = dict(max_disp=16, feature_channels=8)
PLAIN = dict(agg_layout="standard", agg_fused="off", use_pallas=False, regress_mode="fullres")


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return [rng.normal(size=(1, 32, 48, 3)).astype(np.float32) for _ in range(2)]


@pytest.fixture(scope="module")
def jax_variables(images):
    m = jax_build_model("stackhourglass", remat=False, **PLAIN, **SMALL)
    return flax_variables(m, *map(jnp.asarray, images))


@pytest.mark.parametrize("overrides", [SLICE_OVERRIDES, PLAIN], ids=["slice", "plain"])
def test_ecm_stereo_matches_jax(images, jax_variables, overrides):
    """Pre-soft-argmin cost map at rel 1e-4, disparity at 1e-3 px."""
    jm = jax_build_model("stackhourglass", remat=False, **overrides, **SMALL)
    (j_disp,), state = jm.apply(
        jax_variables, *map(jnp.asarray, images), train=False,
        capture_intermediates=True, mutable=["intermediates"],
    )
    (j_cost,) = state["intermediates"]["aggregation"]["__call__"][0]
    tm = CONFIGS["kitti_infer"].model.build(device="cpu", **overrides, **SMALL, dtype=torch.float32)
    load_flax(tm, jax.tree.map(np.asarray, jax_variables))
    with torch.inference_mode():
        (cost,) = tm.cost_maps(*map(t, images))
        (disp,) = tm(*map(t, images))
    assert cost.shape == (1, 4, 8, 12) and disp.shape == (1, 32, 48)
    assert_close_rel(cost.numpy(), j_cost, 1e-4)
    np.testing.assert_allclose(disp.numpy(), np.asarray(j_disp), rtol=0, atol=1e-3)


def test_weights_round_trip(jax_variables):
    """from_flax -> load_state_dict(strict=True) -> the same numbers back."""
    tm = build_model(device="cpu", **SMALL)
    load_flax(tm, jax_variables)
    sd = tm.state_dict()
    p = jax_variables["params"]["aggregation"]
    s = jax_variables["batch_stats"]["aggregation"]
    np.testing.assert_array_equal(
        sd["aggregation.dres0_1.conv.weight"].numpy(),
        np.transpose(np.asarray(p["dres0_1"]["conv"]["kernel"]), (4, 3, 0, 1, 2)),
    )
    np.testing.assert_array_equal(
        sd["aggregation.hourglass1.conv6.bn.running_var"].numpy(),
        np.asarray(s["hourglass1"]["conv6"]["bn"]["var"]),
    )
    np.testing.assert_array_equal(
        sd["aggregation.context0.map_proj.bias"].numpy(),
        np.asarray(p["context0"]["map_proj"]["bias"]),
    )


def test_weights_strict(jax_variables):
    tm = build_model(device="cpu", **SMALL)
    expected = tm.state_dict()
    params = jax.tree.map(np.asarray, jax_variables["params"])
    missing = {**params, "aggregation": {k: v for k, v in params["aggregation"].items() if k != "classif1"}}
    with pytest.raises(KeyError, match="classif1"):
        from_flax({"params": missing, "batch_stats": jax_variables["batch_stats"]}, expected)
    extra = {**params, "extra": {"kernel": np.zeros((3, 3, 1, 1), np.float32)}}
    with pytest.raises(KeyError, match="extra"):
        from_flax({"params": extra, "batch_stats": jax_variables["batch_stats"]}, expected)
    wide = build_model(device="cpu", max_disp=16, feature_channels=16).state_dict()
    with pytest.raises(ValueError, match="shape mismatch"):
        from_flax(jax_variables, wide)
