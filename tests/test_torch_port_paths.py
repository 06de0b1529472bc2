"""``ECMStereo`` options beyond the preset, each against the JAX model at
32x64, max_disp 64, feature_channels 8 (f32, same variables and inputs):
``context_stages``, ``num_hourglass``, the ``film``/``both`` context
fusions and the correlation volume, each through the port's plain, grouped
and fused eval paths (every wrapper's plain version on the CPU), and
``regress_mode="lowres"`` with each of them. The JAX reference runs its
plain standard path: its layouts share one parameter tree and compute one
function.

The ``film`` and ``both`` cases run from ``test_torch_port_paths_fusion.py``
through this file's ``check_option`` and ``check_lowres``: the module-scoped
JAX models of the five cases then compile in two test processes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecm_tpu.models import build_model as jax_build_model
from ecm_tpu.models.ecm import regress_disparity as jax_regress_disparity
from ecm_torch.configs import CONFIGS
from ecm_torch.configs.base import SLICE2_OVERRIDES, SLICE_OVERRIDES
from ecm_torch.weights import load_flax
from test_torch_port_util import assert_close_rel, flax_variables, t, torch_threads

SMALL = dict(max_disp=64, feature_channels=8)
PLAIN = dict(agg_layout="standard", agg_fused="off", use_pallas=False, regress_mode="fullres")
CASES = {
    "context_stages_0_2": dict(context_stages=(0, 2)),
    "num_hourglass_2": dict(num_hourglass=2),
    "correlation": dict(cost_mode="correlation"),
}
PATHS = {"plain": PLAIN, "grouped": SLICE2_OVERRIDES, "fused": SLICE_OVERRIDES}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(11)
    return [rng.normal(size=(1, 32, 64, 3)).astype(np.float32) for _ in range(2)]


def jax_run(images, **kw):
    """Variables, cost map and disparity of one JAX eval forward."""
    jm = jax_build_model("stackhourglass", remat=False, **SMALL, **kw)
    variables = flax_variables(jm, *map(jnp.asarray, images))
    (disp,), state = jm.apply(
        variables, *map(jnp.asarray, images), train=False,
        capture_intermediates=True, mutable=["intermediates"],
    )
    (cost,) = state["intermediates"]["aggregation"]["__call__"][0]
    return jax.tree.map(np.asarray, variables), np.asarray(cost), np.asarray(disp)


@pytest.fixture(scope="module", params=list(CASES))
def jax_case(request, images):
    return request.param, jax_run(images, **PLAIN, **CASES[request.param])


def port_model(variables, **kw):
    """The port's model through ``ModelConfig.build`` (which forwards the
    overrides), loaded strictly from the flax tree."""
    tm = CONFIGS["kitti_infer"].model.build(device="cpu", **SMALL, **kw, dtype=torch.float32)
    return load_flax(tm, variables)


def check_option(option: dict, images, jax_result, path: str) -> None:
    """Cost map at rel 1e-4, disparity at 1e-3 px, as the preset's paths
    (``test_torch_port_model.py``, ``test_torch_port_grouped.py``)."""
    variables, j_cost, j_disp = jax_result
    tm = port_model(variables, **PATHS[path], **option)
    agg = tm.aggregation
    assert (agg.context_stages, agg.num_hourglass, agg.context_fusion) == (
        tuple(option.get("context_stages", (0, 1, 2, 3))),
        option.get("num_hourglass", 3),
        option.get("context_fusion", "add"),
    )
    with torch.inference_mode():
        (cost,) = tm.cost_maps(*map(t, images))
        (disp,) = tm(*map(t, images))
    assert cost.shape == (1, 16, 8, 16) and disp.shape == (1, 32, 64)
    assert_close_rel(cost.numpy(), j_cost, 1e-4)
    np.testing.assert_allclose(disp.numpy(), j_disp, rtol=0, atol=1e-3)


def check_lowres(option: dict, images, jax_result) -> None:
    """``regress_mode="lowres"`` at model level (D-only upsample, soft-argmin
    at 1/4 resolution, bilinear upsample of the disparity) against JAX's
    ``regress_disparity`` on JAX's cost map, as its ``ECMStereo`` applies
    it: 1e-3 px."""
    variables, j_cost, _ = jax_result
    j_disp = np.asarray(jax_regress_disparity(jnp.asarray(j_cost), SMALL["max_disp"], 32, 64, "lowres", False))
    tm = port_model(variables, **{**PLAIN, "regress_mode": "lowres"}, **option)
    with torch.inference_mode():
        (disp,) = tm(*map(t, images))
    assert disp.shape == (1, 32, 64)
    np.testing.assert_allclose(disp.numpy(), j_disp, rtol=0, atol=1e-3)


@pytest.mark.parametrize("path", list(PATHS))
def test_option_matches_jax_on_each_eval_path(images, jax_case, path):
    case, result = jax_case
    check_option(CASES[case], images, result, path)


def test_lowres_regression_matches_jax(images, jax_case):
    case, result = jax_case
    check_lowres(CASES[case], images, result)
