"""Reference-style torch checkpoints into the port
(``ecm_torch.checkpoint_import``) against ``ecm_tpu.checkpoint_import``.

One checkpoint, fabricated as ``tests/test_checkpoint_import.py::
test_roundtrip_small_model`` fabricates one (torch layouts, a layer per
flax conv and BatchNorm in ``ecm_tpu``'s order, reference-style names) and
saved as a ``.tar`` with ``nn.DataParallel``'s ``module.`` prefixes, goes
through both importers. The port's import equals the weight bridge's
conversion of the JAX import exactly, and the two models give the same
disparities at the tolerance of ``test_torch_port_model.py`` (f32, 32x48,
max_disp 16, feature_channels 8: the cost map at rel 1e-4, the disparity at
1e-3 px)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecm_tpu import checkpoint_import as jax_import
from ecm_tpu.models import build_model as jax_build_model
from ecm_torch.checkpoint_import import import_by_structure, load_torch_checkpoint
from ecm_torch.configs import CONFIGS
from ecm_torch.weights import from_flax
from test_torch_port_util import assert_close_rel, flax_variables, t, torch_threads

SMALL = dict(max_disp=16, feature_channels=8)
PLAIN = dict(agg_layout="standard", agg_fused="off", use_pallas=False, regress_mode="fullres")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return [rng.normal(size=(1, 32, 48, 3)).astype(np.float32) for _ in range(2)]


@pytest.fixture(scope="module")
def jax_model_and_template(images):
    m = jax_build_model("stackhourglass", remat=False, **PLAIN, **SMALL)
    return m, flax_variables(m, *map(jnp.asarray, images))


def reference_state_dict(template: dict, seed: int = 1) -> dict[str, np.ndarray]:
    """A reference-style state_dict for the flax tree ``template``: for the
    i-th conv (``ecm_tpu``'s order) ``block{i}.0.weight`` in torch's layout
    (and ``.bias``), for the i-th BatchNorm ``block{i}.1.*`` with its running
    statistics, random values from ``seed``."""
    rng = np.random.default_rng(seed)
    params, stats = template["params"], template["batch_stats"]
    sd = {}
    convs = [p for p, _ in jax_import._flatten_with_path(params) if p[-1] == "kernel"]
    for i, path in enumerate(convs):
        node = _get(params, path[:-1])
        shape = node["kernel"].shape
        nd = len(shape) - 2
        std = 1.0 / math.sqrt(math.prod(shape[:-1]))
        order = (nd, nd + 1, *range(nd)) if "deconv" in path else (nd + 1, nd, *range(nd))
        sd[f"block{i}.0.weight"] = rng.normal(0, std, [shape[j] for j in order]).astype(np.float32)
        if "bias" in node:
            sd[f"block{i}.0.bias"] = rng.normal(0, 0.1, node["bias"].shape).astype(np.float32)
    bns = sorted({p[:-1] for p, _ in jax_import._flatten_with_path(params) if p[-2:] == ("bn", "scale")},
                 key=lambda p: [jax_import._natkey(x) for x in p])
    for i, path in enumerate(bns):
        c = np.shape(_get(stats, path)["mean"])
        sd[f"block{i}.1.weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f"block{i}.1.bias"] = rng.normal(0, 0.1, c).astype(np.float32)
        sd[f"block{i}.1.running_mean"] = rng.normal(0, 0.3, c).astype(np.float32)
        sd[f"block{i}.1.running_var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        sd[f"block{i}.1.num_batches_tracked"] = np.int64(7)
    return sd


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def save_tar(path, sd: dict[str, np.ndarray]) -> str:
    torch.save({"epoch": 10, "state_dict": {f"module.{k}": torch.as_tensor(v) for k, v in sd.items()}}, path)
    return str(path)


def port_model():
    return CONFIGS["kitti_infer"].model.build(device="cpu", **PLAIN, **SMALL, dtype=torch.float32)


def test_reference_checkpoint_gives_jax_disparities(tmp_path, images, jax_model_and_template):
    jm, template = jax_model_and_template
    path = save_tar(tmp_path / "checkpoint_10.tar", reference_state_dict(template))

    jvars = jax_import.import_by_structure(jax_import.load_torch_checkpoint(path), template)
    (j_disp,), state = jm.apply(
        jvars, *map(jnp.asarray, images), train=False, capture_intermediates=True, mutable=["intermediates"]
    )
    (j_cost,) = state["intermediates"]["aggregation"]["__call__"][0]

    tm = port_model()
    sd = load_torch_checkpoint(path)
    assert not any(k.startswith("module.") for k in sd)
    imported = import_by_structure(sd, tm.state_dict())
    bridged = from_flax(jax.tree.map(np.asarray, jvars), tm.state_dict())
    for k, v in bridged.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(imported[k], v), k
    tm.load_state_dict(imported)
    with torch.inference_mode():
        (cost,) = tm.cost_maps(*map(t, images))
        (disp,) = tm(*map(t, images))
    assert_close_rel(cost.numpy(), j_cost, 1e-4)
    np.testing.assert_allclose(disp.numpy(), np.asarray(j_disp), rtol=0, atol=1e-3)


def test_mismatches_raise(tmp_path, jax_model_and_template):
    _, template = jax_model_and_template
    sd = reference_state_dict(template)
    expected = port_model().state_dict()
    bad = dict(sd, **{"block3.0.weight": sd["block3.0.weight"][:, :-1]})
    with pytest.raises(ValueError, match=r"at aggregation\.classif2\.conv2\.weight <- checkpoint block3\.0\.weight"):
        import_by_structure(load_torch_checkpoint(save_tar(tmp_path / "bad.tar", bad)), expected)
    with pytest.raises(ValueError, match="shape mismatch"):
        jax_import.import_by_structure(jax_import.load_torch_checkpoint(str(tmp_path / "bad.tar")), template)
    short = {k: v for k, v in sd.items() if not k.startswith("block0.1.")}
    with pytest.raises(ValueError, match="layer-count mismatch"):
        import_by_structure({k: torch.as_tensor(v) for k, v in short.items()}, expected)
    with pytest.raises(ValueError, match="layer-count mismatch"):
        jax_import.import_by_structure(short, template)
