"""Serving as one captured program per input signature (``ecm_torch/train/
graphs.py``, the counterpart of ``ecm_tpu/train/steps.py``'s ``jax.jit``) and
the device-resident resize matrices it needs (``ecm_torch/ops/upsample.py``),
on the CPU: ``make_infer_fn`` and ``make_eval_step`` against the JAX
package's at 32x48, max-disp 16, width 8, f32 (disparity and every metric
at 1e-3, as ``test_torch_port_model.py`` holds the disparity), the graph
signature as a pure function, and no graph on CPU tensors. The replays
themselves run on the card: ``test_torch_port_graphs_cuda.py``."""

import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecm_tpu.models import build_model as jax_build_model
from ecm_tpu.ops import upsample as jup
from ecm_tpu.train import state as jstate
from ecm_tpu.train import steps as jsteps
from ecm_torch.configs import CONFIGS
from ecm_torch.configs.base import SLICE_OVERRIDES
from ecm_torch.models.layers import fold_bn
from ecm_torch.ops import cuda_gband, upsample
from ecm_torch.parallel.sharding import Mesh
from ecm_torch.train import graphs
from ecm_torch.train.state import create_train_state
from ecm_torch.train.steps import make_eval_step, make_infer_fn
from ecm_torch.weights import load_flax
from test_torch_port_util import flax_variables, t, torch_threads

SMALL = dict(max_disp=16, feature_channels=8)
PLAIN = dict(agg_layout="standard", agg_fused="off", use_pallas=False, regress_mode="fullres")
BASIC = dict(use_pallas=True, regress_mode="fused")
# the SPP branches' pooled sizes at kitti_infer's 96x312 features (pools 64,
# 32, 16, 8) up to the features, the identity, and the regression's x4
# trilinear (48 -> 192, 96 -> 384, 312 -> 1248)
SPP_SIZES = [(1, 96), (4, 312), (3, 96), (9, 312), (6, 96), (19, 312), (12, 96), (39, 312)]
SIZES = SPP_SIZES + [(96, 96), (1, 1), (48, 192), (96, 384), (312, 1248)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    with torch_threads(1):
        yield


@pytest.mark.parametrize("n_in,n_out", SIZES)
def test_resize_matrix_is_jax_bit_for_bit(n_in, n_out):
    ref = jup._resize_matrix(n_in, n_out)
    np.testing.assert_array_equal(upsample._resize_matrix(n_in, n_out), ref)
    on_device = upsample.resize_matrix(n_in, n_out, torch.device("cpu"), torch.float32)
    np.testing.assert_array_equal(on_device.numpy(), ref)


def test_resize_matrix_is_made_once(monkeypatch):
    """A second call at the same sizes returns the cached tensor, and an
    upsample after the first makes no numpy matrix and no copy."""
    cpu = torch.device("cpu")
    first = upsample.resize_matrix(5, 17, cpu, torch.float32)
    assert upsample.resize_matrix(5, 17, cpu, torch.float32) is first
    assert upsample.resize_matrix(5, 17, cpu, torch.float64) is not first
    assert not first.is_inference() and not first.requires_grad
    x = torch.randn(1, 5, 7, 2)
    ref = upsample.upsample_bilinear(x, (17, 29))

    def numpy_work(*_):
        raise AssertionError("made a resize matrix again")

    monkeypatch.setattr(upsample, "_resize_matrix", numpy_work)
    monkeypatch.setattr(upsample.torch, "from_numpy", numpy_work)
    assert torch.equal(upsample.upsample_bilinear(x, (17, 29)), ref)


@pytest.mark.parametrize("shape,out", [((2, 3, 4, 5), (12, 16, 20)), ((1, 6, 19, 3), (96, 312))])
def test_upsample_still_matches_jax(shape, out):
    """Both upsamples against JAX at ``test_torch_port_modules.py``'s 1e-4,
    twice: the second call reads the cached matrices."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=shape).astype(np.float32)
    for _ in range(2):
        if len(out) == 3:
            got, ref = upsample.upsample_trilinear(t(x), out), jup.upsample_trilinear(jnp.asarray(x), out)
        else:
            got, ref = upsample.upsample_bilinear(t(x), out), jup.upsample_bilinear(jnp.asarray(x), out)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def _torch_model(name: str, overrides: dict):
    cfg = dataclasses.replace(CONFIGS["kitti_infer"].model, name=name)
    return cfg.build(device="cpu", **overrides, **SMALL, dtype=torch.float32)


@pytest.mark.parametrize("name,overrides", [("stackhourglass", SLICE_OVERRIDES), ("basic", BASIC)],
                         ids=["stackhourglass", "basic"])
def test_infer_and_eval_step_match_jax(name, overrides):
    """The port's ``make_infer_fn`` and ``make_eval_step`` against
    ``ecm_tpu.train.steps``' jitted ones on the same variables and batch:
    the disparity and every metric at 1e-3 (a pixel whose error flips a
    threshold moves a rate by 1/1536), the valid count exactly."""
    rng = np.random.default_rng(11)
    left, right = (rng.normal(size=(1, 32, 48, 3)).astype(np.float32) for _ in range(2))
    gt = rng.uniform(0.5, 20.0, size=(1, 32, 48)).astype(np.float32)  # some beyond max-disp 16
    jm = jax_build_model(name, remat=False, **overrides, **SMALL)
    variables = flax_variables(jm, jnp.asarray(left), jnp.asarray(right))
    j_state = jstate.TrainState.create(apply_fn=jm.apply, params=variables["params"],
                                       batch_stats=variables["batch_stats"], tx=jstate.make_optimizer())
    j_batch = {"left": jnp.asarray(left), "right": jnp.asarray(right), "disparity": jnp.asarray(gt)}
    j_disp, j_metrics = jsteps.make_eval_step(jm, SMALL["max_disp"])(j_state, j_batch)
    j_infer = jsteps.make_infer_fn(jm, variables)(j_batch["left"], j_batch["right"])

    tm = _torch_model(name, overrides)
    load_flax(tm, jax.tree.map(np.asarray, variables))
    batch = {"left": t(left), "right": t(right), "disparity": t(gt)}
    disp, metrics = make_eval_step(tm, SMALL["max_disp"])(create_train_state(tm), batch)
    infer = make_infer_fn(tm)(batch["left"], batch["right"])

    assert disp.shape == infer.shape == (1, 32, 48)
    np.testing.assert_allclose(disp.numpy(), np.asarray(j_disp), rtol=0, atol=1e-3)
    np.testing.assert_allclose(infer.numpy(), np.asarray(j_infer), rtol=0, atol=1e-3)
    assert set(metrics) == set(j_metrics)
    assert 0 < metrics["valid_px"].item() < 32 * 48
    assert metrics["valid_px"].item() == float(j_metrics["valid_px"])
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(j_metrics[k]), rtol=0, atol=1e-3, err_msg=k)


@pytest.fixture(scope="module")
def small_model():
    return _torch_model("stackhourglass", PLAIN)


def _args(shape=(1, 32, 48, 3), dtype=torch.float32, device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.rand(shape, generator=g, dtype=dtype).to(device) for _ in range(2))


def test_signature_keys_what_a_capture_reads(small_model):
    """A pure function of the inputs' shapes, dtypes and device, the resolved
    layout, the mesh and every parameter's and buffer's stamp; new values of
    the same inputs leave it as it is."""
    m = small_model
    base = graphs.signature(m, _args(), None)
    assert graphs.signature(m, _args(), None) == base
    assert graphs.signature(m, _args(seed=1), None) == base
    assert graphs.signature(m, _args((1, 48, 64, 3)), None) != base
    assert graphs.signature(m, _args((2, 32, 48, 3)), None) != base
    assert graphs.signature(m, _args(dtype=torch.float64), None) != base
    assert graphs.signature(m, _args(device="meta"), None) != base
    assert graphs.signature(m, _args(), Mesh(None, 1, 0)) != base
    assert graphs.signature(m, _args(), Mesh(None, 1, 0)) != graphs.signature(m, _args(), Mesh(None, 1, 0, disp=2))
    m.agg_layout = "grouped"
    try:
        assert graphs.signature(m, _args(), None)[1] == "grouped"
        assert graphs.signature(m, _args(), None) != base
    finally:
        m.agg_layout = "standard"
    assert graphs.signature(m, _args(), None) == base


def test_signature_moves_with_every_weight_update(small_model):
    """An in-place ``add_`` on a parameter, a BatchNorm's running-statistics
    update in training mode, and ``load_state_dict`` each give a new
    signature: the graph of the old one would replay stale packs and folds."""
    m = small_model
    args = _args()
    sig = graphs.signature(m, args, None)
    with torch.no_grad():
        m.aggregation.dres0_1.conv.weight.add_(0.0)
    assert graphs.signature(m, args, None) != sig

    sig = graphs.signature(m, args, None)
    bn = m.feature.firstconv1.bn
    mean = bn.running_mean.clone()
    bn.train()
    try:
        with torch.no_grad():
            bn(torch.randn(2, 32, 4, 4))
    finally:
        bn.eval()
    assert not torch.equal(bn.running_mean, mean)
    assert graphs.signature(m, args, None) != sig

    sig = graphs.signature(m, args, None)
    m.load_state_dict(m.state_dict())
    assert graphs.signature(m, args, None) != sig
    assert graphs.signature(m, args, None) == graphs.signature(m, args, None)


def test_cpu_builds_no_graph(small_model, monkeypatch):
    """On CPU tensors both functions run the eager forward and never build,
    capture or replay a graph."""

    def no_graph(*_, **__):
        raise AssertionError("a CUDA graph on the CPU")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", no_graph)
    monkeypatch.setattr(torch.cuda, "graph", no_graph)
    m = small_model
    left, right = _args()
    gt = torch.full((1, 32, 48), 5.0)
    infer = make_infer_fn(m)
    step = make_eval_step(m, SMALL["max_disp"])
    state = create_train_state(m)
    with torch.inference_mode():
        ref = m(left, right)[-1]
    for _ in range(2):
        assert torch.equal(infer(left, right), ref)
        disp, metrics = step(state, {"left": left, "right": right, "disparity": gt})
        assert torch.equal(disp, ref) and metrics["valid_px"].item() == 32 * 48
    assert not infer.graphs and not step.graphed.graphs
    assert not infer.seen and not step.graphed.seen


def test_capture_waits_for_the_second_sighting(monkeypatch):
    """A signature's first call runs the function eagerly, its second
    captures; a new weights stamp (the key's last item) forgets the graphs
    and sightings of the old one; at most ``MAX_SEEN`` sightings are kept."""
    calls, captures = [], []
    g = graphs.GraphedForward(lambda *a: calls.append(a) or "eager", torch.nn.Linear(1, 1))
    monkeypatch.setattr(g, "_capture", lambda key, args: captures.append(key) or "captured")
    a, b, c = ("a", "w0"), ("b", "w0"), ("a", "w1")
    assert g._miss(a, (1,)) == "eager" and calls == [(1,)] and not captures
    assert g._miss(b, (2,)) == "eager" and list(g.seen) == [a, b]
    assert g._miss(a, (3,)) == "captured" and captures == [a] and len(calls) == 2
    assert list(g.seen) == [b]
    g.graphs[a] = "graph of a"
    assert g._miss(c, (4,)) == "eager"
    assert not g.graphs and list(g.seen) == [c]
    for i in range(graphs.MAX_SEEN + 3):
        g._miss((i, "w1"), ())
    assert len(g.seen) == graphs.MAX_SEEN and (0, "w1") not in g.seen and not captures[1:]


def test_a_capture_holds_what_the_caches_hand_out():
    """Inside ``cuda_gband.holding`` every pack that ``cached_pack`` hands
    out, a hit as much as a miss, and the fold that ``fold_bn`` keeps are
    collected, and stay alive after the caches replace them; outside it
    nothing is collected."""
    w = torch.randn(4, 4)
    with cuda_gband.holding() as held:
        packed = cuda_gband.cached_pack(w, "test", lambda: w * 2)
        assert cuda_gband.cached_pack(w, "test", lambda: w * 3) is packed
    assert [id(x) for x in held] == [id(packed)] * 2
    gone = weakref.ref(packed)
    del packed
    with torch.no_grad():
        w.add_(1.0)
    repacked = cuda_gband.cached_pack(w, "test", lambda: w * 2)
    gc.collect()
    assert gone() is not None and gone() is not repacked and len(held) == 2
    del held
    gc.collect()
    assert gone() is None

    bn = torch.nn.BatchNorm3d(4).eval()
    with torch.inference_mode(), cuda_gband.holding() as held:
        scale, bias = fold_bn(bn)
    assert [id(x) for x in held] == [id(scale), id(bias)]
    fold = weakref.ref(scale)
    del scale, bias
    with torch.no_grad():
        fold_bn(bn)  # another grad mode: the module's fold is replaced
    gc.collect()
    assert fold() is not None
    with torch.no_grad():
        fold_bn(bn)
        cuda_gband.cached_pack(w, "test", lambda: w * 2)
    assert len(held) == 2
