"""Serving as one captured program per input signature (``ecm_torch/train/
graphs.py``, the counterpart of ``ecm_tpu/train/steps.py``'s ``jax.jit``) and
the device-resident resize matrices it needs (``ecm_torch/ops/upsample.py``),
on the CPU: ``make_infer_fn`` and ``make_eval_step`` against the JAX
package's at 32x48, max-disp 16, width 8, f32 (disparity and every metric
at 1e-3, as ``test_torch_port_model.py`` holds the disparity), the graph
signature as a pure function, and no graph on CPU tensors. The replays
themselves run on the card: ``test_torch_port_graphs_cuda.py``."""

import dataclasses

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
from ecm_torch.ops import upsample
from ecm_torch.parallel.sharding import Mesh
from ecm_torch.train import graphs
from ecm_torch.train.state import create_train_state
from ecm_torch.train.steps import make_eval_step, make_infer_fn
from ecm_torch.weights import load_flax
from test_torch_port_train_graphs import fake_capture
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
    """The key read before the launch: a pure function of the inputs'
    shapes, dtypes and device, the resolved layout and the mesh; new values
    of the same inputs leave it as it is, and so does a weight update. The
    weights stamp read after the launch is the address of every parameter
    and buffer, and an in-place update leaves it as it is too."""
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
    stamp = graphs.weights_stamp(m)
    assert sorted(stamp) == sorted(t.data_ptr() for t in (*m.parameters(), *m.buffers()))
    with torch.no_grad():
        m.aggregation.dres0_1.conv.weight.add_(0.0)
    assert graphs.signature(m, _args(), None) == base and graphs.weights_stamp(m) == stamp


def _full_signature(m, args) -> tuple:
    """What a forward's graph is keyed by: the key and the weights stamp."""
    return graphs.signature(m, args, None), graphs.weights_stamp(m)


def test_signature_moves_with_every_weight_update(small_model):
    """An in-place ``add_`` on a parameter, a BatchNorm's running-statistics
    update in training mode and ``load_state_dict``, which copies in place,
    leave the signature as it is: a graph reads the weights where they live
    and derives its packs and folds from them at each replay. A replaced
    parameter and ``model.to()`` another dtype make new tensors, and a new
    signature, by its weights stamp."""
    m = small_model
    args = _args()
    sig = _full_signature(m, args)
    with torch.no_grad():
        m.aggregation.dres0_1.conv.weight.add_(0.0)
    assert _full_signature(m, args) == sig

    bn = m.feature.firstconv1.bn
    mean = bn.running_mean.clone()
    bn.train()
    try:
        with torch.no_grad():
            bn(torch.randn(2, 32, 4, 4))
    finally:
        bn.eval()
    assert not torch.equal(bn.running_mean, mean)
    assert _full_signature(m, args) == sig

    m.load_state_dict(m.state_dict())
    assert _full_signature(m, args) == sig

    conv = m.aggregation.dres0_1.conv
    weight = conv.weight
    conv.weight = torch.nn.Parameter(weight.detach().clone())
    try:
        moved = _full_signature(m, args)
        assert moved[0] == sig[0] and moved[1] != sig[1]
    finally:
        conv.weight = weight
    assert _full_signature(m, args) == sig
    m.to(torch.float64)
    try:
        moved = _full_signature(m, args)
        assert moved[0] == sig[0] and moved[1] != sig[1]
    finally:
        m.to(torch.float32)
    assert _full_signature(m, args) == _full_signature(m, args)


def _fake_forward(monkeypatch, seen: list, dtype: torch.dtype = torch.float32,
                  computing: bool = False) -> graphs.GraphedForward:
    """A graphed forward of a small linear model in ``dtype`` with the CPU
    taken for the card, captured by the train-graph tests' fake capture
    (``computing``: whose replays compute the forward on the weights as
    they are then); each call of the function and each capture and replay
    lands in ``seen``."""
    monkeypatch.setattr(graphs, "_on_card", lambda x: True)
    model = torch.nn.Linear(3, 2).to(dtype)

    @torch.no_grad()
    def compute(x):
        return model(x) * 2

    def forward(x):
        seen.append(("fn",))
        return compute(x)

    g = graphs.GraphedForward(forward, model)
    monkeypatch.setattr(g, "_capture", fake_capture(g, seen, compute=compute if computing else None))
    return g


def test_a_replay_reads_its_stamp_after_the_launch(monkeypatch):
    """The first call runs eagerly, the second warms up and captures, later
    ones replay and then read the weights stamp: ``late_checks`` counts
    each replay, nothing is discarded, and each returns new tensors equal to
    the graph's outputs."""
    seen = []
    g = _fake_forward(monkeypatch, seen)
    x = torch.ones(4, 3)
    g(x)
    g(x)
    assert g.late_checks == 0 and len(g.graphs) == 1
    (captured,) = g.graphs.values()
    for _ in range(3):
        out = g(x)
        assert out is not captured.outputs and torch.equal(out, captured.outputs)
    assert g.late_checks == captured.replays == 3 and g.discards == 0
    assert [s[0] for s in seen] == ["fn", "fn", "capture", "replay", "replay", "replay"]


def test_a_moved_stamp_discards_the_replay(monkeypatch):
    """After a weight is replaced by a new tensor the next call launches the
    graph on its key, reads the new stamp after it and throws the replay
    away: it returns the updated model's eager result, never the graph's
    outputs, and leaves no graph and one sighting, under the new stamp. The
    call after that captures again."""
    seen = []
    g = _fake_forward(monkeypatch, seen)
    x = torch.ones(4, 3)
    for _ in range(3):
        g(x)
    (captured,) = g.graphs.values()
    g.model.weight = torch.nn.Parameter(g.model.weight.detach() + 1.0)
    seen.clear()
    ref = g.fn(x)
    assert not torch.equal(ref, captured.outputs)
    out = g(x)
    assert torch.equal(out, ref) and not torch.equal(out, captured.outputs)
    assert [s[0] for s in seen] == ["fn", "replay", "fn"]
    assert captured.replays == 2 and g.late_checks == 2 and g.discards == 1
    assert not g.graphs and list(g.seen) == [g.key((x,))] and g.stamp == graphs.weights_stamp(g.model)
    assert torch.equal(g(x), ref) and len(g.graphs) == 1 and seen[-1] == ("capture",)
    assert torch.equal(g(x), ref) and g.late_checks == 3 and g.discards == 1


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
    captures; a new weights stamp forgets the graphs and sightings of the
    old one and is kept as theirs; at most ``MAX_SEEN`` sightings are
    kept."""
    calls, captures = [], []
    g = graphs.GraphedForward(lambda *a: calls.append(a) or "eager", torch.nn.Linear(1, 1))
    monkeypatch.setattr(g, "_capture", lambda key, args: captures.append(key) or "captured")
    a, b = ("a",), ("b",)
    assert g._miss(a, "w0", (1,)) == "eager" and calls == [(1,)] and not captures
    assert g._miss(b, "w0", (2,)) == "eager" and list(g.seen) == [a, b] and g.stamp == "w0"
    assert g._miss(a, "w0", (3,)) == "captured" and captures == [a] and len(calls) == 2
    assert list(g.seen) == [b]
    g.graphs[a] = "graph of a"
    assert g._miss(a, "w1", (4,)) == "eager"
    assert not g.graphs and list(g.seen) == [a] and g.stamp == "w1"
    for i in range(graphs.MAX_SEEN + 3):
        g._miss((i,), "w1", ())
    assert len(g.seen) == graphs.MAX_SEEN and (0,) not in g.seen and not captures[1:]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_an_eval_graph_replays_in_place_updates(monkeypatch, dtype):
    """A forward's graph, captured once, replays after in-place updates of
    the weights (what an optimizer step, a replayed train step and
    ``load_state_dict`` make), with no discard and no new capture, and each
    replay equals the eager forward on the new weights: the graph reads
    them where they live. A parameter replaced by a new tensor moves the
    stamp: that replay is thrown away, and the call after next captures
    again."""
    seen = []
    g = _fake_forward(monkeypatch, seen, dtype, computing=True)
    x = torch.linspace(-1.0, 1.0, 12).view(4, 3).to(dtype)
    for _ in range(3):
        g(x)
    (captured,) = g.graphs.values()
    other = torch.nn.Linear(3, 2).to(dtype)
    updates = (lambda: g.model.weight.mul_(-0.5), lambda: g.model.bias.add_(1.0),
               lambda: g.model.load_state_dict(other.state_dict()))
    for i, update in enumerate(updates):
        before = g.fn(x)
        with torch.no_grad():
            update()
        want = g.fn(x)
        assert not torch.equal(want, before)
        assert torch.equal(g(x), want) and captured.replays == i + 2
    assert list(g.graphs.values()) == [captured] and g.discards == 0
    assert [s[0] for s in seen].count("capture") == 1

    g.model.weight = torch.nn.Parameter(g.model.weight.detach().clone())
    want = g.fn(x)
    assert torch.equal(g(x), want) and g.discards == 1 and not g.graphs
    assert torch.equal(g(x), want) and [s[0] for s in seen].count("capture") == 2
    (again,) = g.graphs.values()
    assert again is not captured and torch.equal(g(x), want) and again.replays == 1
