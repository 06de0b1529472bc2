"""Serving through CUDA graphs (``ecm_torch/train/graphs.py``) on the card,
at a small shape: 64x128, max-disp 64, width 32, bf16, seeded weights.

Marked ``cuda``: skipped without a GPU. The machine with the card has no
JAX, so run these there without the JAX test setup:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_graphs_cuda.py``.
"""

import dataclasses

import pytest
import torch

from ecm_torch.configs import CONFIGS
from ecm_torch.configs.base import SLICE2_OVERRIDES, SLICE_OVERRIDES
from ecm_torch.ops.launches import COUNTERS, read_counts, read_replayed, reset_counts
from ecm_torch.parallel.sharding import Mesh, use_mesh
from ecm_torch.train.graphs import GraphedForward
from ecm_torch.train.metrics import disparity_metrics
from ecm_torch.train.state import create_train_state
from ecm_torch.train.steps import make_eval_step, make_infer_fn

pytestmark = pytest.mark.cuda

H, W, MAX_DISP = 64, 128, 64
# path -> (model, overrides, kernel launches a forward)
PATHS = {
    "grouped": ("stackhourglass", SLICE2_OVERRIDES, dict(
        cost_volume_concat=1, conv3d_bn_s1=4, conv3d_bn_down=3, deconv3d_bn=3,
        fused_conv3d_pair=1, fused_upsample_softargmin=1)),
    "standard": ("stackhourglass", SLICE_OVERRIDES, dict(
        cost_volume_concat=1, fused_conv3d_pair=3, fused_upsample_softargmin=1)),
    "basic": ("basic", dict(use_pallas=True, regress_mode="fused"), dict(
        cost_volume_concat=1, fused_upsample_softargmin=1)),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(path: str, dev):
    name, overrides, _ = PATHS[path]
    cfg = dataclasses.replace(CONFIGS["kitti_infer"].model, name=name, max_disp=MAX_DISP)
    return cfg.build(device=dev, generator=torch.Generator().manual_seed(0), **overrides)


def _pair(dev, seed: int, batch: int = 1):
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.rand(batch, H, W, 3, generator=g, device=dev) for _ in range(2))


def _eager(model, left, right):
    with torch.inference_mode():
        return model(left, right)[-1]


@pytest.mark.parametrize("path", PATHS)
def test_replay_equals_the_eager_forward(dev, path):
    """The first call (eager), the second (warm-up, then capture) and every
    replay equal the eager forward bit for bit; the capture records the
    path's launches as the graph's and leaves the wrappers' counts as the
    warm-up left them (it launches nothing), a replay counts them as
    replayed and moves no wrapper's count; each call returns a tensor of
    its own."""
    model = _model(path, dev)
    per = {k: PATHS[path][2].get(k, 0) for k in COUNTERS}
    infer = make_infer_fn(model)
    reqs = [_pair(dev, s) for s in (1, 2, 3)]
    reset_counts()
    first = infer(*reqs[0])
    assert not infer.graphs and read_counts() == per
    second = infer(*reqs[0])
    (captured,) = infer.graphs.values()
    assert captured.launches == per
    assert read_counts() == {k: 2 * n for k, n in per.items()}
    reset_counts()
    outs = [infer(*r) for r in reqs]
    torch.cuda.synchronize()
    assert read_counts() == dict.fromkeys(COUNTERS, 0)
    assert read_replayed() == {k: 3 * n for k, n in per.items()}
    assert captured.replays == 3 and len(infer.graphs) == 1
    assert infer.late_checks == 3 and infer.discards == 0
    assert torch.equal(first, _eager(model, *reqs[0])) and torch.equal(second, first)
    for r, out in zip(reqs, outs):
        assert out.shape == (1, H, W) and torch.equal(out, _eager(model, *r))
    assert len({o.data_ptr() for o in outs}) == 3 and not torch.equal(outs[0], outs[1])


def test_eval_step_replays_the_forward_and_metrics(dev):
    """``make_eval_step`` on the grouped path: the disparity and every
    metric of a replay equal the eager ones bit for bit."""
    model = _model("grouped", dev)
    step = make_eval_step(model, MAX_DISP)
    state = create_train_state(model)
    for seed in (4, 5, 6, 7):
        left, right = _pair(dev, seed)
        gt = torch.rand(1, H, W, device=dev) * 1.2 * MAX_DISP
        disp, metrics = step(state, {"left": left, "right": right, "disparity": gt})
        ref = _eager(model, left, right)
        ref_metrics = disparity_metrics(ref, gt, MAX_DISP)
        assert torch.equal(disp, ref)
        assert all(torch.equal(metrics[k], ref_metrics[k]) for k in ref_metrics)
    (captured,) = step.graphed.graphs.values()
    assert captured.replays == 2


def test_weight_update_captures_again(dev):
    """In-place updates (a weight scaled, BatchNorm statistics scaled,
    ``load_state_dict`` of another model's weights) are replayed: the graph
    reads the weights where they live and packs and folds them at each
    replay, so the call after each update replays the same graph, with no
    discard, and equals the eager forward of the changed model. A weight
    replaced by a new tensor moves the stamp: the next call's replay is
    thrown away (``discards``) and the call runs eagerly, the one after
    captures again, and all equal the eager forward."""
    model = _model("grouped", dev)
    infer = make_infer_fn(model)
    req = _pair(dev, 7)
    infer(*req)
    infer(*req)
    before = infer(*req)
    (graph,) = infer.graphs.values()
    other = _model("grouped", dev)
    with torch.no_grad():
        other.aggregation.dres0_1.conv.weight.mul_(1.5)

    def scale_weight():
        with torch.no_grad():
            model.aggregation.dres0_1.conv.weight.mul_(0.5)

    def scale_statistics():
        with torch.no_grad():
            model.aggregation.classif3.conv1.bn.running_var.mul_(4.0)

    for update in (scale_weight, scale_statistics, lambda: model.load_state_dict(other.state_dict())):
        replays = graph.replays
        update()
        eager = _eager(model, *req)
        assert not torch.equal(eager, before)
        assert torch.equal(infer(*req), eager)
        assert list(infer.graphs.values()) == [graph] and graph.replays == replays + 1 and infer.discards == 0
        before = eager

    conv = model.aggregation.dres0_1.conv
    conv.weight = torch.nn.Parameter(conv.weight.detach() * 2.0)
    replays = graph.replays
    eager = _eager(model, *req)
    assert not torch.equal(eager, before)
    assert torch.equal(infer(*req), eager)
    assert not infer.graphs and graph.replays == replays + 1 and infer.discards == 1
    assert torch.equal(infer(*req), eager)
    (new,) = infer.graphs.values()
    assert new is not graph
    assert torch.equal(infer(*req), eager) and new.replays == 1 and infer.discards == 1


@pytest.mark.parametrize("sync", ["item", "pageable_copy"])
def test_host_sync_fails_the_capture(dev, sync):
    """A host sync inside the forward raises at capture, naming the
    function; nothing returns an eager result; the card, its random
    numbers and a later capture still work."""
    lin = torch.nn.Linear(4, 4).to(dev)

    def synced(x):
        if sync == "item":
            return lin(x) * x.sum().item()
        return lin(x) + torch.ones(4).to(dev)

    graphed = GraphedForward(synced, lin)
    x = torch.randn(2, 4, device=dev)
    graphed(x)  # the first sighting runs eagerly
    with pytest.raises(RuntimeError, match="CUDA graph capture of synced failed"):
        graphed(x)
    assert not graphed.graphs
    torch.cuda.synchronize()
    assert torch.equal(synced(x), synced(x))
    assert torch.randn(3, device=dev).isfinite().all()

    @torch.no_grad()
    def doubled(x):
        return lin(x) * 2.0

    clean = GraphedForward(doubled, lin)
    for _ in range(3):
        assert torch.equal(clean(x), doubled(x))
    assert len(clean.graphs) == 1


def test_multi_rank_mesh_stays_eager(dev):
    """Under a mesh of more than one rank the forward runs eagerly and no
    graph is captured (its collectives go through host buffers)."""
    model = _model("basic", dev)
    infer = make_infer_fn(model)
    req = _pair(dev, 8)
    reset_counts()
    with use_mesh(Mesh(None, 2, 0)):
        out = infer(*req)
        infer(*req)
    assert not infer.graphs and not infer.seen
    assert read_counts()["fused_upsample_softargmin"] == 2
    assert torch.equal(out, _eager(model, *req))
