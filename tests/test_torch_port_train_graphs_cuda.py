"""The train step through a CUDA graph (``ecm_torch/train/graphs.py``'s
``GraphedTrainStep``) on the card, at a small shape: 2 pairs of 64x128,
max-disp 64, width 32, the grouped dispatch, seeded weights, in bf16 and
f32, each with ``remat`` on and off.

Marked ``cuda``: skipped without a GPU. The machine with the card has no
JAX, so run these there without the JAX test setup:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_train_graphs_cuda.py``.
"""

import contextlib
import dataclasses
import socket

import pytest
import torch
import torch.distributed as dist

from ecm_torch.configs import CONFIGS
from ecm_torch.data import make_batch
from ecm_torch.ops.launches import COUNTERS, read_counts, read_replayed, reset_counts
from ecm_torch.parallel.sharding import make_mesh
from ecm_torch.train import checkpoint as ckpt_lib
from ecm_torch.train.graphs import GraphedTrainStep
from ecm_torch.train.loop import to_device
from ecm_torch.train.state import create_train_state, make_optimizer
from ecm_torch.train.steps import make_eval_step, make_train_step

pytestmark = pytest.mark.cuda

B, H, W, MAX_DISP = 2, 64, 128, 64
STEPS = 5  # the first eager, the second warm-up and capture, then replays
DROPS = [(3, 1e-4)]  # steps 4 and 5, both replays, at 1e-4
PER_STEP = dict(gband_conv_s1=7, gband_conv_s1_input_grad=7)
# (bf16, remat): sceneflow_single's (bf16, no remat), sceneflow_dp's and the
# grouped gate's (bf16, remat), overfit_gate's (f32, remat), and f32 alone
PRESETS = [(True, False), (True, True), (False, True), (False, False)]
PRESET_IDS = ["bf16", "bf16-remat", "f32-remat", "f32"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.deterministic) = saved


def _state(dev, bf16=True, remat=False, drops=DROPS):
    cfg = dataclasses.replace(CONFIGS["sceneflow_single"].model, max_disp=MAX_DISP, bf16=bf16, remat=remat)
    model = cfg.build(device=dev, generator=torch.Generator().manual_seed(0))
    assert model.resolve_layout(dev) == "grouped"
    return create_train_state(model, make_optimizer(1e-3, drops))


def _batch(dev, seed: int = 1) -> dict[str, torch.Tensor]:
    return to_device(make_batch(seed, B, H, W, max_disp=40.0), dev)


def _run(state, step, batch, steps: int = STEPS) -> list[dict]:
    out = []
    for _ in range(steps):
        _, metrics = step(state, batch)
        out.append(metrics)
    torch.cuda.synchronize()
    return out


def _tensors(state) -> dict[str, torch.Tensor]:
    """Every parameter, buffer, Adam moment and Adam step count by name."""
    out = dict(state.model.state_dict())
    names = {id(p): n for n, p in state.model.named_parameters()}
    for p in state.optimizer.params:
        for k, v in state.optimizer.adam.state[p].items():
            out[f"{names[id(p)]}:{k}"] = v
    return out


def _diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.double() - b.double()).abs().max().item()


def assert_like_eager(graphed: dict, eager: dict, spread: dict) -> None:
    """Each graphed value equal to the eager one within twice the spread of
    two eager runs (0 where eager is deterministic: equal bit for bit)."""
    off = {k: (_diff(graphed[k], eager[k]), 2 * _diff(spread[k], eager[k])) for k in eager}
    bad = {k: v for k, v in off.items() if v[0] > v[1]}
    assert not bad, f"{len(bad)} of {len(off)} beyond twice the eager spread, e.g. {list(bad.items())[:5]}"


@pytest.mark.parametrize("bf16,remat", PRESETS, ids=PRESET_IDS)
def test_graphed_steps_equal_eager_steps(dev, bf16, remat):
    """Five graphed steps against five eager ones from copies of one state on
    one batch, a learning-rate drop between the third and fourth (both later
    steps replays): every step's metrics, then every parameter, buffer, Adam
    moment and step count, equal bit for bit (or within twice the spread of
    a second eager run, which names a nondeterministic op). The first call
    runs eagerly, the second captures, steps 3-5 replay; the wrappers'
    counts plus the replayed counts are 7 + 7 ``gband_conv_s1`` launches a
    step, and no other kernel."""
    batch = _batch(dev)
    graphed, eager, again = _state(dev, bf16, remat), _state(dev, bf16, remat), _state(dev, bf16, remat)
    step = make_train_step(graphed.model, MAX_DISP)
    reset_counts()
    got = _run(graphed, step, batch)
    counts, replayed = read_counts(), read_replayed()
    (captured,) = step.graphed.graphs.values()
    assert captured.replays == STEPS - 2 and not step.graphed.seen
    assert captured.launches == {k: PER_STEP.get(k, 0) for k in COUNTERS}
    assert counts == {k: 2 * PER_STEP.get(k, 0) for k in COUNTERS}
    assert replayed == {k: (STEPS - 2) * PER_STEP.get(k, 0) for k in COUNTERS}
    assert graphed.step == graphed.optimizer.count == STEPS
    assert graphed.optimizer.lr_tensor.item() == pytest.approx(1e-4)

    want = _run(eager, make_train_step(eager.model, MAX_DISP, graphed=False), batch)
    spread = _run(again, make_train_step(again.model, MAX_DISP, graphed=False), batch)
    for i in range(STEPS):
        assert_like_eager({f"{i}:{k}": v for k, v in got[i].items()}, {f"{i}:{k}": v for k, v in want[i].items()},
                          {f"{i}:{k}": v for k, v in spread[i].items()})
    assert_like_eager(_tensors(graphed), _tensors(eager), _tensors(again))
    assert len({m["loss"].data_ptr() for m in got}) == STEPS  # each call's metrics its own


def test_lr_boundary_crossed_during_replays(dev):
    """The drop at count 3 takes effect at the fourth step, a replay: the
    graphed run equals an eager run with the drop and, from that step on,
    differs from one without it."""
    batch = _batch(dev, 2)
    graphed = _state(dev)
    step = make_train_step(graphed.model, MAX_DISP)
    runs = {"drop": _state(dev), "none": _state(dev, drops=None)}
    steps = {k: make_train_step(s.model, MAX_DISP, graphed=False) for k, s in runs.items()}
    for i in range(STEPS):
        step(graphed, batch)
        for k in runs:
            steps[k](runs[k], batch)
        w = graphed.model.aggregation.dres0_1.conv.weight
        assert torch.equal(w, runs["drop"].model.aggregation.dres0_1.conv.weight), i
        assert torch.equal(w, runs["none"].model.aggregation.dres0_1.conv.weight) == (i < 3), i
    assert step.graphed.graphs[next(iter(step.graphed.graphs))].replays == STEPS - 2


def test_host_read_fails_the_capture(dev):
    """A host read (``.item()``) in the step raises at its capture, naming
    the step and its batch; the call returns no eager result, and the card
    still trains."""
    state, batch = _state(dev), _batch(dev)
    step = make_train_step(state.model, MAX_DISP)
    graphed = step.graphed
    inner = graphed.fn

    def train_step(st, left, right, gt):
        out = inner(st, left, right, gt)
        out["loss"] = out["loss"] * out["epe"].item()
        return out

    graphed.fn = train_step
    step(state, batch)  # the first sighting runs eagerly
    with pytest.raises(RuntimeError, match=r"CUDA graph capture of train_step failed for batch \(\(\(2, 64, 128, 3\)"):
        step(state, batch)
    assert not graphed.graphs
    graphed.fn = inner
    torch.cuda.synchronize()
    _, metrics = step(state, batch)
    assert torch.isfinite(metrics["loss"]) and torch.randn(3, device=dev).isfinite().all()


def _eval(model, batch):
    """The eval step of a fresh ``make_eval_step`` on ``model``, eager."""
    return make_eval_step(model, MAX_DISP)(None, batch)


def test_eval_after_replayed_steps_sees_the_new_weights(dev):
    """Two steps (eager, capture), an eval step captured on the weights they
    left, then replayed train steps: the eval step after them equals eval
    on a fresh model given the same ``state_dict``, bit for bit, and so does
    an eager forward of the trained model. Without the versions' bump
    after each replay the eval step replays its old graph, whose packs and
    folds are the old weights', and differs."""
    state, batch = _state(dev), _batch(dev)
    step = make_train_step(state.model, MAX_DISP)
    evaluate = make_eval_step(state.model, MAX_DISP)
    _run(state, step, batch, 2)
    for _ in range(3):
        evaluate(state, batch)
    (eval_graph,) = evaluate.graphed.graphs.values()
    assert eval_graph.replays == 1
    _run(state, step, batch, 2)
    disp, metrics = evaluate(state, batch)
    fresh = _state(dev).model
    fresh.load_state_dict(state.model.state_dict())
    want_disp, want = _eval(fresh, batch)
    assert torch.equal(disp, want_disp) and all(torch.equal(metrics[k], want[k]) for k in want)
    with torch.inference_mode():
        state.model.eval()
        assert torch.equal(state.model(batch["left"], batch["right"])[-1], want_disp)


def test_save_after_replays_restores_into_an_eager_state(dev, tmp_path):
    """Four steps (two replays), saved, restored into an eager state on the
    card and into one on the CPU: the model and Adam's state equal the
    graphed run's, and a fifth step of each eager state equals the graphed
    run's fifth (a replay) on the card."""
    state, batch = _state(dev), _batch(dev)
    step = make_train_step(state.model, MAX_DISP)
    _run(state, step, batch, 4)
    manager = ckpt_lib.make_manager(str(tmp_path))
    ckpt_lib.save(manager, 4, state)
    saved = {k: v.clone() for k, v in _tensors(state).items()}
    restored, step0 = ckpt_lib.restore_latest(manager, _state(dev))
    on_cpu, _ = ckpt_lib.restore_latest(manager, create_train_state(
        _state(dev).model.cpu(), make_optimizer(1e-3, DROPS)))
    assert step0 == restored.step == restored.optimizer.count == on_cpu.optimizer.count == 4
    for other in (restored, on_cpu):
        got = _tensors(other)
        assert all(torch.equal(got[k].to(dev), v.to(got[k].dtype).to(dev) if k.endswith(":step") else v)
                   for k, v in saved.items())
    _, want = step(state, batch)
    _, got = make_train_step(restored.model, MAX_DISP, graphed=False)(restored, batch)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert_like_eager(_tensors(restored), _tensors(state), _tensors(state))


@contextlib.contextmanager
def _gloo_world_of_one():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        yield make_mesh()
    finally:
        dist.destroy_process_group()


def test_mesh_and_anomaly_steps_stay_eager(dev, monkeypatch):
    """A step under a mesh (DDP over a gloo group of one) and a step in
    anomaly mode run eagerly, every call: no graph is built or replayed,
    and each call launches its 7 + 7 kernels itself."""

    def no_graph(*_, **__):
        raise AssertionError("a CUDA graph")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", no_graph)
    state, batch = _state(dev), _batch(dev)
    reset_counts()
    with _gloo_world_of_one() as mesh:
        meshed = make_train_step(state.model, MAX_DISP, mesh)
        assert meshed.graphed is None
        metrics = _run(state, meshed, batch, 3)
    step = make_train_step(state.model, MAX_DISP)
    with torch.autograd.detect_anomaly():
        metrics += _run(state, step, batch, 3)
    assert not step.graphed.graphs and not step.graphed.seen and isinstance(step.graphed, GraphedTrainStep)
    assert read_counts() == {k: 6 * PER_STEP.get(k, 0) for k in COUNTERS}
    assert read_replayed() == dict.fromkeys(COUNTERS, 0)
    assert all(torch.isfinite(m["loss"]) for m in metrics) and state.step == 6
