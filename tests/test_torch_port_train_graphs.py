"""The train step as one captured program per batch signature (``ecm_torch/
train/graphs.py``'s ``GraphedTrainStep``, the counterpart of the donated
``jax.jit`` of ``ecm_tpu/train/steps.py::make_train_step``), on the CPU:
three steps across a learning-rate drop against the JAX package's step in
f64, the train signature as a pure function, the host's bookkeeping
through a fake capture and replay, the eager branches, the optimizer's
state in checkpoints, and the pack cache's rule for a train capture. The
replays themselves run on the card: ``test_torch_port_train_graphs_cuda.py``."""

import contextlib
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from ecm_tpu.data.synthetic import make_batch
from ecm_tpu.models import build_model as jax_build_model
from ecm_tpu.train import state as jstate
from ecm_tpu.train import steps as jsteps
from ecm_torch.models import build_model
from ecm_torch.ops import cuda_gband, launches
from ecm_torch.parallel.sharding import make_mesh
from ecm_torch.train import checkpoint as ckpt_lib
from ecm_torch.train import graphs
from ecm_torch.train.loop import to_device
from ecm_torch.train.loss import stereo_loss
from ecm_torch.train.state import create_train_state, make_optimizer
from ecm_torch.train.steps import make_eval_step, make_train_step
from ecm_torch.weights import from_flax, load_flax
from test_torch_port_util import assert_close_rel, flax_variables, t, torch_threads

PLAIN = dict(use_pallas=False, regress_mode="fullres")
DROPS = [(2, 1e-4)]  # steps 1-3 at 1e-3, 1e-3, 1e-4
LRS = (1e-3, 1e-3, 1e-4)
SMALL = dict(max_disp=16, feature_channels=8)
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    with torch_threads(1):
        yield


def _moments(state, named: dict, key: str) -> dict[str, torch.Tensor]:
    return {n: state.optimizer.adam.state[p][key] for n, p in named.items()}


def _is_head_bias(name: str) -> bool:
    """The heads' conv2 biases shift a cost map uniformly over D, which the
    soft-argmin ignores: their exact gradient is 0 (``assert_grads_match``)."""
    return "classif" in name and name.endswith("conv2.bias")


def test_three_steps_across_an_lr_drop_match_jax():
    """Three steps of ``make_train_step`` against ``ecm_tpu``'s donated jit,
    in f64 on both sides (``jax.enable_x64``), standard layout at width 8,
    two 64x64 pairs a step, with a drop to 1e-4 at step 2: the steps run at
    1e-3, 1e-3 and 1e-4. Each step starts the port from the JAX package's
    state after the step before (parameters, statistics and Adam's moments
    copied in place; the port's counts, schedule and Adam step counts its
    own): run freely, the two trajectories part, as Adam maps a gradient
    near 0, whose sign the f32 loss's rounding decides, to about +-lr (seed
    8: moments 4.4e-2 apart at step 3, mostly through the SPP branches'
    BatchNorm over two pooled values a channel).

    Readings over seeds 7 and 8: loss rel <= 4.5e-7, every running statistic
    rel <= 2.2e-14, each tensor's moments rel <= 5.3e-7 (the heads' conv2
    biases aside, below 2e-9); parameters: at most 15 elements a step off by
    more than lr / 1000 (the three conv2 biases and, at the first step of
    each moment, elements whose gradient is near 0), none by more than
    0.73 lr. Held at loss rel 1e-5, statistics 1e-6, moments 1e-4 per tensor
    (the conv2 biases at 1e-4 of the largest), every parameter within 2 lr
    and all but 20 elements within lr / 1000: a step at another learning
    rate moves millions of elements by about the difference."""
    kw = dict(SMALL, agg_layout="standard", remat=False)
    batches = [make_batch(7 + 10 * i, 2, h=64, w=64, max_disp=12.0) for i in range(3)]
    with jax.enable_x64(True):
        jm = jax_build_model("stackhourglass", **PLAIN, **kw, dtype=jnp.float64)
        variables = flax_variables(jm, jnp.asarray(batches[0]["left"]), jnp.asarray(batches[0]["right"]))
        variables = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
        j_state = jstate.TrainState.create(apply_fn=jm.apply, params=variables["params"],
                                           batch_stats=variables["batch_stats"],
                                           tx=jstate.make_optimizer(1e-3, DROPS))
        j_step = jsteps.make_train_step(jm, SMALL["max_disp"])
        refs = []
        for b in batches:
            j_state, j_metrics = j_step(j_state, {k: jnp.asarray(np.asarray(v, np.float64)) for k, v in b.items()})
            adam = j_state.opt_state[0]
            refs.append(dict(loss=float(j_metrics["loss"]), **{
                k: jax.tree.map(np.asarray, v) for k, v in (
                    ("params", j_state.params), ("stats", j_state.batch_stats), ("mu", adam.mu), ("nu", adam.nu))}))

    tm = build_model("stackhourglass", device="cpu", **PLAIN, **kw, dtype=torch.float64).double()
    load_flax(tm, variables)
    state = create_train_state(tm, make_optimizer(1e-3, DROPS))
    step = make_train_step(tm, SMALL["max_disp"])
    named = dict(tm.named_parameters())
    for i, (b, ref) in enumerate(zip(batches, refs)):
        if i:
            before = refs[i - 1]
            load_flax(tm, {"params": before["params"], "batch_stats": before["stats"]})
            with torch.no_grad():
                for src, key in ((before["mu"], "exp_avg"), (before["nu"], "exp_avg_sq")):
                    mapped = from_flax({"params": src, "batch_stats": before["stats"]}, tm.state_dict())
                    for n, m in _moments(state, named, key).items():
                        m.copy_(mapped[n])
        assert state.optimizer.lr_at(state.optimizer.count) == pytest.approx(LRS[i], rel=1e-12)
        state, metrics = step(state, {k: t(v) for k, v in b.items()})
        assert state.step == state.optimizer.count == i + 1
        assert state.optimizer.lr_tensor.item() == pytest.approx(LRS[i], rel=1e-12)
        assert {s["step"].item() for s in state.optimizer.adam.state.values()} == {i + 1.0}

        assert abs(metrics["loss"].item() - ref["loss"]) <= 1e-5 * abs(ref["loss"]), (i, metrics["loss"], ref["loss"])
        sd = tm.state_dict()
        mapped = from_flax({"params": ref["params"], "batch_stats": ref["stats"]}, sd)
        stats = [k for k in sd if k.endswith(("running_mean", "running_var"))]
        assert len(stats) > 20
        for k in stats:
            assert_close_rel(sd[k].numpy(), mapped[k].numpy(), 1e-6)
        for src, key in ((ref["mu"], "exp_avg"), (ref["nu"], "exp_avg_sq")):
            want = from_flax({"params": src, "batch_stats": ref["stats"]}, sd)
            got = _moments(state, named, key)
            top = max(w.abs().max().item() for n, w in want.items() if n in named)
            for n, m in got.items():
                if _is_head_bias(n):
                    assert max(m.abs().max().item(), want[n].abs().max().item()) <= 1e-4 * top, (i, key, n)
                else:
                    try:
                        assert_close_rel(m.numpy(), want[n].numpy(), 1e-4)
                    except AssertionError as e:
                        raise AssertionError(f"step {i + 1} {key} {n}: {e}") from None
        lr = LRS[i]
        diffs = np.concatenate([(p.detach() - mapped[n]).abs().numpy().ravel() for n, p in named.items()])
        assert diffs.max() <= 2 * lr, (i, diffs.max())
        assert (diffs > lr / 1000).sum() <= 20, (i, (diffs > lr / 1000).sum())


def _state(seed: int = 0, drops=DROPS, clip_norm=None, **kw):
    model = build_model(device="cpu", generator=torch.Generator().manual_seed(seed), **SMALL, **kw)
    return create_train_state(model, make_optimizer(1e-3, drops, clip_norm=clip_norm))


def _batch(seed: int = 0, shape=(1, 32, 32)) -> dict[str, torch.Tensor]:
    return to_device(make_batch(seed, shape[0], shape[1], shape[2], 8.0), CPU)


def _key(state, batch=None, model=None) -> tuple:
    b = _batch() if batch is None else batch
    return graphs.train_signature(model or state.model, state.optimizer, (b["left"], b["right"], b["disparity"]))


def test_train_signature_keys_what_a_capture_reads():
    """A pure function of the batch's shapes, dtypes and device, the layout,
    ``remat``, the TF32 flags, ``clip_norm`` and the addresses of the
    parameters, buffers, Adam state and learning-rate tensor; not of the
    batch's values nor of any version, which every step moves."""
    state = _state()
    base = _key(state)
    assert _key(state) == base and _key(state, _batch(seed=5)) == base
    assert _key(state, _batch(shape=(2, 32, 32))) != base
    assert _key(state, _batch(shape=(1, 32, 64))) != base
    wide = {k: v.double() for k, v in _batch().items()}
    assert _key(state, wide) != base

    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(0.0)
        for b in state.model.buffers():
            b.add_(0)
        for x in state.optimizer.tensors():
            x.add_(0)
    assert _key(state) == base
    state.model.load_state_dict(state.model.state_dict())  # copies in place
    assert _key(state) == base

    layout = state.model.agg_layout
    state.model.agg_layout = "grouped"
    assert _key(state)[1] == "grouped" and _key(state) != base
    state.model.agg_layout = layout
    state.model.remat = not state.model.remat
    assert _key(state) != base
    state.model.remat = not state.model.remat
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = not tf32
    try:
        assert _key(state) != base
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert _key(state) == base

    clipped = _state(clip_norm=2.0)
    clipped.model.load_state_dict(state.model.state_dict())
    assert _key(clipped)[4] == 2.0 and _key(clipped)[:4] == base[:4]
    # another model's weights or another optimizer's state: other addresses
    assert _key(clipped) != base and _key(_state(), model=state.model) != base
    old = state.optimizer.adam.state[state.optimizer.params[0]]["exp_avg"]
    state.optimizer.adam.state[state.optimizer.params[0]]["exp_avg"] = old.clone()
    assert _key(state) != base


class FakeGraph:
    """Stands in for a ``torch.cuda.CUDAGraph`` on the CPU: a replay runs no
    kernel (the card tests hold what a replay computes) and records the
    learning rate it would read."""

    def __init__(self, lr: torch.Tensor, seen: list):
        self.lr, self.seen = lr, seen

    def replay(self) -> None:
        self.seen.append(("replay", self.lr.item()))


def fake_capture(g: graphs.GraphedForward, seen: list, lr: torch.Tensor | None = None):
    """``g._capture`` on the CPU: the warm-up (the call's eager result), then
    a :class:`Captured` whose graph is a :class:`FakeGraph`."""

    def capture(key, args):
        out = g.fn(*args)
        seen.append(("capture",))
        g.graphs[key] = graphs.Captured(
            FakeGraph(torch.zeros(()) if lr is None else lr, seen),
            tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args), out,
            launches={}, capture_ms=0.0, pool_bytes=0, held=[], writes=g._writes(args),
        )
        return out

    return capture


def test_bookkeeping_through_a_fake_capture_and_replay(monkeypatch):
    """With the CPU taken for the card: the first call runs eagerly, the
    second warms up and captures, later calls replay. ``step`` and
    ``count`` advance once a call, a capture included; the learning-rate
    tensor holds ``lr_at(count)`` before each call, across the drops at 2
    and 4. After a replay every parameter's, buffer's and Adam tensor's
    version has moved, so an eval ``GraphedForward`` over the same model
    drops its graph, and the replay's metrics are new tensors."""
    monkeypatch.setattr(graphs, "_on_card", lambda x: True)
    state = _state(drops=[(2, 1e-4), (4, 5e-4)])  # optax compounds: 1e-3, 1e-3, 1e-4, 1e-4, 5e-5
    step = make_train_step(state.model, SMALL["max_disp"])
    seen = []
    g = step.graphed
    g.fn = (lambda fn: lambda st, *a: seen.append(("step", st.optimizer.lr_tensor.item())) or fn(st, *a))(g.fn)
    monkeypatch.setattr(g, "_capture", fake_capture(g, seen, state.optimizer.lr_tensor))
    evaluate = make_eval_step(state.model, SMALL["max_disp"])
    monkeypatch.setattr(evaluate.graphed, "_capture", fake_capture(evaluate.graphed, []))
    batch = _batch()

    lrs = []
    for i in range(5):
        lrs.append(state.optimizer.lr_at(state.optimizer.count))
        versions = [x._version for x in graphs._weights(state.model) + state.optimizer.tensors()]
        _, metrics = step(state, batch)
        assert state.step == state.optimizer.count == i + 1
        if i == 2:  # the first replay: then an eval graph, captured between replays
            assert all(x._version > v for x, v in zip(graphs._weights(state.model) + state.optimizer.tensors(),
                                                       versions))
            (captured,) = g.graphs.values()
            assert all(m is not o and torch.equal(m, o) for m, o in zip(metrics.values(), captured.outputs.values()))
            for _ in range(2):
                evaluate(state, batch)
            assert len(evaluate.graphed.graphs) == 1
    assert lrs == pytest.approx([1e-3, 1e-3, 1e-4, 1e-4, 5e-5], rel=1e-12)
    assert [s[0] for s in seen] == ["step", "step", "capture", "replay", "replay", "replay"]
    assert [s[1] for s in seen if len(s) > 1] == lrs
    # steps 4 and 5 replayed after the eval graph's capture: its stamp moved
    assert g.graphs[next(iter(g.graphs))].replays == 3
    evaluate(state, batch)
    assert not evaluate.graphed.graphs and len(evaluate.graphed.seen) == 1


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


def test_no_graph_on_cpu_under_a_mesh_or_in_anomaly_mode(monkeypatch):
    """CPU tensors, a step under a mesh (DDP over a gloo group of one) and
    anomaly mode each run every step eagerly: nothing builds, captures or
    replays a graph, and nothing is remembered."""

    def no_graph(*_, **__):
        raise AssertionError("a CUDA graph")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", no_graph)
    monkeypatch.setattr(torch.cuda, "graph", no_graph)
    state, batch = _state(), _batch()
    step = make_train_step(state.model, SMALL["max_disp"])
    for _ in range(3):
        step(state, batch)
    assert not step.graphed.graphs and not step.graphed.seen and state.step == 3

    monkeypatch.setattr(graphs, "_on_card", lambda x: True)  # the card, but anomaly mode
    with torch.autograd.detect_anomaly():
        for _ in range(3):
            step(state, batch)
    assert not step.graphed.graphs and not step.graphed.seen and state.step == 6
    with _gloo_world_of_one() as mesh:
        meshed = make_train_step(state.model, SMALL["max_disp"], mesh)
        assert meshed.graphed is None
        for _ in range(3):
            _, metrics = meshed(state, batch)
    assert state.step == 9 and torch.isfinite(metrics["loss"])
    assert make_train_step(state.model, SMALL["max_disp"], graphed=False).graphed is None


def _adam_view(state) -> list:
    return [(i, k, v.clone()) for i, p in enumerate(state.optimizer.params)
            for k, v in sorted(state.optimizer.adam.state[p].items())]


def test_checkpoint_round_trip(tmp_path):
    """A saved state is written in one form whatever device ran it: host step
    counts, a float learning rate, ``capturable`` off (the form of the files
    the port wrote before its train step was captured); ``count`` and
    ``step`` Python ints. It restores into a fresh state that then steps as
    the saved one does, bit for bit, and the learning-rate tensor keeps its
    address while the Adam tensors move (a captured step is captured
    again). A file written by torch's Adam with a float learning rate and
    its state made at the first step (the port before captured steps)
    restores, and so does one with no Adam state yet and one in the
    capturable form (a tensor learning rate, ``capturable`` on)."""
    batches = [_batch(s) for s in range(3)]
    run = _state()
    step = make_train_step(run.model, SMALL["max_disp"])
    for b in batches[:2]:
        step(run, b)
    manager = ckpt_lib.make_manager(str(tmp_path / "a"))
    ckpt_lib.save(manager, 2, run)
    saved_adam = _adam_view(run)
    blob = torch.load(manager.path(2), weights_only=True)
    assert type(blob["count"]) is int and type(blob["step"]) is int and blob["count"] == blob["step"] == 2
    for g in blob["adam"]["param_groups"]:
        assert type(g["lr"]) is float and g["lr"] == 1e-3 and g["capturable"] is False
    assert all(s["step"].device == CPU and s["step"].dtype == torch.float32 for s in blob["adam"]["state"].values())

    fresh = _state(seed=1)
    lr_ptr = fresh.optimizer.lr_tensor.data_ptr()
    before = _key(fresh)
    fresh, step0 = ckpt_lib.restore_latest(manager, fresh)
    assert step0 == fresh.step == fresh.optimizer.count == 2
    assert fresh.optimizer.lr_tensor.data_ptr() == lr_ptr and _key(fresh) != before
    assert _same_adam(_adam_view(fresh), saved_adam)
    _, want = step(run, batches[2])
    _, got = make_train_step(fresh.model, SMALL["max_disp"])(fresh, batches[2])
    assert got["loss"].item() == want["loss"].item()
    _assert_same_model(fresh, run, "round trip")
    assert fresh.optimizer.lr_tensor.item() == run.optimizer.lr_tensor.item() == pytest.approx(1e-4, rel=1e-12)

    # the form before captured steps: torch's Adam with a float lr, its
    # state made at its first step, stepped in that Optimizer.step's order
    plain_model = _state().model
    plain = torch.optim.Adam(list(plain_model.parameters()), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    blobs = {"empty": {"model": plain_model.state_dict(), "adam": plain.state_dict(), "count": 0, "step": 0}}
    assert not blobs["empty"]["adam"]["state"]
    _write(tmp_path / "empty", blobs["empty"])
    plain_model.train()
    for i, b in enumerate(batches[:2]):
        plain.zero_grad(set_to_none=True)
        stereo_loss(plain_model(b["left"], b["right"]), b["disparity"], SMALL["max_disp"]).backward()
        for group in plain.param_groups:
            group["lr"] = run.optimizer.lr_at(i)
        plain.step()
    blobs["float_lr"] = {"model": plain_model.state_dict(), "adam": plain.state_dict(), "count": 2, "step": 2}
    blobs["capturable"] = {**blobs["float_lr"], "adam": {**blobs["float_lr"]["adam"], "param_groups": [
        dict(g, lr=torch.tensor(g["lr"]), capturable=True) for g in blobs["float_lr"]["adam"]["param_groups"]]}}
    for name in ("float_lr", "capturable"):
        _write(tmp_path / name, blobs[name])
    for name in blobs:
        restored, _ = ckpt_lib.restore_latest(ckpt_lib.make_manager(str(tmp_path / name)), _state(seed=2))
        opt = restored.optimizer
        assert opt.adam.param_groups[0]["capturable"] is False and opt.lr_tensor.dtype == torch.float64
        assert len(opt.tensors()) == 1 + 3 * len(opt.params), name
        if name == "empty":
            assert all(torch.count_nonzero(x) == 0 for x in opt.tensors()[1:])
            continue
        assert _same_adam(_adam_view(restored), saved_adam), name
        _, got = make_train_step(restored.model, SMALL["max_disp"])(restored, batches[2])
        assert got["loss"].item() == want["loss"].item(), name
        _assert_same_model(restored, run, name)


def _write(directory, blob: dict) -> None:
    directory.mkdir()
    torch.save(blob, directory / f"{blob['step']}.pt")


def _same_adam(a: list, b: list) -> bool:
    return [x[:2] for x in a] == [x[:2] for x in b] and all(torch.equal(x[2], y[2]) for x, y in zip(a, b))


def _assert_same_model(a, b, what: str) -> None:
    for (name, p), q in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(p, q), (what, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_a_train_capture_packs_inside_the_graph(dtype):
    """Inside ``cuda_gband.uncached`` (what ``GraphedTrainStep`` captures
    under) ``cached_pack`` packs on every call and leaves the cache as it
    was, for the conv's weight in f32 (``weight.to(x.dtype)`` is the
    parameter itself, whose cached pack a graph would replay stale) and in
    bf16 (a new cast each step); outside, a second call is a hit."""
    param = torch.nn.Parameter(torch.randn(4, 4, 3, 3, 3))
    weight = param.to(dtype)
    assert (weight is param) == (dtype == torch.float32)
    made = []

    def make():
        made.append(1)
        return weight * 2

    first = cuda_gband.cached_pack(weight, "test", make)
    assert cuda_gband.cached_pack(weight, "test", make) is first and len(made) == 1
    with graphs.GraphedTrainStep(None, torch.nn.Linear(1, 1))._capturing():
        inside = [cuda_gband.cached_pack(weight, "test", make) for _ in range(2)]
    assert len(made) == 3 and all(p is not first for p in inside) and inside[0] is not inside[1]
    assert cuda_gband.cached_pack(weight, "test", make) is first and len(made) == 3
    with graphs.GraphedForward(None, torch.nn.Linear(1, 1))._capturing():  # an eval capture reads the cache
        assert cuda_gband.cached_pack(weight, "test", make) is first


def test_a_capture_sets_the_launch_counts_back():
    """``launches.set_counts`` puts back what ``read_counts`` read (a capture
    launches nothing: the wrappers' counts during it are a replay's)."""
    launches.reset_counts()
    before = launches.read_counts()
    cuda_gband.gband_conv_s1.launches += 7
    cuda_gband.gband_conv_s1.backward_launches += 7
    assert launches.read_counts() != before
    launches.set_counts(before)
    assert launches.read_counts() == before == dict.fromkeys(launches.COUNTERS, 0)
