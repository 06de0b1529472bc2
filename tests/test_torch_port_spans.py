"""The port's spans (``ecm_torch/utils/profiling.span``) and the benchmark's
readers of them (``stereo_bench/spans.py``, ``stereo_bench/metrics/``).

With no profiler on, a span enters no ``record_function``. Under
``torch.profiler`` the graph wrapper, the train step and ``to_device`` open
the ``ecm.*`` spans, nested as ``train/graphs.py`` says. Every span a
reader reads is one the port opens, and the readers' arithmetic holds on
windows built by hand and against a count at every microsecond.
"""

from __future__ import annotations

import ast
import random
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile

from ecm_torch.train import graphs
from ecm_torch.train.loop import to_device
from ecm_torch.train.steps import make_train_step
from ecm_torch.utils import profiling
from stereo_bench import harness, spans, trace
from test_torch_port_train_graphs import SMALL, _batch, _state, fake_capture
from test_torch_port_util import torch_threads

ROOT = Path(__file__).resolve().parents[1]
READERS = ["graph_host_ms_per_pair.b1", "graph_host_ms_per_step.train", "program_idle_pct.b1",
           "program_idle_pct.train"]
CALL = ["ecm.graph.call", "ecm.graph.signature"]
REPLAY = [*CALL, "ecm.graph.copy_in", "ecm.graph.replay", "ecm.graph.copy_out"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    with torch_threads(1):
        yield


def emitted() -> set[str]:
    """The names of every span the port opens: the constant first argument
    of each call of ``span`` in ``ecm_torch/``."""
    names = set()
    for path in (ROOT / "ecm_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if (isinstance(node, ast.Call) and "span" in (getattr(node.func, "id", None), getattr(node.func, "attr", None))
                    and node.args and isinstance(node.args[0], ast.Constant)):
                names.add(node.args[0].value)
    return names


def ecm_spans(prof) -> list[tuple[str, str | None]]:
    """The ``ecm.*`` spans of a profile in the order they opened, each with
    the ``ecm.*`` span that encloses it on its thread (None at the top)."""
    out = []
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if e.name.startswith(spans.PROGRAM):
            parent = e.cpu_parent
            while parent is not None and not parent.name.startswith(spans.PROGRAM):
                parent = parent.cpu_parent
            out.append((e.name, None if parent is None else parent.name))
    return out


def nested(names: list[str]) -> list[tuple[str, str | None]]:
    """``names[0]`` at the top and the rest inside it, in order."""
    return [(names[0], None)] + [(n, names[0]) for n in names[1:]]


def _no_record_function(monkeypatch):
    def refuse(*_, **__):
        raise AssertionError("a record_function was entered with no profiler on")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)


def _eager_forward() -> graphs.GraphedForward:
    model = nn.Linear(3, 2)
    return graphs.GraphedForward(lambda x: model(x) * 2, model)


def test_no_record_function_with_the_profiler_off(monkeypatch):
    """With no profiler on, ``span`` hands out one shared context and enters
    no ``record_function``: not alone, not in the wrapper's eager call, not
    in ``to_device``."""
    _no_record_function(monkeypatch)
    assert profiling.span("ecm.a") is profiling.span("ecm.b")
    with profiling.span("ecm.a"):
        pass
    out = _eager_forward()(torch.ones(4, 3))
    assert out.shape == (4, 2)
    batch = to_device({k: np.zeros((1, 4, 4, 3)) for k in ("left", "right", "disparity")}, torch.device("cpu"))
    assert batch["left"].dtype == torch.float32


def test_an_eager_call_spans_its_signature_and_the_call():
    """On CPU tensors: ``ecm.graph.call`` holding ``ecm.graph.signature``
    and then ``ecm.graph.eager``."""
    forward = _eager_forward()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        forward(torch.ones(4, 3))
    assert ecm_spans(prof) == nested(CALL + ["ecm.graph.eager"])


def test_train_steps_span_each_path_in_order(monkeypatch):
    """Through the fake capture and replay of the train-graph tests: the
    first step's call is eager, the second's captures, the third's replays,
    each inside its ``ecm.train.step``; a replay's parts open in order. A
    replay with no profiler on enters no ``record_function``."""
    monkeypatch.setattr(graphs, "_on_card", lambda x: True)
    state = _state()
    step = make_train_step(state.model, SMALL["max_disp"])
    monkeypatch.setattr(step.graphed, "_capture", fake_capture(step.graphed, [], state.optimizer.lr_tensor))
    batch = _batch()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            step(state, batch)
    per_step = [("ecm.train.step", None)]
    expected = []
    for last in (["ecm.graph.eager"], ["ecm.graph.capture"], REPLAY[2:]):
        call = nested(CALL + last)
        expected += per_step + [(call[0][0], "ecm.train.step")] + call[1:]
    assert ecm_spans(prof) == expected
    (captured,) = step.graphed.graphs.values()
    assert captured.replays == 1 and step.graphed.late_checks == 0

    _no_record_function(monkeypatch)
    step(state, batch)
    assert captured.replays == 2 and state.step == 4


def test_forwards_span_each_path_in_order(monkeypatch):
    """Through the fake capture and replay of the train-graph tests: a
    forward's first call reads its key, then its weights stamp, then runs
    eagerly; the second reads both, then captures; the third reads its key,
    copies in, launches, reads the stamp while the card runs the replay,
    then clones. After a weight is replaced by a new tensor the replay is
    followed by the stamp and, for the moved stamp, the eager call."""
    monkeypatch.setattr(graphs, "_on_card", lambda x: True)
    forward = _eager_forward()
    monkeypatch.setattr(forward, "_capture", fake_capture(forward, []))
    x = torch.ones(4, 3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            forward(x)
        forward.model.weight = nn.Parameter(forward.model.weight.detach() + 1.0)
        forward(x)
    replayed = ["ecm.graph.copy_in", "ecm.graph.replay", "ecm.graph.stamp"]
    expected = []
    for rest in (["ecm.graph.stamp", "ecm.graph.eager"], ["ecm.graph.stamp", "ecm.graph.capture"],
                 replayed + ["ecm.graph.copy_out"], replayed + ["ecm.graph.eager"]):
        expected += nested(CALL + rest)
    assert ecm_spans(prof) == expected
    assert forward.late_checks == 2 and forward.discards == 1


def test_to_device_spans_the_copies():
    batch = {k: np.zeros((1, 4, 4, 3)) for k in ("left", "right", "disparity")}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        to_device(batch, torch.device("cpu"))
    assert ecm_spans(prof) == [("ecm.loop.to_device", None)]


def test_the_port_opens_spans_only_through_span():
    """No module of the port but ``utils/profiling.py`` names
    ``record_function``; every span it opens is in the program's
    namespace."""
    for path in (ROOT / "ecm_torch").rglob("*.py"):
        if path != ROOT / "ecm_torch" / "utils" / "profiling.py":
            assert "record_function" not in path.read_text(), path
    assert emitted() == {
        "ecm.train.step", "ecm.loop.to_device", "ecm.graph.call", "ecm.graph.signature", "ecm.graph.eager",
        "ecm.graph.capture", "ecm.graph.copy_in", "ecm.graph.replay", "ecm.graph.copy_out",
        "ecm.graph.stamp", "ecm.raft.encode", "ecm.raft.volume", "ecm.raft.update", "ecm.raft.upsample"}


@pytest.mark.parametrize("name", READERS)
def test_readers_read_spans_the_port_opens(name):
    """The drift guard: each name a reader reads is a span the port opens,
    or (ending in a dot) the namespace of every span it opens."""
    reader = harness.metric_reader(name)
    (entry,) = [m for m in harness.manifest()["per_layer"] if m["name"] == name]
    assert reader.UNIT == entry["unit"] and reader.SPANS
    names = emitted()
    for read in reader.SPANS:
        if read.endswith("."):
            assert all(n.startswith(read) for n in names), read
        else:
            assert read in names, read
    assert reader.read([window([], [(0, 10)], pairs=1, steps=1)]) is None  # a program without spans


def window(host, device, wall_us: float = 1000.0, **work) -> dict:
    """A traced window as ``trace.profile`` returns it: ``host`` holds
    ``(name, start, end)`` annotations or ``(name, start, end, cat)``,
    ``device`` ``(start, end)`` kernels."""
    return {"t0": 0.0, "t1": wall_us, "wall_s": wall_us / 1e6,
            "host": [e if len(e) == 4 else (*e, spans.ANNOTATION) for e in host],
            "device": [("k", a, b, "kernel") for a, b in device], **work}


# (host spans, device intervals, share of the 1000 us wall idle inside the spans)
IDLE_CASES = {
    # a call holding its signature and its replay; a copy overlapping a kernel
    "nested": ([("ecm.graph.call", 100, 500), ("ecm.graph.signature", 110, 200), ("ecm.graph.replay", 300, 350)],
               [(0, 150), (140, 250), (400, 450)], 20.0),
    # the batch's copies and the step overlap, neither holding the other
    "overlapping": ([("ecm.loop.to_device", 0, 300), ("ecm.train.step", 200, 600)], [(250, 700)], 25.0),
    "device_elsewhere": ([("ecm.train.step", 0, 100)], [(500, 600)], 10.0),
    "device_throughout": ([("ecm.graph.call", 200, 300)], [(100, 900)], 0.0),
    # the benchmark's and torch's annotations and a host op are not the program's spans
    "others_left_out": ([("ecm.graph.call", 0, 100), ("stereo_bench.window", 0, 1000),
                         ("Optimizer.step#Adam.step", 100, 900), ("ecm.graph.copy_out", 100, 800, "cpu_op")],
                        [(950, 960)], 10.0),
}


@pytest.mark.parametrize("case", IDLE_CASES)
def test_program_idle_on_built_windows(case):
    host, device, pct = IDLE_CASES[case]
    w = window(host, device)
    assert spans.program_idle_pct([w]) == pytest.approx(pct, abs=1e-9)
    assert spans.program_idle_pct([w]) <= trace.idle_pct([w]) + 1e-9


def test_program_idle_averages_windows_that_hold_spans_and_device_work():
    nested_, elsewhere = (window(*IDLE_CASES[c][:2]) for c in ("nested", "device_elsewhere"))
    no_device = window([("ecm.graph.call", 0, 500)], [])
    no_span = window([("aten::copy_", 0, 500, "cpu_op")], [(0, 10)])
    assert spans.program_idle_pct([nested_, elsewhere, no_device, no_span]) == pytest.approx(15.0)
    assert spans.program_idle_pct([no_device, no_span]) is None


def test_span_ms_sums_a_name_per_unit_of_work():
    """The summed spans of one name over the window's pairs or steps; a
    host op or another span of the same window is not counted, and a window
    without the span or the work is left out of the mean."""
    w = window([("ecm.graph.call", 100, 500), ("ecm.graph.call", 600, 700), ("ecm.graph.signature", 100, 200),
                ("ecm.graph.call", 0, 900, "cpu_op")], [], pairs=2, steps=4)
    other = window([("ecm.graph.call", 0, 100)], [], pairs=1)
    assert spans.span_ms([w], "ecm.graph.call", "pairs") == pytest.approx(0.25)
    assert spans.span_ms([w], "ecm.graph.call", "steps") == pytest.approx(0.125)
    assert spans.span_ms([w, other], "ecm.graph.call", "pairs") == pytest.approx((0.25 + 0.1) / 2)
    assert spans.span_ms([w, other], "ecm.graph.call", "steps") == pytest.approx(0.125)
    assert spans.span_ms([w], "ecm.train.step", "pairs") is None


@pytest.mark.parametrize("seed", range(4))
def test_program_idle_against_a_count_at_every_microsecond(seed):
    """Random integer intervals, many nested or overlapping: the reader's
    idle time inside the spans equals the microseconds at which some
    program span is open and no device interval is."""
    rng = random.Random(seed)
    names = ["ecm.graph.call", "ecm.graph.replay", "ecm.train.step", "Optimizer.step", "aten::copy_"]

    def interval(longest: int) -> tuple[int, int]:
        a = rng.randrange(1000)
        return a, min(1000, a + rng.randrange(1, longest))

    host = [(rng.choice(names), *interval(200), rng.choice([spans.ANNOTATION, "cpu_op"])) for _ in range(25)]
    device = [interval(80) for _ in range(30)]
    in_span, busy = np.zeros(1000, bool), np.zeros(1000, bool)
    for name, a, b, cat in host:
        if name.startswith("ecm.") and cat == spans.ANNOTATION:
            in_span[a:b] = True
    for a, b in device:
        busy[a:b] = True
    w = window(host, device)
    assert spans.program_idle_pct([w]) == pytest.approx((in_span & ~busy).sum() / 10.0, abs=1e-9)
    assert trace.idle_pct([w]) == pytest.approx((~busy).sum() / 10.0, abs=1e-9)
