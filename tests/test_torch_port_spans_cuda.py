"""The port's spans on the card: a replay's graph launch falls inside its
``ecm.graph.replay`` span, its kernels start after the span opened (the
spans and the device's records share one clock), a forward's weights stamp
is read while the card runs the replay, and a span costs under a
microsecond with no profiler on.

Marked ``cuda``: skipped without a GPU. The machine with the card has no
JAX, so run these there without the JAX test setup:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_spans_cuda.py``.
"""

import json
import time

import pytest
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile

from ecm_torch.train.graphs import GraphedForward
from ecm_torch.utils.profiling import span

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_a_replay_launches_inside_its_span(dev, tmp_path):
    """The third call of a small graphed forward replays: its
    ``cudaGraphLaunch`` lies inside ``ecm.graph.replay``, and the kernels of
    that launch start no earlier than the span."""
    model = nn.Sequential(nn.Linear(64, 256), nn.ReLU(), nn.Linear(256, 8)).to(dev)

    @torch.inference_mode()
    def forward(x):
        return model(x) * 2

    graphed = GraphedForward(forward, model)
    x = torch.randn(32, 64, device=dev)
    graphed(x)  # eager
    graphed(x)  # warm-up and capture
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = graphed(x)
        torch.cuda.synchronize(dev)
    (captured,) = graphed.graphs.values()
    assert captured.replays == 1
    torch.testing.assert_close(out, forward(x))

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    (replay,) = [e for e in events if e["name"] == "ecm.graph.replay" and e.get("cat") == "user_annotation"]
    start, end = float(replay["ts"]), float(replay["ts"]) + float(replay["dur"])
    launch = [e for e in events if e.get("cat") == "cuda_runtime" and e["name"].startswith("cudaGraphLaunch")]
    assert len(launch) == 1, [e["name"] for e in events if e.get("cat") == "cuda_runtime"]
    (launch,) = launch
    assert start <= float(launch["ts"]) and float(launch["ts"]) + float(launch["dur"]) <= end
    kernels = [e for e in events if e.get("cat") == "kernel"
               and e.get("args", {}).get("correlation") == launch["args"]["correlation"]]
    assert kernels, "no kernel of the graph's launch in the trace"
    assert min(float(k["ts"]) for k in kernels) >= start


def test_a_forward_reads_its_stamp_while_the_card_runs_the_replay(dev, tmp_path):
    """A replay of a forward of 48 wide layers (tens of milliseconds of
    kernels in float32): its ``ecm.graph.stamp`` opens after ``cudaGraphLaunch``
    returned and while a kernel of that launch runs, and its result equals
    the eager forward."""
    model = nn.Sequential(*[nn.Linear(2048, 2048) for _ in range(48)]).to(dev)

    @torch.inference_mode()
    def forward(x):
        return model(x)

    graphed = GraphedForward(forward, model)
    x = torch.randn(4096, 2048, device=dev)
    graphed(x)  # eager
    graphed(x)  # warm-up and capture
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = graphed(x)
        torch.cuda.synchronize(dev)
    assert graphed.late_checks == 1 and graphed.discards == 0
    assert torch.equal(out, forward(x))

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    (stamp,) = [e for e in events if e["name"] == "ecm.graph.stamp" and e.get("cat") == "user_annotation"]
    start, end = float(stamp["ts"]), float(stamp["ts"]) + float(stamp["dur"])
    (launch,) = [e for e in events if e.get("cat") == "cuda_runtime" and e["name"].startswith("cudaGraphLaunch")]
    assert float(launch["ts"]) + float(launch["dur"]) <= start
    kernels = [(float(k["ts"]), float(k["ts"]) + float(k["dur"])) for k in events if k.get("cat") == "kernel"
               and k.get("args", {}).get("correlation") == launch["args"]["correlation"]]
    assert len(kernels) >= 48, len(kernels)
    assert any(a < end and b > start for a, b in kernels), (start, end, min(kernels), max(kernels))


def test_a_span_costs_under_a_microsecond_with_the_profiler_off(dev):
    """10^4 enters and exits, the least mean of 5 such rounds (the host's
    other work only adds to a round)."""
    assert not torch._C._autograd._profiler_enabled()
    n, means = 10_000, []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            with span("ecm.graph.call"):
                pass
        means.append((time.perf_counter() - t0) / n)
    assert min(means) < 1e-6, means
