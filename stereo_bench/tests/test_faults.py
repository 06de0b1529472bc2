"""A run with the card's look skipped, on the CPU at a tiny size: sound, it
comes out correct; with the timed path broken underneath, once for each
fault the cell can have, ``correct`` comes out false."""

from __future__ import annotations

import time

import pytest
import torch

from stereo_bench import calibrate, run
from stereo_bench.tests.tiny import tiny

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def measure(spec, traced=False):
    return run.measure(spec, 4_294_967_311, 1.0, traced, CPU, time.perf_counter())


@pytest.mark.parametrize("name, traced", [("kitti_b1", False), ("kitti_b1", True), ("sceneflow_train", False),
                                          ("sceneflow_train", True)])
def test_sound_run_is_correct(name, traced):
    line = measure(tiny(name), traced)
    assert line["correct"], line["checked"]
    assert list(line)[-1] == "checked" and line["attempted"] > 0 and line["failed"] == 0
    assert all(c["value"] <= c["limit"] for c in line["checked"].values())
    if traced:
        assert any(k.startswith("mfu.") for k in line["metrics"])
    else:
        assert "setup_s" in line["metrics"]


def test_answer_altered(monkeypatch):
    """Every answer mirrored left to right where it is produced (a layout
    fault)."""
    from ecm_torch.train import steps

    make = steps.make_infer_fn
    monkeypatch.setattr(steps, "make_infer_fn", lambda model: (lambda l, r, f=make(model): f(l, r).flip(-1)))
    assert not measure(tiny("kitti_b1"))["correct"]


def test_state_unchanged(monkeypatch):
    """A step that computes the gradients and returns the state unchanged."""
    from ecm_torch.train.state import Optimizer

    monkeypatch.setattr(Optimizer, "update", lambda self: None)
    line = measure(tiny("sceneflow_train"))
    assert not line["correct"]
    assert line["checked"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch(monkeypatch):
    """Each step on the first half of its rows, the mean over those."""
    from ecm_torch.train import steps

    make = steps.make_train_step

    def halved(*args, **kwargs):
        step = make(*args, **kwargs)
        return lambda state, batch: step(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})

    monkeypatch.setattr(steps, "make_train_step", halved)
    assert not measure(tiny("sceneflow_train"))["correct"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_serving_control_fails(seed):
    """The float8 control in the program's place fails a serving limit, at
    128x256, max-disp 192 (at 64x128 its gaps are within them)."""
    spec = tiny("kitti_b1")
    spec["config"]["shapes"].update(height=128, width=256, max_disp=192)
    spec["mix"].update(checked_requests=1)
    numbers = calibrate.serve_control(spec, seed, CPU)["control"]
    assert any(numbers[k] > limit for k, limit in spec["config"]["limits"].items()), numbers


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_training_control_fails(seed):
    """The float8 control's first steps fail a training limit."""
    spec = tiny("sceneflow_train")
    numbers = calibrate.train_control(spec, seed, CPU)["control"]
    assert any(numbers[k] > limit for k, limit in spec["config"]["limits"].items()), numbers
