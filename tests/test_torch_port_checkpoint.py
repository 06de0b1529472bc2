"""The port's checkpoints (``ecm_torch.train.checkpoint``), the loop's
periodic and final saves, and the metric writer, on the CPU.

A run saved at step k and restored into a fresh state takes its next step
exactly as an uninterrupted run does: the same loss, parameters, Adam
moments and schedule count, bit for bit (``torch.save`` keeps every tensor
as it is, and the CPU kernels are deterministic)."""

import json
import os

import numpy as np
import pytest
import torch

from ecm_torch.data import make_batch
from ecm_torch.models import build_model
from ecm_torch.train import checkpoint as ckpt_lib
from ecm_torch.train.loop import to_device, train_loop
from ecm_torch.train.state import create_train_state, make_optimizer
from ecm_torch.train.steps import make_train_step
from ecm_torch.train.writers import MetricWriter
from test_torch_port_util import torch_threads

SMALL = dict(max_disp=16, feature_channels=8)
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    with torch_threads(1):
        yield


def small_state(seed: int):
    model = build_model(device="cpu", generator=torch.Generator().manual_seed(seed), **SMALL)
    # the drops compound (optax's scales): 1e-3, then 1e-4 at count 1 and 5e-5
    # at count 2, so a resumed optimizer that lost its count would take
    # another learning rate at the resumed step
    return create_train_state(model, make_optimizer(1e-3, [(1, 1e-4), (2, 5e-4)]))


def adam_moments(state) -> list[torch.Tensor]:
    return [v for s in state.optimizer.adam.state.values() for k, v in sorted(s.items())]


def test_resume_is_bit_for_bit(tmp_path):
    batches = [to_device(make_batch(s, 1, 32, 32, 8.0), CPU) for s in range(3)]
    whole = small_state(0)
    step = make_train_step(whole.model, 16)
    for b in batches[:2]:
        step(whole, b)
    _, want = step(whole, batches[2])

    first = small_state(0)
    step = make_train_step(first.model, 16)
    for b in batches[:2]:
        step(first, b)
    manager = ckpt_lib.make_manager(str(tmp_path / "ck"))
    ckpt_lib.save(manager, 2, first)
    resumed, step0 = ckpt_lib.restore_latest(manager, small_state(1))
    assert step0 == resumed.step == 2 and resumed.optimizer.count == 2
    assert resumed.optimizer.lr_at(resumed.optimizer.count) == pytest.approx(5e-5)
    _, got = make_train_step(resumed.model, 16)(resumed, batches[2])

    assert got["loss"].item() == want["loss"].item()
    for (name, p), q in zip(whole.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(p, q), name
    moments, want_moments = adam_moments(resumed), adam_moments(whole)
    assert len(moments) == len(want_moments) > 0
    assert all(torch.equal(a, b) for a, b in zip(moments, want_moments))


def test_keeps_newest_and_ignores_temporary_files(tmp_path):
    state = create_train_state(torch.nn.Linear(2, 2))
    manager = ckpt_lib.make_manager(str(tmp_path), keep=5)
    template, step0 = ckpt_lib.restore_latest(manager, state)
    assert step0 == 0 and template is state
    for s in range(1, 8):
        state.step = s
        ckpt_lib.save(manager, s, state)
    assert manager.all_steps() == [3, 4, 5, 6, 7]
    (tmp_path / "9.pt.tmp123").write_bytes(b"a save cut short")
    assert manager.latest_step() == 7
    fresh = create_train_state(torch.nn.Linear(2, 2))
    restored, step0 = ckpt_lib.restore_latest(manager, fresh)
    assert step0 == restored.step == 7
    assert torch.equal(restored.model.weight, state.model.weight)


def _counting_step(state, batch):
    state.step += 1
    zero = torch.zeros(())
    return state, {"loss": zero, "epe": zero, "d1_all": zero}


def _batches():
    b = {k: np.zeros((1, 4, 4, 3) if k != "disparity" else (1, 4, 4), np.float32)
         for k in ("left", "right", "disparity")}
    while True:
        yield b


def test_train_loop_saves_every_and_at_the_end_once(tmp_path, monkeypatch):
    saved = []
    save = ckpt_lib.save
    monkeypatch.setattr(ckpt_lib, "save", lambda m, s, st: (saved.append(s), save(m, s, st)))
    manager = ckpt_lib.make_manager(str(tmp_path / "ck"))
    state = create_train_state(torch.nn.Linear(2, 2))
    train_loop(state, _counting_step, _batches(), 5, log_every=10, ckpt_manager=manager, ckpt_every=2)
    assert manager.all_steps() == [2, 4, 5] and saved == [2, 4, 5]
    train_loop(state, _counting_step, _batches(), 6, log_every=10, ckpt_manager=manager, ckpt_every=3)
    assert saved == [2, 4, 5, 6]  # step 6 is both a multiple of 3 and the end: one save
    state, step0 = ckpt_lib.restore_latest(manager, create_train_state(torch.nn.Linear(2, 2)))
    train_loop(state, _counting_step, _batches(), 6, log_every=10, ckpt_manager=manager)
    assert step0 == 6 and saved == [2, 4, 5, 6]  # resumed at the end: nothing new to save


def test_metric_writer(tmp_path):
    writer = MetricWriter(logdir=str(tmp_path / "tb"), jsonl_path=str(tmp_path / "m.jsonl"))
    writer.write(1, {"loss": torch.tensor(2.5), "epe": 1.0})
    writer.write(2, {"loss": 1.5, "epe": np.float32(0.5)})
    writer.close()
    lines = [json.loads(s) for s in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert lines == [{"step": 1, "loss": 2.5, "epe": 1.0}, {"step": 2, "loss": 1.5, "epe": 0.5}]
    try:
        import torch.utils.tensorboard as _  # noqa: F401
    except ImportError:
        assert not (tmp_path / "tb").exists()
    else:
        assert any(n.startswith("events.out.tfevents") for n in os.listdir(tmp_path / "tb"))

    state = create_train_state(torch.nn.Linear(2, 2))
    train_loop(state, _counting_step, _batches(), 2, log_every=1, tensorboard_dir=str(tmp_path / "tb2"),
               metrics_path=str(tmp_path / "loop.jsonl"))
    assert [json.loads(s)["step"] for s in (tmp_path / "loop.jsonl").read_text().splitlines()] == [1, 2]


def test_restore_onto_the_template_device(tmp_path):
    """The checkpoint loads onto the template's device (here the CPU), and
    an optimizer built over other parameters refuses it."""
    manager = ckpt_lib.make_manager(str(tmp_path))
    ckpt_lib.save(manager, 1, create_train_state(torch.nn.Linear(2, 2)))
    state, _ = ckpt_lib.restore_latest(manager, create_train_state(torch.nn.Linear(2, 2)))
    assert state.model.weight.device == CPU
    with pytest.raises(RuntimeError):
        ckpt_lib.restore_latest(manager, create_train_state(torch.nn.Linear(3, 2)))
