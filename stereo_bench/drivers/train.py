"""Training, closed loop: one step after another, as ``train_loop`` runs them.

Each step takes the next batch of a pool of distinct batches made from the
seed and held in host memory, moves it with ``train/loop.py``'s
``to_device`` (pageable copies, as the train CLI does) and runs the
program's ``make_train_step`` (one CUDA-graph replay a step after the
second); the loss is read every ``log_every`` steps, as the loop logs it.
Set-up builds the one train state, drives it through the first three steps
(eager, captured, replayed) on the pool's first three batches and keeps
what the comparison needs: each step's loss, the first gradient as Adam got
it, the parameters after the third step. The window then runs the same
object for ``seconds`` (or, traced, a fixed count of steps), and once it
has closed and the program is freed, the float32 reference takes the same
three steps from the same weights and batches. As the serving driver, it
names no model: the configuration's family (``families/``) gives it.
"""

from __future__ import annotations

import gc
import sys
import time

import torch

from stereo_bench import compare, harness, synth, trace
from stereo_bench import weights as W
from stereo_bench.families import family

CHECKED_STEPS = 3


def host_pool(cfg: dict, mix: dict, seed: int, device: torch.device) -> list[dict]:
    """The pool of batches as host numpy arrays (what a reader hands
    ``to_device``)."""
    h, w = cfg["shapes"]["height"], cfg["shapes"]["width"]
    pool = synth.make_pool(seed + 1, mix["pool"], cfg["shapes"]["batch"], h, w, *mix["disparity_range"], device)
    return [{k: v.numpy() for k, v in b.items()} for b in pool]


def work(cfg: dict, steps: int) -> dict:
    fam = family(cfg)
    return {"steps": steps, "pairs": steps * cfg["shapes"]["batch"], "port_kernels": fam.KERNELS,
            **{k: steps * v for k, v in fam.train_work(cfg).items()}}


def setup_state(cfg: dict, params: dict, device: torch.device):
    """The program's model on ``params``, its train state and step."""
    from ecm_torch.train import steps
    from ecm_torch.train.state import create_train_state, make_optimizer

    model = family(cfg).build(cfg, device)
    model.load_state_dict(params)
    state = create_train_state(model, make_optimizer(cfg["train"]["lr"]))
    return model, state, steps.make_train_step(model, cfg["shapes"]["max_disp"])


def first_steps(model, state, step, batches: list[dict], running: tuple[str, ...], device: torch.device) -> dict:
    """The first steps through the window's own call and feed; each step's
    loss, the first gradient as Adam got it, the parameters and the
    running statistics (the buffers named ``*<suffix>`` for a suffix in
    ``running``) after the last."""
    from ecm_torch.train.loop import to_device

    names = dict((id(p), n) for n, p in model.named_parameters())
    beta1 = state.optimizer.adam.param_groups[0]["betas"][0]
    losses, first = [], None
    for batch in batches:
        state, metrics = step(state, to_device(batch, device))
        losses.append(float(metrics["loss"]))
        if first is None:
            first = {names[id(p)]: s["exp_avg"].detach().float() / (1 - beta1)
                     for p, s in state.optimizer.adam.state.items()}
    return {"losses": losses, "first_grads": first,
            "params": {n: p.detach().clone() for n, p in model.named_parameters()},
            "buffers": {n: b.detach().clone() for n, b in model.named_buffers() if n.endswith(running)}}


def steps_window(state, step, pool: list[dict], mix: dict, device: torch.device, until, count
                 ) -> tuple[int, float, int]:
    """Steps from the pool's batch ``CHECKED_STEPS`` on until the clock
    passes ``until`` or ``count`` are done. Returns the steps, the time from
    the first's start to the last's end, and the non-finite losses read."""
    from ecm_torch.train.loop import to_device

    n, bad = 0, 0
    t0 = time.perf_counter()
    while True:
        batch = to_device(pool[(CHECKED_STEPS + n) % len(pool)], device)
        state, metrics = step(state, batch)
        n += 1
        if n % mix["log_every"] == 0 and not torch.isfinite(torch.tensor(float(metrics["loss"]))):
            bad += 1
        if (count is not None and n >= count) or (until is not None and time.perf_counter() >= until):
            break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return n, time.perf_counter() - t0, bad


def reference_numbers(cfg: dict, params: dict, names: list[str], batches: list[dict], prog: dict,
                      device: torch.device) -> dict:
    """The reference's first steps on the same weights and batches,
    and the numbers that compare the program's with them."""
    on_device = [{k: torch.from_numpy(v).to(device) for k, v in b.items()} for b in batches]
    fam = family(cfg)
    ref = fam.train_steps(params, names, cfg, on_device, fam.EXACT)
    return compare.train_numbers(prog, ref, params, names)


def run(spec: dict, seed: int, seconds: float, traced: bool, device: torch.device, t_start: float) -> dict:
    cfg, mix, name = spec["config"], spec["mix"], spec["workload"]["name"]
    fam = family(cfg)
    t_build = time.perf_counter()
    template = fam.build(cfg, torch.device("meta")).state_dict()
    params = fam.seeded_weights(cfg, template, seed, device)
    model, state, step = setup_state(cfg, params, device)
    names = W.trainable(model)
    pool = host_pool(cfg, mix, seed, device)
    t_warm = time.perf_counter()
    prog = first_steps(model, state, step, pool[:CHECKED_STEPS], fam.RUNNING, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"{name}: set-up before the model {t_build - t_start:.3f} s, weights and pool {t_warm - t_build:.3f} s, "
          f"first steps {time.perf_counter() - t_warm:.3f} s", file=sys.stderr)
    setup_s = time.perf_counter() - t_start

    windows = []
    if traced:
        n_steps = mix["trace_steps"]
        box = {}
        windows.append(trace.profile(lambda: box.update(r=steps_window(state, step, pool, mix, device, None, n_steps)),
                                     name, work(cfg, n_steps)))
        n, elapsed, bad = box["r"][0], windows[0]["wall_s"], box["r"][2]
    else:
        n, elapsed, bad = steps_window(state, step, pool, mix, device, time.perf_counter() + seconds, None)
    peak = torch.cuda.max_memory_reserved(device) if device.type == "cuda" else 0

    del state, step, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    result = reference_numbers(cfg, params, names, pool[:CHECKED_STEPS], prog, device)
    checked = harness.checks(result["numbers"], cfg["limits"])
    batch = cfg["shapes"]["batch"]
    print(f"{name}: {n} steps of {batch} in {elapsed:.4f} s; set-up {setup_s:.4f} s; reference "
          f"{time.perf_counter() - t_ref:.2f} s; losses {result['losses']}; worst leaves {result['worst_leaf']}; "
          f"left out of the change {result['left_out']}", file=sys.stderr)
    return {
        "correct": bad == 0 and harness.passed(checked), "attempted": n, "failed": bad,
        "checked": checked, "numbers": result["numbers"], "memory_peak_bytes": peak, "windows": windows,
        "end_to_end": {"setup_s": setup_s, "train_pairs_per_s": n * batch / elapsed},
    }
