"""Serving, closed loop: one client sends a request of ``batch`` pairs, waits
for the disparities, and sends the next.

A request is what an eval driver does with a batch of host arrays: the
normalised float32 images are copied to the card (from pageable memory),
served by the program's ``make_infer_fn`` (one CUDA-graph replay a
request), and the disparities copied back to the host. The requests cycle
through a pool of distinct batches made from the seed. Set-up ends after
the mix's warm-up requests (the first eager, the second captured, then
replays); the window then runs for ``seconds`` (or, traced, a fixed count
of requests). A sample of the window's answers, drawn from the seed, is
kept and, once the window has closed and the program is freed, compared
with the float32 reference on the same inputs.

The driver names no model: the configuration's family (``families/``)
builds the program's model, makes its weights, counts a request's work,
names the program's kernels and runs the reference.
"""

from __future__ import annotations

import gc
import random
import sys
import time

import torch

from stereo_bench import compare, harness, synth, trace
from stereo_bench.families import family


def percentile(values: list[float], q: float) -> float:
    """The ``q``-th percentile (0-100), by linear interpolation between
    order statistics."""
    s = sorted(values)
    pos = (len(s) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def run(spec: dict, seed: int, seconds: float, traced: bool, device: torch.device, t_start: float) -> dict:
    from ecm_torch.train import steps

    cfg, mix, name = spec["config"], spec["mix"], spec["workload"]["name"]
    fam = family(cfg)
    h, w = cfg["shapes"]["height"], cfg["shapes"]["width"]
    batch = mix["batch"]
    t_build = time.perf_counter()
    model = fam.build(cfg, device)
    params = fam.seeded_weights(cfg, model.state_dict(), seed, device)
    if device.type == "cuda":  # the peak is the program's, not the weights' calibration by the reference
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    model.load_state_dict(params)
    infer = steps.make_infer_fn(model)
    pool = synth.make_pool(seed + 1, mix["pool"], batch, h, w, *mix["disparity_range"], device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def request(i: int) -> torch.Tensor:
        x = pool[i % len(pool)]
        return infer(x["left"].to(device), x["right"].to(device)).cpu()

    t_warm = time.perf_counter()
    for i in range(mix["warmup"]):
        request(i)
    sync()
    print(f"{name}: set-up before the model {t_build - t_start:.3f} s, weights and pool {t_warm - t_build:.3f} s, "
          f"warm-up {time.perf_counter() - t_warm:.3f} s", file=sys.stderr)

    rng = random.Random(seed)
    kept: list[tuple[int, torch.Tensor]] = []
    latencies: list[float] = []

    def serve(until: float | None, count: int | None) -> float:
        """Requests until the clock passes ``until`` or ``count`` are done;
        returns the time from the first's start to the last's answer."""
        i = mix["warmup"]
        t0 = time.perf_counter()
        while True:
            t = time.perf_counter()
            out = request(i)
            done = time.perf_counter()
            latencies.append(done - t)
            n = len(latencies)
            if n <= mix["checked_requests"]:
                kept.append((i, out))
            elif (j := rng.randrange(n)) < mix["checked_requests"]:
                kept[j] = (i, out)  # a uniform sample of every answer so far
            i += 1
            if (until is not None and done >= until) or (count is not None and n >= count):
                return done - t0

    setup_s = time.perf_counter() - t_start
    windows = []
    if traced:
        n = mix["trace_requests"]
        work = {"requests": n, "pairs": n * batch, "port_kernels": fam.KERNELS,
                **{k: n * v for k, v in fam.eval_work(cfg, batch).items()}}
        windows.append(trace.profile(lambda: serve(None, n), name, work))
        elapsed = windows[0]["wall_s"]
    else:
        elapsed = serve(time.perf_counter() + seconds, None)
    done = len(latencies)
    peak = torch.cuda.max_memory_reserved(device) if device.type == "cuda" else 0

    del infer, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    errors, failed = [], 0
    for i, out in sorted(kept, key=lambda k: k[0]):
        x = pool[i % len(pool)]
        if not torch.isfinite(out).all():
            failed += 1
        for lo in range(0, batch, mix["reference_block"]):
            hi = lo + mix["reference_block"]
            ref = fam.infer(params, cfg, x["left"][lo:hi].to(device), x["right"][lo:hi].to(device), fam.EXACT)
            errors.append((out[lo:hi].to(device) - ref).abs())
    numbers = compare.serve_numbers(errors)
    checked = harness.checks(numbers, cfg["limits"])
    ms = [1e3 * v for v in latencies]
    print(f"{name}: {done} requests of {batch} in {elapsed:.4f} s; latency ms p50 {percentile(ms, 50):.4f} "
          f"p95 {percentile(ms, 95):.4f} p99 {percentile(ms, 99):.4f} max {max(ms):.4f}; set-up {setup_s:.4f} s; "
          f"reference {time.perf_counter() - t_ref:.2f} s over {len(kept)} answers", file=sys.stderr)
    return {
        "correct": failed == 0 and harness.passed(checked),
        "attempted": done, "failed": failed, "checked": checked, "numbers": numbers,
        "memory_peak_bytes": peak, "windows": windows,
        "end_to_end": {"setup_s": setup_s, "serve_pairs_per_s": done * batch / elapsed,
                       "latency_p50_ms": percentile(ms, 50), "latency_p95_ms": percentile(ms, 95)},
    }
