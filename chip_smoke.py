"""Drive the PyTorch/CUDA port on one GPU and check it.

    python3 chip_smoke.py

1. Builds the port's CUDA kernels (one nvcc per source, in parallel) and
   holds each against its plain PyTorch version at the main paths' shapes
   (B=1, 384x1248, max-disp 192, bf16) in every form the paths use, timing
   the kernel, the plain version and, where one exists, one cuDNN call of
   the same function with CUDA events (median of 10 runs).
2. Serves ``CONFIGS["kitti_infer"].model.build(...)`` at full width (seeded
   random weights) along three paths, each with every launch count set to 0
   just before it and read just after:
   - slice 1, the standard-layout kernel path (``SLICE_OVERRIDES``): cost
     volume, fused pair and regression kernels 1, 3 and 1 times a forward;
   - slice 2, the grouped layer-kernel path (``SLICE2_OVERRIDES``): cost
     volume 1, ``conv3d_bn_s1`` 4, ``conv3d_bn_down`` 3, ``deconv3d_bn`` 3,
     fused pair 1 and regression 1 times a forward;
   - ``ECMBasic`` with the cost-volume and regression kernels, 1 and 1.
   The ECMStereo paths serve three pairs at batch 1 and one batch of 8,
   ECMBasic two pairs at batch 1. Each checks the disparity (finite, in
   [0, 191]), the launch counts, and the cost map against the plain path
   (cuDNN convolutions, no kernels) on the same weights, and reports the
   median ms per forward.
3. Profiles a steady window of batch-1 forwards of each ECMStereo path with
   ``torch.profiler``: device time per kernel, the port's kernels against
   the rest, and the device's idle share of the window.
4. Prints the ``{"kernels": [...]}`` line, the card's name and power limit,
   and last ``{"ok": true, "device": {...}}``.

Any failed check raises, and the script exits nonzero without the last line.
It needs a CUDA device and the rest of the repository beside it.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from ecm_torch.configs import CONFIGS
from ecm_torch.configs.base import SLICE2_OVERRIDES, SLICE_OVERRIDES
from ecm_torch.kernels import build
from ecm_torch.ops import cuda_cost_volume as cvk
from ecm_torch.ops import cuda_fused_agg as pairk
from ecm_torch.ops import cuda_gband as gbk
from ecm_torch.ops import cuda_gdeconv as gdk
from ecm_torch.ops import cuda_regression as regk

B, H, W, MAX_DISP, C = 1, 384, 1248, 192, 32
D4, H4, W4 = MAX_DISP // 4, H // 4, W // 4
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
SFU_PER_CLOCK_PER_SM, SMS = 16, 132
RUNS = 10
PAIR_REL_TOL = 2e-2  # max|diff| / max|ref| in bf16 (tests/test_fused_agg.py:81); also the conv kernels
REGRESSION_TOL_PX = 1e-3
COST4_REL_TOL = 3e-2  # bf16 network, rounded at other places (9.9e-3 measured on an H100)
PLAIN = dict(agg_layout="standard", agg_fused="off", use_pallas=False, regress_mode="fullres")
PLAIN_BASIC = dict(use_pallas=False, regress_mode="fullres")
OUT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"
COUNTERS = {
    "cost_volume_concat": cvk.cost_volume_concat,
    "conv3d_bn_s1": gbk.conv3d_bn_s1,
    "conv3d_bn_down": gbk.conv3d_bn_down,
    "deconv3d_bn": gdk.deconv3d_bn,
    "fused_conv3d_pair": pairk.fused_conv3d_pair,
    "fused_upsample_softargmin": regk.fused_upsample_softargmin,
}


def log(*a) -> None:
    print(*a, flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, runs: int = RUNS) -> float:
    """Median device time of ``fn`` over ``runs`` calls, after one warm-up."""
    return statistics.median(times_ms(fn, runs))


def times_ms(fn, runs: int = RUNS) -> list[float]:
    """Device time of each of ``runs`` calls of ``fn``, after one warm-up."""
    fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(ops: float, ops_rate: float, moved: int) -> tuple[float, str]:
    t_ops, t_bytes = ops / ops_rate, moved / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def check_cost_volume(gen) -> dict:
    fl = torch.randn(B, H4, W4, C, generator=gen, device="cuda").bfloat16()
    fr = torch.randn(B, H4, W4, C, generator=gen, device="cuda").bfloat16()
    out = cvk.cost_volume_concat(fl, fr, D4)
    torch.cuda.synchronize()
    ref = cvk.cost_volume_concat_torch(fl, fr, D4)
    if not torch.equal(out, ref):
        raise AssertionError("cost_volume_concat kernel differs from the plain builder")
    bound_ms, by = bound(0, 1, nbytes(fl, fr, out))
    return dict(
        name="cost_volume_concat", route="cuda", source="ecm_torch/csrc/cost_volume.cu",
        replaces="ecm_tpu/ops/pallas_cost_volume.py:132", max_abs_err=0.0,
        ms=time_ms(lambda: cvk.cost_volume_concat(fl, fr, D4)),
        plain_ms=time_ms(lambda: cvk.cost_volume_concat_torch(fl, fr, D4)),
        bound_ms=bound_ms, bound_by=by, library_ms=None,
    )


def _pair_inputs(gen, form: str):
    cin, cout = {"dres0": (2 * C, C), "dres1": (C, C), "classif3": (C, 1)}[form]
    cm = C

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    x = rnd(B, D4, H4, W4, cin).bfloat16()
    k1 = rnd(cm, cin, 3, 3, 3, scale=(27 * cin) ** -0.5)
    k2 = rnd(cout, cm, 3, 3, 3, scale=(27 * cm) ** -0.5)
    s1 = torch.rand(cm, generator=gen, device="cuda") + 0.5
    s2 = torch.ones(cout, device="cuda") if form == "classif3" else torch.rand(cout, generator=gen, device="cuda") + 0.5
    b1, b2 = rnd(cm, scale=0.1), rnd(cout, scale=0.1)
    ctx = rnd(B, H4, W4, cout).bfloat16() if form == "dres0" else None
    opts = {"dres0": {}, "dres1": {"relu2": False, "residual": True}, "classif3": {"relu2": False}}[form]
    return (x, k1, s1, b1, k2, s2, b2, ctx), opts


def check_fused_pair(gen) -> dict:
    forms = []
    for form in ("dres0", "dres1", "classif3"):
        args, opts = _pair_inputs(gen, form)
        out = pairk.fused_conv3d_pair(*args, **opts)
        torch.cuda.synchronize()
        ref = pairk.fused_conv3d_pair_torch(*args, **opts)
        err = (out.float() - ref.float()).abs().max().item()
        rel = err / ref.float().abs().max().item()
        if not rel <= PAIR_REL_TOL:
            raise AssertionError(f"fused_conv3d_pair[{form}] rel err {rel} > {PAIR_REL_TOL}")
        x, k1, _, _, k2, _, _, ctx = args
        vox = x.shape[0] * x.shape[1] * x.shape[2] * x.shape[3]
        flops = 2 * 27 * vox * (k1.shape[1] * k1.shape[0] + k2.shape[1] * k2.shape[0])
        bound_ms, by = bound(flops, PEAK_BF16_FLOPS, nbytes(x, ctx, out) + 2 * (k1.numel() + k2.numel()))
        xcf, w1, w2 = x.movedim(-1, 1), k1.bfloat16(), k2.bfloat16()
        forms.append(dict(
            form=form, max_abs_err=err, rel_err=rel, gflop=flops / 1e9,
            ms=time_ms(lambda: pairk.fused_conv3d_pair(*args, **opts)),
            plain_ms=time_ms(lambda: pairk.fused_conv3d_pair_torch(*args, **opts)),
            # yardstick: the two cuDNN convolutions alone, without the epilogues
            library_ms=time_ms(lambda: torch.nn.functional.conv3d(
                torch.nn.functional.conv3d(xcf, w1, padding=1), w2, padding=1)),
            bound_ms=bound_ms, bound_by=by,
        ))
        log(f"  fused_conv3d_pair[{form}]: rel err {rel:.3e}, {forms[-1]['ms']:.3f} ms "
            f"(plain {forms[-1]['plain_ms']:.3f}, cuDNN convs {forms[-1]['library_ms']:.3f}, "
            f"bound {bound_ms:.4f})")
    total = {k: sum(f[k] for f in forms) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return dict(
        name="fused_conv3d_pair", route="cuda", source="ecm_torch/csrc/fused_conv3d_pair.cu",
        replaces="ecm_tpu/ops/pallas_fused_agg.py:436",
        max_abs_err=max(f["max_abs_err"] for f in forms),
        bound_by="operations" if all(f["bound_by"] == "operations" for f in forms) else "bytes",
        forms=forms, **total,
    )


def check_regression(gen, sm_clock_hz: float) -> dict:
    cost4 = torch.randn(B, D4, H4, W4, generator=gen, device="cuda").bfloat16()
    out = regk.fused_upsample_softargmin(cost4, MAX_DISP)
    torch.cuda.synchronize()
    ref = regk.fused_upsample_softargmin_torch(cost4, MAX_DISP)
    err = (out - ref).abs().max().item()
    if not err <= REGRESSION_TOL_PX:
        raise AssertionError(f"fused_upsample_softargmin |diff| {err} px > {REGRESSION_TOL_PX}")
    exps = B * MAX_DISP * H * W
    bound_ms, by = bound(exps, SFU_PER_CLOCK_PER_SM * SMS * sm_clock_hz, nbytes(cost4, out))
    return dict(
        name="fused_upsample_softargmin", route="cuda", source="ecm_torch/csrc/regression.cu",
        replaces="ecm_tpu/ops/pallas_regression.py:140", max_abs_err=err,
        ms=time_ms(lambda: regk.fused_upsample_softargmin(cost4, MAX_DISP)),
        plain_ms=time_ms(lambda: regk.fused_upsample_softargmin_torch(cost4, MAX_DISP)),
        bound_ms=bound_ms, bound_by=by, library_ms=None,
    )

def _rnd(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen, device="cuda") * scale


def _bn(gen, c):
    return torch.rand(c, generator=gen, device="cuda") + 0.5, _rnd(gen, c, scale=0.1)


def check_forms(name, source, replaces, forms) -> dict:
    """Hold a kernel against its plain version in each form; time the
    kernel, the plain version and the cuDNN yardstick (which the port never
    calls on its kernel path). ``forms``: (form, kernel, plain, library,
    ops, bytes)."""
    rows = []
    for form, kern, plain, lib, ops, moved in forms:
        out = kern()
        torch.cuda.synchronize()
        ref = plain()
        err = (out.float() - ref.float()).abs().max().item()
        rel = err / ref.float().abs().max().item()
        if not rel <= PAIR_REL_TOL:
            raise AssertionError(f"{name}[{form}] rel err {rel} > {PAIR_REL_TOL}")
        bound_ms, by = bound(ops, PEAK_BF16_FLOPS, moved + nbytes(out))
        rows.append(dict(
            form=form, max_abs_err=err, rel_err=rel, gflop=ops / 1e9, mbytes=(moved + nbytes(out)) / 1e6,
            ms=time_ms(kern), plain_ms=time_ms(plain), library_ms=time_ms(lib),
            bound_ms=bound_ms, bound_by=by,
        ))
        r = rows[-1]
        log(f"  {name}[{form}]: rel err {rel:.3e}, {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, "
            f"cuDNN {r['library_ms']:.3f}, bound {bound_ms:.4f} {by})")
    total = {k: sum(f[k] for f in rows) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        max_abs_err=max(f["max_abs_err"] for f in rows),
        bound_by="operations" if all(f["bound_by"] == "operations" for f in rows) else "bytes",
        forms=rows, **total,
    )


def check_conv3d_bn_s1(gen) -> dict:
    """The four dres convs of the grouped path: 64->32, 32->32 + context
    map, 32->32, 32->32 + residual without ReLU."""
    forms = []
    for form, cin, add, relu in (
        ("dres0_1", 2 * C, None, True), ("dres0_2", C, "ctx", True),
        ("dres1_1", C, None, True), ("dres1_2", C, "residual", False),
    ):
        x = _rnd(gen, B, D4, H4, W4, cin).bfloat16()
        w = _rnd(gen, C, cin, 3, 3, 3, scale=(27 * cin) ** -0.5)
        s, b = _bn(gen, C)
        a = None if add is None else _rnd(gen, B, 1 if add == "ctx" else D4, H4, W4, C).bfloat16()
        xcf, wb = x.movedim(-1, 1), w.bfloat16()
        vox = B * D4 * H4 * W4
        forms.append((
            form,
            lambda x=x, w=w, s=s, b=b, a=a, relu=relu: gbk.conv3d_bn_s1(x, w, s, b, a, relu=relu),
            lambda x=x, w=w, s=s, b=b, a=a, relu=relu: gbk.conv3d_bn_torch(x, w, s, b, a, relu=relu),
            lambda xcf=xcf, wb=wb: F.conv3d(xcf, wb, padding=1),
            2 * 27 * vox * cin * C, nbytes(x, a) + 2 * w.numel(),
        ))
    return check_forms(
        "conv3d_bn_s1", "ecm_torch/csrc/conv3d_bn.cu", "ecm_tpu/ops/pallas_gband.py:213", forms
    )


def check_conv3d_bn_down(gen) -> dict:
    """Hourglass conv1: 32 -> 64, stride 2."""
    x = _rnd(gen, B, D4, H4, W4, C).bfloat16()
    w = _rnd(gen, 2 * C, C, 3, 3, 3, scale=(27 * C) ** -0.5)
    s, b = _bn(gen, 2 * C)
    xcf, wb = x.movedim(-1, 1), w.bfloat16()
    out_vox = B * (D4 // 2) * (H4 // 2) * (W4 // 2)
    form = (
        "hourglass_conv1",
        lambda: gbk.conv3d_bn_down(x, w, s, b),
        lambda: gbk.conv3d_bn_torch(x, w, s, b, stride=2),
        lambda: F.conv3d(xcf, wb, stride=2, padding=1),
        2 * 27 * out_vox * C * 2 * C, nbytes(x) + 2 * w.numel(),
    )
    return check_forms(
        "conv3d_bn_down", "ecm_torch/csrc/conv3d_bn.cu", "ecm_tpu/ops/pallas_gband.py:620", [form]
    )


def check_deconv3d_bn(gen) -> dict:
    """Hourglass conv6: 64 -> 32, every dim doubled, + cost0."""
    d, h, w_ = D4 // 2, H4 // 2, W4 // 2
    x = _rnd(gen, B, d, h, w_, 2 * C).bfloat16()
    w = _rnd(gen, 2 * C, C, 3, 3, 3, scale=(27 * 2 * C / 8) ** -0.5)
    s, b = _bn(gen, C)
    a = _rnd(gen, B, D4, H4, W4, C).bfloat16()
    xcf, wb = x.movedim(-1, 1), (w * s.view(1, -1, 1, 1, 1)).bfloat16()
    # legal taps per dim of n inputs: n even outputs with 1, n-1 odd with 2, 1 with 1
    taps = (3 * d - 1) * (3 * h - 1) * (3 * w_ - 1)
    form = (
        "hourglass_conv6",
        lambda: gdk.deconv3d_bn(x, w, s, b, a),
        lambda: gdk.deconv3d_bn_torch(x, w, s, b, a),
        lambda: F.conv_transpose3d(xcf, wb, stride=2, padding=1, output_padding=1),
        2 * B * taps * 2 * C * C, nbytes(x, a) + 2 * w.numel(),
    )
    return check_forms(
        "deconv3d_bn", "ecm_torch/csrc/deconv3d_bn.cu", "ecm_tpu/ops/pallas_gdeconv.py:213", [form]
    )


def pairs(batch: int, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    left = torch.rand(batch, H, W, 3, generator=gen, device="cuda")
    return left, torch.rand(batch, H, W, 3, generator=gen, device="cuda")


def serve(path: str, name: str, overrides: dict, per_forward: dict, batch8: bool) -> dict:
    """Serve one path: every launch count set to 0 just before, read just
    after; then the cost map against the plain path and the timings."""
    cfg = dataclasses.replace(CONFIGS["kitti_infer"].model, name=name)
    model = cfg.build(generator=torch.Generator().manual_seed(0), **overrides)
    requests = [pairs(1, s) for s in (1, 2, 3)[: 3 if batch8 else 2]] + ([pairs(8, 4)] if batch8 else [])
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        for f in COUNTERS.values():
            f.launches = 0
        disps = [model(left, right)[0] for left, right in requests]
        torch.cuda.synchronize()
        launches = {k: f.launches for k, f in COUNTERS.items()}
        forwards = len(requests)
        expected = {k: per_forward.get(k, 0) * forwards for k in COUNTERS}
        if launches != expected:
            raise AssertionError(f"{path}: launches {launches} for {forwards} forwards, expected {expected}")
        for (left, _), disp in zip(requests, disps):
            if disp.shape != left.shape[:3] or not torch.isfinite(disp).all():
                raise AssertionError(f"{path}: disparity {tuple(disp.shape)} not finite or misshapen")
            if disp.min() < 0 or disp.max() > MAX_DISP - 1:
                raise AssertionError(f"{path}: disparity outside [0, {MAX_DISP - 1}]")
        log(f"  {path}: served {forwards} forwards; launches {launches}")

        plain = cfg.build(generator=torch.Generator().manual_seed(0), **(PLAIN if name != "basic" else PLAIN_BASIC))
        plain.load_state_dict(model.state_dict())
        left, right = requests[0]
        (cost_k,) = model.cost_maps(left, right)
        (cost_p,) = plain.cost_maps(left, right)
        cost_err = ((cost_k.float() - cost_p.float()).abs().max() / cost_p.float().abs().max()).item()
        log(f"  {path}: cost4 kernel path vs plain path: max|diff|/max|ref| {cost_err:.3e} "
            f"(max|ref| {cost_p.float().abs().max().item():.4g})")
        if not cost_err <= COST4_REL_TOL:
            raise AssertionError(f"{path}: cost4 rel err {cost_err} > {COST4_REL_TOL}")
        disp_diff = (model(left, right)[0] - plain(left, right)[0]).abs()

        b1 = iter([pairs(1, 100 + i) for i in range(RUNS + 1)])
        runs_b1 = times_ms(lambda: model(*next(b1)))
        p1 = iter([pairs(1, 300 + i) for i in range(RUNS + 1)])
        plain_ms_b1 = time_ms(lambda: plain(*next(p1)))
        result = dict(
            launches=launches, forwards=forwards, cost4_rel_err=cost_err,
            disp_vs_plain_px=dict(max=disp_diff.max().item(), mean=disp_diff.mean().item()),
            ms_per_forward_b1=statistics.median(runs_b1), runs_ms_b1=runs_b1,
            plain_ms_per_forward_b1=plain_ms_b1,
        )
        if batch8:
            b8 = pairs(8, 200)
            runs_b8 = times_ms(lambda: model(*b8))
            result.update(
                ms_per_forward_b8=statistics.median(runs_b8),
                ms_per_pair_b8=statistics.median(runs_b8) / 8, runs_ms_b8=runs_b8,
            )
    result["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del model, plain
    torch.cuda.empty_cache()
    return result


# the port's kernels by symbol, in matching order: the tensor-core GEMM's
# transposed mode is conv3d_mma_kernel<0, ...>, and deconv3d_bn_kernel
# contains conv3d_bn_kernel
PORT_SYMBOLS = (
    ("conv3d_mma_kernel<0", "deconv3d_bn"), ("conv3d_mma_kernel", "conv3d_bn"),
    ("deconv3d_bn_kernel", "deconv3d_bn"), ("conv3d_bn_kernel", "conv3d_bn"),
    ("fused_pair_kernel", "fused_conv3d_pair"), ("concat_kernel", "cost_volume_concat"),
    ("upsample_softargmin_kernel", "fused_upsample_softargmin"),
)


def profile_forward(path: str, overrides: dict, runs: int = 3) -> dict:
    """``runs`` batch-1 forwards under torch.profiler after a warm-up: device
    time per kernel (ms per forward), the port's kernels against everything
    else (cuDNN, elementwise, copies), and the idle share of the window (1 -
    union of device intervals / host wall time, profiler overhead included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model = CONFIGS["kitti_infer"].model.build(generator=torch.Generator().manual_seed(0), **overrides)
    reqs = [pairs(1, 400 + i) for i in range(runs + 1)]
    with torch.inference_mode():
        model(*reqs[0])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for left, right in reqs[1:]:
                model(left, right)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name, port = {}, {}
    for e in events:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
        label = next((lab for sym, lab in PORT_SYMBOLS if sym in e.name), "other")
        port[label] = port.get(label, 0.0) + ms
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in events):
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    del model
    torch.cuda.empty_cache()
    return dict(
        path=path, runs=runs, device_events=len(events),
        wall_ms_per_forward=wall_ms / runs, device_busy_ms_per_forward=busy_us / 1e3 / runs,
        idle_share=1 - busy_us / 1e3 / wall_ms if events else None,
        ms_per_forward_by_group={k: v / runs for k, v in sorted(port.items(), key=lambda kv: -kv[1])},
        top_kernels_ms_per_forward=[(k[:90], v / runs) for k, v in top],
    )


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    t0 = time.time()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("set torch.backends.cudnn.allow_tf32 = False and torch.backends.cuda.matmul.allow_tf32 = False")
    card = nvidia_smi("name,power.limit")
    sm_clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {card}; max SM clock {sm_clock_hz / 1e6:.0f} MHz")

    logs = build.build()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "build_log.txt").write_text("\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    log(f"phase build: {len(logs)} kernels compiled in {time.time() - t0:.1f} s")

    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = [
        check_cost_volume(gen), check_fused_pair(gen), check_regression(gen, sm_clock_hz),
        check_conv3d_bn_s1(gen), check_conv3d_bn_down(gen), check_deconv3d_bn(gen),
    ]
    for k in kernels:
        log(f"phase kernels: {k['name']}: max|err| {k['max_abs_err']:.3e}, {k['ms']:.4f} ms, "
            f"plain {k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms ({k['bound_by']})")

    paths = {
        "slice1_standard": serve("slice1_standard", "stackhourglass", SLICE_OVERRIDES, dict(
            cost_volume_concat=1, fused_conv3d_pair=3, fused_upsample_softargmin=1), batch8=True),
        "slice2_grouped": serve("slice2_grouped", "stackhourglass", SLICE2_OVERRIDES, dict(
            cost_volume_concat=1, conv3d_bn_s1=4, conv3d_bn_down=3, deconv3d_bn=3,
            fused_conv3d_pair=1, fused_upsample_softargmin=1), batch8=True),
        "basic": serve("basic", "basic", dict(use_pallas=True, regress_mode="fused"), dict(
            cost_volume_concat=1, fused_upsample_softargmin=1), batch8=False),
    }
    for path, result in paths.items():
        log(f"phase serving {path}: " + json.dumps(result))
    for path, overrides in (("slice2_grouped", SLICE2_OVERRIDES), ("slice1_standard", SLICE_OVERRIDES)):
        log(f"phase profile {path}: " + json.dumps(profile_forward(path, overrides)))
    for k in kernels:
        # launches: this slice's main path (the grouped path runs all six kernels)
        k["launches"] = paths["slice2_grouped"]["launches"][k["name"]]
        k["launches_by_path"] = {p: r["launches"][k["name"]] for p, r in paths.items()}
    log(f"total {time.time() - t0:.1f} s")
    log(json.dumps({"kernels": kernels, "card": card}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
