"""Drive the PyTorch/CUDA port on one GPU and check it.

    python3 chip_smoke.py

1. Builds the three CUDA kernels of the main path (one nvcc per source, in
   parallel) and holds each against its plain PyTorch version at the main
   path's shapes (B=1, 384x1248, max-disp 192, bf16), timing both with CUDA
   events (median of 10 runs).
2. Serves the flagship ECMStereo eval forward at full width through
   ``CONFIGS["kitti_infer"].model.build(...)`` with the slice's kernel path
   (seeded random weights): three 384x1248 pairs at batch 1 and one batch of
   8. Checks the disparity, that each forward launched the cost-volume,
   fused-pair and regression kernels 1, 3 and 1 times, and the cost map
   against the plain path (cuDNN convolutions, no kernels) on the same
   weights. Reports the median ms per forward at batch 1 and batch 8.
3. Prints the ``{"kernels": [...]}`` line, the card's name and power limit,
   and last ``{"ok": true, "device": {...}}``.

Any failed check raises, and the script exits nonzero without the last line.
It needs a CUDA device and the rest of the repository beside it.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from ecm_torch.configs import CONFIGS
from ecm_torch.configs.base import SLICE_OVERRIDES
from ecm_torch.kernels import build
from ecm_torch.ops import cuda_cost_volume as cvk
from ecm_torch.ops import cuda_fused_agg as pairk
from ecm_torch.ops import cuda_regression as regk

B, H, W, MAX_DISP, C = 1, 384, 1248, 192, 32
D4, H4, W4 = MAX_DISP // 4, H // 4, W // 4
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
SFU_PER_CLOCK_PER_SM, SMS = 16, 132
RUNS = 10
PAIR_REL_TOL = 2e-2  # max|diff| / max|ref| in bf16 (tests/test_fused_agg.py:81)
REGRESSION_TOL_PX = 1e-3
COST4_REL_TOL = 3e-2  # bf16 network, rounded at other places (9.9e-3 measured on an H100)
PLAIN = dict(agg_layout="standard", agg_fused="off", use_pallas=False, regress_mode="fullres")
OUT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"


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


def pairs(batch: int, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    left = torch.rand(batch, H, W, 3, generator=gen, device="cuda")
    return left, torch.rand(batch, H, W, 3, generator=gen, device="cuda")


def serve() -> dict:
    cfg = CONFIGS["kitti_infer"].model
    model = cfg.build(generator=torch.Generator().manual_seed(0), **SLICE_OVERRIDES)
    requests = [pairs(1, s) for s in (1, 2, 3)] + [pairs(8, 4)]
    counters = (cvk.cost_volume_concat, pairk.fused_conv3d_pair, regk.fused_upsample_softargmin)
    with torch.inference_mode():
        for f in counters:
            f.launches = 0
        disps = [model(left, right)[0] for left, right in requests]
        torch.cuda.synchronize()
        launches = [f.launches for f in counters]
        forwards = len(requests)
        if launches != [forwards, 3 * forwards, forwards]:
            raise AssertionError(f"launches {launches} for {forwards} forwards, expected 1/3/1 each")
        for (left, _), disp in zip(requests, disps):
            if disp.shape != left.shape[:3] or not torch.isfinite(disp).all():
                raise AssertionError(f"disparity {tuple(disp.shape)} not finite or misshapen")
            if disp.min() < 0 or disp.max() > MAX_DISP - 1:
                raise AssertionError(f"disparity outside [0, {MAX_DISP - 1}]")
        log(f"  served {forwards} forwards (3 at batch 1, 1 at batch 8); launches {launches}")

        plain = cfg.build(generator=torch.Generator().manual_seed(0), **PLAIN)
        plain.load_state_dict(model.state_dict())
        left, right = requests[0]
        (cost_k,) = model.cost_maps(left, right)
        (cost_p,) = plain.cost_maps(left, right)
        cost_err = ((cost_k.float() - cost_p.float()).abs().max() / cost_p.float().abs().max()).item()
        log(f"  cost4 kernel path vs plain path: max|diff|/max|ref| {cost_err:.3e} "
            f"(max|ref| {cost_p.float().abs().max().item():.4g})")
        if not cost_err <= COST4_REL_TOL:
            raise AssertionError(f"cost4 rel err {cost_err} > {COST4_REL_TOL}")
        disp_diff = (model(left, right)[0] - plain(left, right)[0]).abs()

        b1 = iter([pairs(1, 100 + i) for i in range(RUNS + 1)])
        runs_b1 = times_ms(lambda: model(*next(b1)))
        b8 = pairs(8, 200)
        runs_b8 = times_ms(lambda: model(*b8))
        p1 = iter([pairs(1, 300 + i) for i in range(RUNS + 1)])
        plain_ms_b1 = time_ms(lambda: plain(*next(p1)))
    return dict(
        launches=dict(zip(("cost_volume_concat", "fused_conv3d_pair", "fused_upsample_softargmin"), launches)),
        forwards=forwards, cost4_rel_err=cost_err,
        disp_vs_plain_px=dict(max=disp_diff.max().item(), mean=disp_diff.mean().item()),
        ms_per_forward_b1=statistics.median(runs_b1), ms_per_forward_b8=statistics.median(runs_b8),
        ms_per_pair_b8=statistics.median(runs_b8) / 8, runs_ms_b1=runs_b1, runs_ms_b8=runs_b8,
        plain_ms_per_forward_b1=plain_ms_b1,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
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
    kernels = [check_cost_volume(gen), check_fused_pair(gen), check_regression(gen, sm_clock_hz)]
    for k in kernels:
        log(f"phase kernels: {k['name']}: max|err| {k['max_abs_err']:.3e}, {k['ms']:.4f} ms, "
            f"plain {k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms ({k['bound_by']})")

    result = serve()
    log("phase serving: " + json.dumps(result))
    for k in kernels:
        k["launches"] = result["launches"][k["name"]]
        k["launches_per_forward"] = k["launches"] // result["forwards"]
    log(f"total {time.time() - t0:.1f} s")
    log(json.dumps({"kernels": kernels, "card": card}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
