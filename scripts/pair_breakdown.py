"""Where a fused pair's time goes on the card: the wgmma kernel
(``ecm_torch/csrc/fused_conv3d_pair.cu``) with clock64 phase timers, and the
kernel as built by the repo under other plans.

    python3 scripts/pair_breakdown.py

Writes an instrumented copy of the source to ``build/pair_breakdown/``:
each block's consumer thread 0 and producer thread add the clocks between
marks to a shared array, summed over blocks into a ``__device__`` array read
back with ``cudaMemcpyFromSymbol``. It builds it with the repo's nvcc flags,
runs it three times on each main-path form (``chip_smoke._pair_inputs``:
1 x 48 x 96 x 312 bf16) and prints the clocks per y-plane step and per ring
stage by phase. Then it times the repo's own library (CUDA events, median
of 20) under the plan ``pair_plan`` picks and under a few others. The marks
are inserted by matching lines of the source: an edit there makes this
script fail until its patterns follow. Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ecm_torch.kernels import build  # noqa: E402
from ecm_torch.kernels.build import library  # noqa: E402
from ecm_torch.ops import cuda_fused_agg as pk  # noqa: E402

OUT = ROOT / "build" / "pair_breakdown"
# mark k: the clocks since the mark before; consumer 0-12, producer 20-22
PHASES = {
    0: "consumer: loop and stage set-up", 1: "consumer: wait for a stage (full)", 2: "consumer: stage-1 issue",
    3: "consumer: wait<1> and hand back", 4: "consumer: wait<0> after stage 1", 5: "consumer: barrier before y",
    11: "consumer: y epilogue", 6: "consumer: proxy fence", 7: "consumer: barrier after y",
    8: "consumer: stage-2 issue", 12: "consumer: output voxels and add loads", 9: "consumer: wait<0>, output store",
    10: "consumer: end of step, next item", 20: "producer: loop", 21: "producer: wait for a slot (empty)",
    22: "producer: TMA issue",
}
MARKS = [
    # (source text, text put in its place); {t} is the text itself
    ("namespace {\nnamespace pair_wg {", "__device__ unsigned long long g_prof[32];\n"
     "#define MARK(k) do { if (lead) { long long _t = clock64(); pr[k] += _t - last; last = _t; } } while (0)\n{t}"),
    ("    if (lane != 0) return;\n", "{t}    const bool lead = true;\n    __shared__ long long pr[32];\n"
     "    for (int k = 0; k < 32; ++k) pr[k] = 0;\n    long long last = clock64();\n"),
    ("            if (wrapped) ptx::mbar_wait(empty + slot, (wrapped - 1) & 1);\n",
     "            MARK(20);\n{t}            MARK(21);\n"),
    ("                               kTapBytes, full + slot);\n", "{t}            MARK(22);\n"),
    ("      }\n    }\n    return;\n  }\n", "      }\n    }\n"
     "    for (int k = 20; k < 24; ++k) atomicAdd(g_prof + k, (unsigned long long)pr[k]);\n    return;\n  }\n"),
    ("  int slot = 0, phase = 0;", "  const bool lead = tid == 0;\n  __shared__ long long pr[32];\n"
     "  if (lead) for (int k = 0; k < 32; ++k) pr[k] = 0;\n  long long last = clock64();\n{t}"),
    ("      const int dy = it.d0 - 1 + j;\n      // ---- stage 1", "      const int dy = it.d0 - 1 + j;\n"
     "      MARK(10);\n      // ---- stage 1"),
    ("          ptx::mbar_wait(full + slot, phase);", "          MARK(0);\n{t}\n          MARK(1);"),
    ("          ptx::wgmma_commit();\n          // the stage before", "          ptx::wgmma_commit();\n"
     "          MARK(2);\n          // the stage before"),
    ("          prev = slot;\n", "{t}          MARK(3);\n          if (lead) pr[15]++;\n"),
    ("      ptx::wgmma_wait<0>();\n      if (prev >= 0) ptx::mbar_arrive(empty + prev);\n",
     "      MARK(0);\n{t}      MARK(4);\n"),
    ("      ptx::named_barrier(1, 128 * kNWG);\n      // E1 and bf16", "      ptx::named_barrier(1, 128 * kNWG);\n"
     "      MARK(5);\n      // E1 and bf16"),
    ("      ptx::fence_proxy_async();  // the y stores, before wgmma reads them\n"
     "      ptx::named_barrier(1, 128 * kNWG);\n",
     "      MARK(11);\n      ptx::fence_proxy_async();\n      MARK(6);\n      ptx::named_barrier(1, 128 * kNWG);\n"
     "      MARK(7);\n      if (lead) pr[16]++;\n"),
    ("      ptx::wgmma_commit();\n      // the output's voxels", "      ptx::wgmma_commit();\n      MARK(8);\n"
     "      // the output's voxels"),
    ("      ptx::wgmma_wait<0>();\n#pragma unroll\n      for (int r = 0; r < T::kOPW; ++r) retire<N2>(acc2[r]);",
     "      MARK(12);\n{t}"),
    ("          }\n        }\n    }\n  }\n}\n\n// x as a 5-D tensor map",
     "          }\n        }\n      MARK(9);\n    }\n  }\n  MARK(10);\n"
     "  if (lead) for (int k = 0; k < 20; ++k) atomicAdd(g_prof + k, (unsigned long long)pr[k]);\n"
     "}\n\n// x as a 5-D tensor map"),
]
PROFILE_ENTRY = """
extern "C" int ecm_pair_profile(void* host, int reset) {
  if (reset) {
    unsigned long long z[32] = {0};
    return cudaMemcpyToSymbol(g_prof, z, sizeof(z));
  }
  return cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof));
}
"""
# (TH, k1 resident, ring, D slab) besides the plan's own, by form
OTHER_PLANS = {
    "classif3": [(4, True, 2, 12), (4, True, 3, 12), (2, True, 8, 16), (4, True, 5, 6)],
    "dres1": [(2, True, 2, 16), (2, True, 3, 16), (2, False, 5, 16), (2, True, 5, 8)],
    "dres0": [(2, False, 2, 16), (2, False, 3, 16), (2, False, 5, 8)],
}


def instrumented_library() -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    for header in (ROOT / "ecm_torch" / "csrc").glob("*.cuh"):
        shutil.copy(header, OUT / header.name)
    src = (ROOT / "ecm_torch" / "csrc" / "fused_conv3d_pair.cu").read_text()
    for old, new in MARKS:
        if src.count(old) != 1:
            raise SystemExit(f"pair_breakdown: the source no longer has exactly one {old!r}")
        src = src.replace(old, new.replace("{t}", old))
    (OUT / "fused_conv3d_pair.cu").write_text(src + PROFILE_ENTRY)
    run = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(OUT / "libpair.so"),
                          str(OUT / "fused_conv3d_pair.cu")], capture_output=True, text=True)
    if run.returncode:
        raise SystemExit(run.stdout + run.stderr)
    lib = ctypes.CDLL(str(OUT / "libpair.so"))
    lib.ecm_pair_profile.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def entry(lib: ctypes.CDLL):
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.ecm_fused_conv3d_pair_wgmma
    fn.argtypes = [vp] * 9 + [i] * 14 + [ctypes.c_longlong, vp]
    return fn


def launch(fn, args, opts, th, resident, ring, sd):
    x, k1, s1, b1, k2, s2, b2, ctx = args
    b, d, h, w, cin = x.shape
    cout = k2.shape[0]
    ops = pk.pair_operands(k1, s1, b1, k2, s2, b2, x.device)
    out = torch.empty(b, d, h, w, cout, dtype=x.dtype, device=x.device)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    status = fn(x.data_ptr(), ops[0].data_ptr(), ops[2].data_ptr(), ops[3].data_ptr(), ops[1].data_ptr(),
                ops[4].data_ptr(), ops[5].data_ptr(), None if ctx is None else ctx.data_ptr(), out.data_ptr(),
                b, d, h, w, cin, cout, 1, int(opts.get("relu2", True)), int(opts.get("residual", False)),
                th, sd, ring, int(resident), sms, pk._wg_smem(th, cin, cout, resident, ring),
                torch.cuda.current_stream().cuda_stream)
    if status:
        raise RuntimeError(f"launch failed: {status}")
    return out


def event_ms(fn, runs: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("pair_breakdown: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    prof = instrumented_library()
    prof_fn, repo_fn = entry(prof), entry(library("fused_conv3d_pair"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for form in ("classif3", "dres1", "dres0"):
        args, opts = cs._pair_inputs(gen, form)
        x = args[0]
        plan = pk.pair_plan(x.dtype, *x.shape, args[1].shape[0], args[4].shape[0],
                            torch.cuda.get_device_properties(0).multi_processor_count)
        own = (plan.tile[1], plan.resident, plan.ring, plan.tile[0])
        launch(prof_fn, args, opts, *own)
        torch.cuda.synchronize()
        prof.ecm_pair_profile(None, 1)
        for _ in range(3):
            launch(prof_fn, args, opts, *own)
        torch.cuda.synchronize()
        clocks = (ctypes.c_ulonglong * 32)()
        prof.ecm_pair_profile(ctypes.addressof(clocks), 0)
        steps, stages = clocks[16], clocks[15]
        result = {
            "form": form, "plan": plan._asdict(), "stages_per_step": stages / steps,
            "consumer_clocks_per_step": {PHASES[k]: clocks[k] / steps for k in PHASES if k < 20},
            "producer_clocks_per_stage": {PHASES[k]: clocks[k] / stages for k in PHASES if k >= 20},
        }
        result["consumer_clocks_per_step_total"] = sum(result["consumer_clocks_per_step"].values())
        ref = pk.fused_conv3d_pair_torch(*args, **opts).float()
        times = {}
        for other in [own] + OTHER_PLANS[form]:
            th, resident, ring, _ = other
            cin, cout = x.shape[-1], args[4].shape[0]
            if pk._wg_smem(th, cin, cout, resident, ring) > cs.gbk.SMEM_PER_BLOCK or (th == 4 and pk._wg_n2(cout) > 8):
                continue
            out = launch(repo_fn, args, opts, *other)
            torch.cuda.synchronize()
            rel = ((out.float() - ref).abs().max() / ref.abs().max()).item()
            if not rel <= cs.PAIR_REL_TOL:
                raise AssertionError(f"{form} {other}: rel err {rel}")
            times[f"th {th} resident {resident} ring {ring} sd {other[3]}"] = event_ms(
                lambda other=other: launch(repo_fn, args, opts, *other))
        result["event_ms_by_plan"] = times
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
