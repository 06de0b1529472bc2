"""The fused pair's wgmma kernel (``ecm_torch/csrc/fused_conv3d_pair.cu``)
compiled with g++ for the CPU against the stubs in ``tests/cuda_stub/`` and
held against the plain version: the kernel's own tiling, indexing, D slabs,
rings, barriers and epilogues run on CPU tensors (one thread per CUDA
thread), only the instructions are stand-ins. Small shapes that cross the
(H, W) tiles and D slabs, with few blocks, so that each walks several work
items and the rings wrap. A fault the stubs catch (an operand or a copy
outside shared memory or the registered tensors, a deadlock) aborts the
process with a "SIM FAULT" message."""

import ctypes
import re
import shutil
import subprocess

import pytest
import torch
import torch.nn.functional as F

from ecm_torch.ops import cuda_fused_agg as pk
from test_torch_port_util import torch_threads

CSRC = pk.__file__.rsplit("/ops/", 1)[0] + "/csrc"
STUB = __file__.rsplit("/", 1)[0] + "/cuda_stub"


@pytest.fixture(scope="module")
def kernel(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    src = tmp_path_factory.mktemp("pair_stub")
    shutil.copytree(CSRC, src / "csrc")
    shutil.copy(f"{STUB}/wgmma.cuh", src / "csrc" / "wgmma.cuh")
    cu = (src / "csrc" / "fused_conv3d_pair.cu").read_text()
    cu, launches = re.subn(r"kernel<<<(.*), kThreads, (.*), stream>>>\((.*)\);",
                           r"stub_launch(kernel, \1, kThreads, \2, \3);", cu)
    cu, arrays = re.subn(r"extern __shared__ __align__\(\d+\) unsigned char (\w+)\[\];",
                         r"unsigned char* \1 = sim::cur->smem.data();", cu)
    assert launches == 2 and arrays == 2 and "<<<" not in cu
    (src / "csrc" / "fused_conv3d_pair.cu").write_text(cu)
    lib = src / "libpair_stub.so"
    subprocess.run([gxx, "-std=c++20", "-O2", "-pthread", "-shared", "-fPIC", f"-I{STUB}", "-x", "c++",
                    str(src / "csrc" / "fused_conv3d_pair.cu"), "-o", str(lib)], check=True)
    dll = ctypes.CDLL(str(lib))
    vp, i = ctypes.c_void_p, ctypes.c_int
    dll.ecm_fused_conv3d_pair_wgmma.argtypes = [vp] * 9 + [i] * 14 + [ctypes.c_longlong, vp]
    dll.sim_register.argtypes = [vp, ctypes.c_longlong]
    with torch_threads(1):
        yield dll


def _kernel_arithmetic(x, k1, s1, b1, k2, s2, b2, ctx, relu2, residual):
    """The kernel's arithmetic in f32: bf16 operands, f32 sums and affines,
    y rounded to bf16, the output not rounded."""
    y = F.conv3d(x.float().movedim(-1, 1), k1.bfloat16().float(), padding=1).movedim(1, -1) * s1 + b1
    y = y.clamp_min(0).bfloat16().float().movedim(-1, 1)
    out = F.conv3d(y, k2.bfloat16().float(), padding=1).movedim(1, -1) * s2 + b2
    if relu2:
        out = out.clamp_min(0)
    if ctx is not None:
        out = out + ctx.float()[:, None]
    if residual:
        out = out + x[..., : out.shape[-1]].float()
    return out


# (Cin, Cout, options), x [B, D, H, W], SMs: the main paths' three forms (k1
# resident at TH 4 and 2, streamed at TH 2), and the adds at Cout 1 and 16
CASES = {
    "classif3": (32, 1, {"relu2": False}, (2, 7, 9, 70), 3),
    "dres1": (32, 32, {"relu2": False, "residual": True}, (2, 7, 5, 70), 3),
    "dres0": (64, 32, {"ctx": True}, (1, 6, 5, 70), 2),
    "cout1_ctx_residual": (32, 1, {"ctx": True, "residual": True}, (1, 5, 6, 40), 1),
    "cin40_cout16": (40, 16, {"ctx": True, "residual": True, "relu2": False}, (1, 5, 3, 70), 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_wgmma_kernel_on_stubs_matches_the_plain_version(kernel, case):
    cin, cout, opts, (b, d, h, w), sms = CASES[case]
    g = torch.Generator().manual_seed(len(case))
    x = torch.randn(b, d, h, w, cin, generator=g).bfloat16()
    k1 = torch.randn(32, cin, 3, 3, 3, generator=g) * (27 * cin) ** -0.5
    k2 = torch.randn(cout, 32, 3, 3, 3, generator=g) * (27 * 32) ** -0.5
    s1, b1 = torch.rand(32, generator=g) + 0.5, torch.randn(32, generator=g) * 0.1
    s2, b2 = torch.rand(cout, generator=g) + 0.5, torch.randn(cout, generator=g) * 0.1
    ctx = torch.randn(b, h, w, cout, generator=g).bfloat16() if opts.get("ctx") else None
    relu2, residual = opts.get("relu2", True), opts.get("residual", False)
    plan = pk.pair_plan(torch.bfloat16, b, d, h, w, cin, 32, cout, sms)
    assert plan.route == "wgmma" and plan.items > plan.blocks
    ops = pk.pair_operands(k1, s1, b1, k2, s2, b2, "cpu")
    guard = 256  # a write outside out shows in the guard zones
    buf = torch.full((b * d * h * w * cout + 2 * guard,), 7.0).bfloat16()
    out = buf[guard:-guard].view(b, d, h, w, cout)
    for t in (x, ops[0], ops[1]):
        kernel.sim_register(t.data_ptr(), t.numel() * t.element_size())
    status = kernel.ecm_fused_conv3d_pair_wgmma(
        x.data_ptr(), ops[0].data_ptr(), ops[2].data_ptr(), ops[3].data_ptr(), ops[1].data_ptr(),
        ops[4].data_ptr(), ops[5].data_ptr(), None if ctx is None else ctx.data_ptr(), out.data_ptr(),
        b, d, h, w, cin, cout, 1, int(relu2), int(residual), plan.tile[1], plan.tile[0], plan.ring,
        int(plan.resident), plan.blocks, plan.smem_bytes, None,
    )
    kernel.sim_clear()
    assert status == 0
    assert (buf[:guard] == 7).all() and (buf[-guard:] == 7).all()
    # against the kernel's arithmetic: the output's bf16 rounding (2^-9 of
    # its value) and y's roundings where f32 sums in another order land on
    # the other side of a bf16 tie
    ref = _kernel_arithmetic(x, k1, s1, b1, k2, s2, b2, ctx, relu2, residual)
    assert ((out.float() - ref).abs().max() / ref.abs().max()).item() <= 5e-3
    # against the plain version at the card tests' bf16 tolerance
    plain = pk.fused_conv3d_pair_torch(x, k1, s1, b1, k2, s2, b2, ctx, relu2=relu2, residual=residual).float()
    assert ((out.float() - plain).abs().max() / plain.abs().max()).item() <= 2e-2


def test_wgmma_kernel_on_stubs_rejects_a_plan_that_is_not_its_own(kernel):
    """The C entry checks the shared memory against its own count, and TH 4
    only where N2 is 8."""
    x = torch.zeros(1, 2, 2, 8, 32).bfloat16()
    plan = pk.pair_plan(torch.bfloat16, 1, 2, 2, 8, 32, 32, 1, 1)
    args = [x.data_ptr()] * 9 + [1, 2, 2, 8, 32, 1, 1, 0, 0, plan.tile[1], plan.tile[0], plan.ring,
                                 int(plan.resident), 1]
    assert kernel.ecm_fused_conv3d_pair_wgmma(*args, plan.smem_bytes + 16, None) != 0
    args[9 + 5] = 32  # Cout 32 at TH 4
    assert kernel.ecm_fused_conv3d_pair_wgmma(*args, plan.smem_bytes, None) != 0
