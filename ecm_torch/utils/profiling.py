"""Tracing, timing and the analytic FLOP and byte models of the flagship
forward (port of ``ecm_tpu/utils/profiling.py``, under the same names).

``trace`` records the host and the card with ``torch.profiler`` into a trace
that Perfetto or TensorBoard opens; ``timed`` is the reference's mean wall
time per call, waiting for the card only where ``fn``'s output lies.

``span`` is the one way the port marks its own host work in such a trace
(the ``ecm.*`` spans of ``train/graphs.py``, ``train/steps.py`` and
``train/loop.py``): a ``record_function`` while a profiler records, on the
clock of the card's kernels and copies, and nothing otherwise.

``flops_stereo_parts``, ``flops_stereo_forward`` and ``bytes_stereo_parts``
are the reference's formulas, copied so that they give its values at every
shape (``tests/test_torch_port_profiling.py`` holds them equal). The FLOP
model over-counts the forward in two places, kept here because the port is
held against the reference:

- the 2D 3x3 feature convs are counted at 27 taps, not 9
  (``ecm_tpu/utils/profiling.py:56-63``; the SPP fusion conv at ``:65`` and
  the context convs at ``:72`` use 9);
- the transposed convs deconv5 and deconv6 are counted at their output
  voxels (``:82-83``), 8x their multiply-adds, which run at the input voxels.

``tests/test_torch_port_profiling.py::test_flop_model_against_the_counter``
measures both with ``torch.utils.flop_counter.FlopCounterMode``.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` as a span of the host's work while
    ``torch.profiler`` records (``trace``, or any ``profile``), inside the
    enclosing span of the calling thread. With no profiler on it is one
    shared ``nullcontext``: no ``RecordFunction`` is entered, which a bare
    ``record_function`` does on every call (about 9 us on a CPU). ``name``
    is a constant, so that a trace groups by it."""
    if not torch._C._autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(logdir: str | None = None, device: str = "cuda"):
    """Record the enclosed block with ``torch.profiler`` (the host, and the
    card unless ``device="cpu"``) and write its trace into ``logdir``
    (default ``<tempdir>/ecm_torch_trace``), which Perfetto
    (ui.perfetto.dev) or ``tensorboard --logdir <logdir>`` opens. Yields
    ``logdir``. Raises without a GPU unless ``device="cpu"``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("trace: no CUDA device (pass device='cpu' to trace the host alone)")
        activities.append(ProfilerActivity.CUDA)
    logdir = logdir or os.path.join(tempfile.gettempdir(), "ecm_torch_trace")
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield logdir


def _cuda_devices(out) -> set[torch.device]:
    """The CUDA devices of the tensors in ``out`` (nested tuples, lists and
    dicts)."""
    if isinstance(out, torch.Tensor):
        return {out.device} if out.is_cuda else set()
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        return set().union(*(_cuda_devices(o) for o in out))
    return set()


def _wait(out) -> None:
    for device in _cuda_devices(out):
        torch.cuda.synchronize(device)


def timed(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Seconds per call of ``fn(*args)``: ``warmup`` calls, then one
    wall-clock span over ``iters`` calls, divided by ``iters`` (a mean, not
    a median). Waits for the card of ``fn``'s output tensors after the
    warm-up and after the loop; an output on the CPU needs no wait."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _wait(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _wait(out)
    return (time.perf_counter() - t0) / iters


def flops_stereo_parts(
    h: int,
    w: int,
    max_disp: int,
    c: int = 32,
    layer2_blocks: int = 16,
    num_heads: int = 3,
    regress_mode: str = "fullres",
) -> dict[str, float]:
    """Analytic per-part FLOP counts (multiply-add = 2 FLOPs) of the flagship
    forward, per stereo pair. ``num_heads``: 3 in train, 1 in eval (only
    classif3 runs — reference semantics). Used for roofline/MFU reporting."""
    h2, w2 = h // 2, w // 2
    h4, w4 = h // 4, w // 4
    d4 = max_disp // 4
    f = 0.0
    # stem
    f += 2 * 27 * 3 * 32 * h2 * w2 + 2 * 2 * 27 * 32 * 32 * h2 * w2
    # layer1 (3 blocks, 32ch, H/2)
    f += 3 * 2 * 2 * 27 * 32 * 32 * h2 * w2
    # layer2 (first 32->64 s2 + downsample, rest 64ch, H/4)
    f += 2 * 27 * 32 * 64 * h4 * w4 + 2 * 27 * 64 * 64 * h4 * w4
    f += (layer2_blocks - 1) * 2 * 2 * 27 * 64 * 64 * h4 * w4
    # layer3/4 (3 + 3 blocks, 64->128 then 128ch)
    f += 2 * 27 * 64 * 128 * h4 * w4 + 2 * 27 * 128 * 128 * h4 * w4 * 11
    # SPP convs + fusion
    f += 4 * 2 * 128 * 32 * h4 * w4 + 2 * 9 * 320 * 128 * h4 * w4 + 2 * 128 * 32 * h4 * w4
    features = f * 2  # siamese: both images

    # cost volume (concat): pure data movement, 0 MACs
    cost_vol = 0.0

    # context mapping ("add"): 3x3 conv C2->hidden(128) + 1x1 hidden->c, 4 sites
    ctx = 4 * (2 * 9 * c * 128 * h4 * w4 + 2 * 128 * c * h4 * w4)

    # 3D aggregation
    n = d4 * h4 * w4
    f3 = 2 * 27 * 64 * c * n + 2 * 27 * c * c * n  # dres0
    f3 += 2 * 2 * 27 * c * c * n  # dres1
    per_hg = (
        2 * 27 * c * 2 * c * n / 8  # conv1 s2
        + 2 * 27 * 4 * c * c * n / 8  # conv2 (2c->2c at /8)
        + 2 * 27 * 4 * c * c * n / 64 * 2  # conv3, conv4
        + 2 * 27 * 4 * c * c * n / 8  # deconv5
        + 2 * 27 * 2 * c * c * n  # deconv6 to full volume res
    )
    f3 += 3 * per_hg
    heads = num_heads * (2 * 27 * c * c * n + 2 * 27 * c * 1 * n)

    # regression: trilinear upsample (8 source taps/output) + softmax (exp +
    # 2 FMA) + expectation over D — elementwise, not MACs, but counted so the
    # bytes-heavy fullres path shows a sane intensity
    full_vox = max_disp * h * w
    if regress_mode == "fused":
        regress = num_heads * 12 * full_vox  # all phases computed in VMEM
    else:
        regress = num_heads * (16 + 5) * full_vox
    return {
        "features": features,
        "cost_volume": cost_vol,
        "context": ctx,
        "aggregation": f3,
        "heads": heads,
        "regression": regress,
    }


def flops_stereo_forward(
    h: int, w: int, max_disp: int, c: int = 32, layer2_blocks: int = 16
) -> float:
    """Total analytic FLOPs of the flagship TRAIN forward (3 heads); kept for
    backward compatibility — see ``flops_stereo_parts`` for the breakdown."""
    parts = flops_stereo_parts(
        h, w, max_disp, c=c, layer2_blocks=layer2_blocks, num_heads=3
    )
    return parts["features"] + parts["aggregation"] + parts["heads"]


def bytes_stereo_parts(
    h: int,
    w: int,
    max_disp: int,
    c: int = 32,
    layer2_blocks: int = 16,
    num_heads: int = 3,
    regress_mode: str = "fullres",
    act_bytes: int = 2,
) -> dict[str, float]:
    """Analytic minimum HBM traffic per part, per stereo pair: each conv reads
    its input once and writes its output once (BN/ReLU/bias fused — XLA does
    this); weights are negligible (~5 M params). This is the roofline's
    memory-side bound; achieved GB/s above it means re-reads/spills."""
    s2, s4 = (h // 2) * (w // 2), (h // 4) * (w // 4)
    d4 = max_disp // 4
    n = d4 * s4  # low-res volume voxels
    full_vox = max_disp * h * w

    def convs(layers) -> float:
        return float(sum(ni * ci + no * co for ni, ci, no, co in layers))

    feat_layers = (
        [(h * w, 3, s2, 32), (s2, 32, s2, 32), (s2, 32, s2, 32)]
        + [(s2, 32, s2, 32)] * 6  # layer1: 3 blocks x 2 convs
        + [(s2, 32, s4, 64)]
        + [(s4, 64, s4, 64)] * (2 * layer2_blocks - 1)
        + [(s4, 64, s4, 128)]
        + [(s4, 128, s4, 128)] * 11  # layer3/4
        + [(s4, 128, 0, 32)] * 4  # SPP branch convs (pooled: tiny out)
        + [(0, 0, s4, 32)] * 4  # SPP bilinear upsample writes
        + [(s4, 320, s4, 128), (s4, 128, s4, c)]  # lastconv
    )
    features = 2 * convs(feat_layers)  # siamese x2

    cost_volume = 2 * s4 * c + n * 2 * c  # read fl/fr once, write volume

    # context ("add", 4 sites): 2D convs + volume read-modify-write
    context = 4 * (convs([(s4, c, s4, 128), (s4, 128, s4, c)]) + 2 * n * c)

    agg_layers = [(n, 2 * c, n, c), (n, c, n, c)]  # dres0
    agg_layers += [(n, c, n, c)] * 2  # dres1
    hg = [
        (n, c, n // 8, 2 * c),
        (n // 8, 2 * c, n // 8, 2 * c),
        (n // 8, 2 * c, n // 64, 2 * c),
        (n // 64, 2 * c, n // 64, 2 * c),
        (n // 64, 2 * c, n // 8, 2 * c),  # deconv5
        (n // 8, 2 * c, n, c),  # deconv6
    ]
    aggregation = convs(agg_layers) + 3 * (convs(hg) + 2 * n * c)  # + skip adds

    heads = num_heads * convs([(n, c, n, c), (n, c, n, 1)])

    # regression is counted in raw bytes (its intermediates are f32)
    if regress_mode == "fused":
        # 3 row-block passes over the low-res f32 volume + f32 [H, W] output
        regression_bytes = num_heads * (3 * n * 4 + h * w * 4)
    elif regress_mode == "lowres":
        # D-phase upsample materializes [D, H/4, W/4] f32 (write+read), then
        # the low-res disparity map and the bilinear full-res output
        regression_bytes = num_heads * (
            n * 4 + 2 * (4 * n) * 4 + s4 * 4 + h * w * 4
        )
    else:  # fullres: materialize [D, H, W] f32 (resize write + softargmin read)
        regression_bytes = num_heads * (n * 4 + 2 * full_vox * 4 + h * w * 4)
    parts = {
        "features": features,
        "cost_volume": cost_volume,
        "context": context,
        "aggregation": aggregation,
        "heads": heads,
    }
    out = {k: v * act_bytes for k, v in parts.items()}
    out["regression"] = float(regression_bytes)
    return out
