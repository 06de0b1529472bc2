"""Drive the PyTorch/CUDA port on one GPU and check it.

    python3 chip_smoke.py              # every item below
    python3 chip_smoke.py --only raft  # the build, RAFT's three kernel checks and item 12
    python3 chip_smoke.py --only igev  # the build, IGEV's two kernel checks and item 13

1. Builds the port's CUDA kernels (one nvcc per source, in parallel) and
   holds each against its plain PyTorch version at the main paths' shapes
   in every form the paths use (B=1, 384x1248, max-disp 192, bf16 for the
   serving kernels; B=4, 256x512, max-disp 192 for ``gband_conv_s1``,
   forward and input gradient), timing the kernel, the plain version and,
   where one exists, one cuDNN call of the same function with CUDA events
   (median of 10 runs); for the conv core (``csrc/conv_wgmma.cuh``) also the
   kernel's and cuDNN's device time (torch.profiler) and the plan
   (``cuda_gband.conv_plan``); for the regression and the correlation
   volume the device time by symbol (and the regression's plan,
   ``regression_plan``); for the fused pair (``csrc/fused_conv3d_pair.cu``'s
   wgmma kernel, tiled by ``cuda_fused_agg.pair_plan``) its device time and
   the cuDNN chain's beside the events. The build fails on a ptxas spill in
   any instantiation of the conv core, of the pair's wgmma kernel, of the
   regression or of the correlation kernel, and on a C7520 or C7514 warning
   (wgmma serialised) in the pair's source. Both cost-volume kernels are
   also held over a first, an interior and a last rank's range of
   disparities (``d_start``) of the ``disp`` phase's volume, against their
   plain versions and the same planes of the whole volume: concat bit for
   bit, correlation at 1e-2. RAFT-Stereo's pyramid lookup
   (``csrc/corr1d.cu``) is held against its plain version at the
   ``raft_kitti_b1`` cell's shape (a 96x312 grid, 4 levels, radius 4,
   float16 out) and timed against the cell's bound (``check_corr1d_lookup``).
   Its channels-last instance norm (``ops/instance_norm.py``, three Triton
   kernels) is held against its plain version at ``fnet``'s three float16
   shapes (two images: 64 channels at 384x1248, 96 at 192x624, 128 at
   96x312, five norms each) and timed, a pair's 15 norms, against their
   bytes bound and against the library's NCHW ``F.instance_norm``
   (``check_instance_norm``). Its ConvGRU cell's three Triton kernels
   (``ops/conv_gru.py``: the pack, the gates, the update) are held against
   their plain versions at the cell's three levels (1/4, 1/8, 1/16, float16)
   and timed, a forward's 32 cells of each level, by events and by device
   time against their bytes bound and against the published cell's torch
   ops that they replace, with the host's time a cell of each, and the pack
   against one channel ``cat`` (``check_conv_gru``); each kernel's wrapper
   counts its one launch.
2. Serves ``CONFIGS["kitti_infer"].model.build(...)`` at full width (seeded
   random weights) along four paths, each with every launch count set to 0
   just before it and read just after:
   - slice 1, the standard-layout kernel path (``SLICE_OVERRIDES``): cost
     volume, fused pair and regression kernels 1, 3 and 1 times a forward;
   - slice 2, the grouped layer-kernel path (``SLICE2_OVERRIDES``): cost
     volume 1, ``conv3d_bn_s1`` 4, ``conv3d_bn_down`` 3, ``deconv3d_bn`` 3,
     fused pair 1 and regression 1 times a forward;
   - ``ECMBasic`` with the cost-volume and regression kernels, 1 and 1;
   - ``ECMBasic`` on the correlation volume (``cost_mode="correlation"``),
     correlation kernel 1 and regression 1 a forward.
   The ECMStereo paths serve three pairs at batch 1 and one batch of 8,
   the ECMBasic paths two pairs at batch 1. Each checks the disparity
   (finite, in [0, 191]), the launch counts, and the cost map against the
   plain path (cuDNN convolutions, no kernels) on the same weights, and
   reports the median ms per forward. The correlation path also takes
   apart its cost map's difference from the plain path on eight pairs
   (``correlation_witness``).
3. Profiles a steady window of batch-1 forwards of each path under
   ``ecm_torch.utils.profiling.trace``, read back from the trace file it
   writes: the ECMStereo paths eager and graphed (replays of
   ``make_infer_fn``'s CUDA graph), the ECMBasic paths graphed. Device time
   per kernel, the port's kernels against the rest, and the device's idle
   share of the window; each window must run each of its path's kernels
   once per launch a forward (the grouped path the conv core 10 times: 4 s1
   + 3 down + 3 transposed, and the WMMA core it replaced never; the pair's
   wgmma kernel once per pair launch, grouped 1 and standard 3, its
   CUDA-core kernel and the mma.sync kernel it replaced never) and copy
   nothing from the host. Then ``profiling.timed`` of the same forward.
4. Serves each of the four paths through ``make_infer_fn``, one CUDA graph
   per input shape (``ecm_torch/train/graphs.py``, the counterpart of the
   JAX package's ``jax.jit``), at batch 1 and, for the ECMStereo paths, 8:
   the first call (eager), the second (warm-up and capture) and a replay
   against the eager forward on the same pair (max|diff| expected 0, gated
   at 1e-3 px, the regression's limit), the launches the capture counted
   against the path's a forward, a replay moving no wrapper's count and adding those
   launches to the replayed count; then the eager and the graphed forward,
   median of 10 each on the same pairs (CUDA events), each signature's
   capture time and graph-pool bytes, and item 3's idle shares side by side.
5. Trains ``CONFIGS["sceneflow_single"]`` (slice 3, ``TRAIN_SLICE``): 4
   pairs at 256x512, max-disp 192, bf16, the grouped dispatch, through
   ``train_loop`` on one fixed synthetic batch with ``make_train_step``,
   one CUDA graph per batch signature since slice 15 (the first step eager,
   the second captured, the rest replayed), counts 0 just before and read
   just after: ``gband_conv_s1`` 7 forward and 7 input-gradient launches a
   step, counted by the wrappers for the first two steps and as replayed
   launches for the rest, and no eval kernel; the loss finite and falling.
   Then graphed and eager (``graphed=False``) steps in one call: ms per
   step (median of 10 each), peak memory, a profiled step of each (idle
   share; 14 ``gband_conv_s1`` kernels; device-to-device memcpy under 1 ms:
   the cost volumes' closed-form VJP copies no gradient volume); five
   graphed steps against five eager ones from one seed with cuDNN
   deterministic, a learning-rate drop crossed during the replays (every
   metric, parameter, buffer and Adam tensor equal, or within twice the
   spread of a second eager run), with the capture's ms and pool bytes;
   then one step of the grouped path against one of the standard (cuDNN)
   path on the same weights and batch.
6. Runs the command-line interfaces (``ecm_torch.cli``) in-process on files it
   writes to a temporary directory, each with the launch counts set to 0
   just before and read just after: ``train`` (``sceneflow_single``) on a
   SceneFlow-layout tree of 8 pairs at 540x960 for 4 steps, then again to
   step 6, which must auto-resume from step 4 and leave checkpoints 4 and 6
   (``gband_conv_s1`` 7 + 7 launches a step, no eval kernel; each run's
   train step one CUDA graph, ``_steps``); ``finetune`` from that checkpoint
   on a KITTI 2015-layout tree (4 training pairs at 375x1242, uint16
   ground truth) for 4 steps, its validation eval every 2 (the preset's
   interval replaced for the run), the last after two replayed train steps,
   within 1e-3 of ``evaluate`` on the checkpoint it wrote; ``evaluate`` on the KITTI
   validation split (finite metrics; 4/3/3/1/1 launches of ``conv3d_bn_s1``
   / ``_down`` / ``deconv3d_bn`` / the classif pair / the regression a pair,
   plus 1 of the concat kernel with ``--pallas``); ``submission`` on the 4
   test pairs (375x1242 uint16 PNGs, each within one code of the
   disparity computed here with the same weights). The eval CLIs serve
   their pairs of one shape through one CUDA graph: the first pair runs
   eagerly, the second's warm-up counts a pair's launches and its capture
   none, and every later pair adds them to the replayed count (``_pairs``);
   finetune's second validation replays the first's graph, which reads the
   weights its train steps updated in place. Then ``test_img
   --synthetic`` as a subprocess with no device flag. It reports the train
   CLI's pairs/s, the DataLoader's own rate, the checkpoint's size and its
   save and restore times, and the submission's ms a pair; and packs the 8
   pairs' 256x512 crops into two TFRecord shards
   (``ecm_torch.data.tfrecord``), reads them back equal and reports the
   host's MB/s each way.
7. Runs slice 9's data axis (``ecm_torch.parallel``) on the one card. NCCL
   takes one rank a card, so two ranks that share it reduce over gloo, which
   takes CUDA tensors:
   - the dry run (``python -m ecm_torch.parallel.dryrun``, the counterpart
     of ``__graft_entry__.dryrun_multichip``): two ranks on cuda:0 against
     one process, loss and updated-parameter norm;
   - ``CONFIGS["sceneflow_dp"]`` at full width (12 seeded 256x512 pairs,
     max-disp 192, bf16, ``remat`` on, the grouped dispatch; the heads'
     conv2 scaled by 1e-3): one process's step on the 12 pairs against two
     ranks of 6 from the same weights, the second rank's ground truth mostly
     invalid so that the ranks' valid-pixel counts differ: the logged loss
     at rel <= 2e-2, the seven ``gband_conv_s1`` weight gradients at cosine
     >= 0.99, every BatchNorm running statistic at rel <= 2e-2, and on each
     rank 7 + 7 ``gband_conv_s1`` launches and no other kernel (counted in
     the ranks, 0 just before the step); ``gband_conv_s1`` is held against
     its plain version at a rank's 6 pairs first. Each rank's ms a step and
     peak memory are printed as gloo on one shared card: they are not
     scaling numbers;
   - ``python -m torch.distributed.run --nproc_per_node 1 -m
     ecm_torch.cli.train --multihost`` (NCCL at world size 1, DDP) for 2
     steps of ``sceneflow_dp`` on a SceneFlow-layout tree, whose checkpoint
     the single-process ``evaluate`` then restores.
8. Runs slice 10's disparity axis (``ecm_torch.parallel.halo``) on the one
   card: four ranks of ``dryrun.launch`` share cuda:0 over gloo, each with
   1/4 of the disparities at every level of the 3D stack:
   - ``CONFIGS["middlebury_disp_sharded"]`` (BASELINE config 4, max-disp
     384, width 32, bf16) with ``SLICE2_OVERRIDES`` at full width on one
     seeded synthetic 1024x1504 pair (a Middlebury 2014 half-resolution
     frame padded to a multiple of 32), random weights from seed 0, against
     one process on the same pair: the gathered cost map at <= 3e-2, on
     each rank 1/4/3/3/1/1 launches of the concat / ``conv3d_bn_s1`` /
     ``_down`` / ``deconv3d_bn`` / pair / regression kernels a forward (0
     just before, read just after), the disparity finite in [0, 383] and
     the same on every rank;
   - the same model in f32 on a 256x512 pair, the heads' conv2 scaled so
     that the largest cost is 10 (``DISP_COST_MAX``): the disparity within
     1e-3 px of one process's;
   - ``python -m torch.distributed.run --nproc_per_node 4 -m
     ecm_torch.cli.evaluate --config middlebury_disp_sharded --multihost
     --mesh-disp 4 --dist-backend gloo`` (f32, ``--pallas``, from a
     checkpoint with the f32 check's heads) on a Middlebury-layout tree of
     2 scenes at 480x640, against ``evaluate`` in this process: every
     metric within 1e-3.
   It prints each rank's and the one process's ms a forward (median of 5),
   peak memory and halo and gather traffic a forward, and the phase's wall
   time. Four ranks on one card measure correctness and memory per rank,
   not scaling.
9. Trains on slice 11's disparity axis on the one card: four ranks of
   ``dryrun.launch`` share cuda:0 over gloo as a ``(data 2, disp 2)`` grid,
   each with its 6 pairs and half of the disparities at every level:
   - ``gband_conv_s1`` against its plain version at a rank's halo-padded
     slab, 6 x 25 planes (24 + one from its neighbour) and 6 x 26 (an
     interior rank's), forward and input gradient at 2e-2, and the time of
     the copy that cropping such a slab to 24 planes makes;
   - one ``sceneflow_dp`` step (the parallel phase's weights and 12 pairs)
     against the parallel phase's one-process step: the logged loss at rel
     <= 2e-2, the weight gradients of the seven ``gband_conv_s1`` sites and
     of a 3D BatchNorm at cosine >= 0.99 and a norm ratio within [0.97,
     1.03] (a missing sum over disp scales them by 1/2, which a cosine does
     not see), every running statistic at rel <= 2e-2, and on each rank 7 +
     7 ``gband_conv_s1`` launches and no other kernel (0 just before the
     step); each rank's ms a step (3 timed), peak memory, and halo (forward
     and backward apart) and gather traffic. The first feature conv's bf16
     gradient is printed, not gated: one process's bf16 step against its
     f32 step, also printed, shows it mostly rounding noise; so the same
     step in f32 on 4 of the pairs (2 a data row) holds all nine weight
     gradients, the feature conv's included, at those limits, with the
     loss and the statistics;
   - ``python -m torch.distributed.run --nproc_per_node 2 -m
     ecm_torch.cli.train --multihost --mesh-disp 2 --dist-backend gloo
     --device cuda:0`` for 2 steps of ``sceneflow_dp`` on the cli phase's
     SceneFlow-layout tree (a finite loss, one checkpoint, rank 0 alone
     printing the mesh), whose checkpoint ``evaluate`` then restores in
     this process.
10. Runs the JAX package's convergence gate (``benchmarks/overfit_gate.py``)
   through the port's train CLI, ``ecm_torch.cli.train.main(["--config",
   preset, "--savemodel", dir])`` in-process on cuda:0, for both presets,
   ``overfit_gate`` (f32) and ``overfit_gate_grouped`` (bf16), each 600
   steps over 4 fixed synthetic batches of 2 x 128x256. The CLI's
   ``--maxdisp`` (default 192) overrides the presets' max-disp (48, 64), as
   ``ecm_tpu``'s CLI does, so both train the grouped dispatch at max-disp
   192: ``gband_conv_s1`` 7 + 7 launches a step (counts 0 just before and
   read just after each run), 598 of its 600 steps replays of its train
   step's CUDA graph. Each must end
   with an EPE below 2.0 px at step 600 and log only finite losses; it
   prints the first (step 50) and last logged loss and EPE, the wall time
   and the median ms a step, beside the TPU's result of
   ``benchmarks/OVERFIT.json`` as context.
11. Reports ``ecm_torch.utils.profiling`` on the grouped batch-1
   ``kitti_infer`` forward: item 3's trace and ``timed`` of the forward
   beside the serving phase's CUDA-event median; the analytic FLOPs a pair
   (``flops_stereo_parts``, which over-counts) and the convolutions' FLOPs
   that ``torch.utils.flop_counter.FlopCounterMode`` counts over one
   forward of the plain path, each with the TFLOP/s it implies at the
   grouped path's batch-8 ms a pair.
12. Serves RAFT-Stereo (``build_model("raft_stereo")``, float16, the
   ``raft_kitti_b1`` cell's sizes, seeded random weights) through
   ``make_infer_fn`` on one 384x1248 pair: eager, captured, then one replay
   with every launch count set to 0 just before it, which must equal the
   eager forward bit for bit and run 32 lookups, 15 instance norms and 96
   ConvGRU cells, 96 launches of each of its three kernels (replayed, none
   counted by the wrappers) and no other kernel of the port;
   then the graphed and the
   eager forward's median ms, the capture's ms and pool, and the peak
   reserved memory (``raft_phase``).
13. Serves IGEV-Stereo (``build_model("igev_stereo")``, float16, the
   ``igev_kitti_b1`` cell's sizes, seeded random weights) the same way: the
   replay equal to the eager forward bit for bit, one group-wise volume, 32
   geometry lookups, 12 instance norms and 96 ConvGRU cells a replay and no
   other kernel of the port; the device operations a replay runs, the
   graphed and eager medians, the capture and the peak (``igev_phase``).
   Its two kernels are held in item 1: the combined lookup
   (``csrc/geo_lookup.cu``) against its plain version at the cell's shape,
   float16 out, timed against the cell's bound (``check_geo_lookup``); the
   correlation kernel at 8 groups of 12 float16 channels against its plain
   version, and at one group (ECM's launch, counted as ECM's) bit for bit
   the kernel called without ``groups`` (``check_gwc_volume``).
14. Prints the ``{"kernels": [...]}`` line (each kernel's launches a
   forward on its main path: the lookup's, the instance norm's and each
   of the ConvGRU's kernels' a RAFT replay, the geometry lookup's and the
   group-wise volume's an IGEV replay), the card's name
   and power limit, and last ``{"ok": true, "device": {...}}``.

Any failed check raises, and the script exits nonzero without the last line.
It needs a CUDA device and the rest of the repository beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import itertools
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ecm_torch.cli import common as cli_common
from ecm_torch.cli import evaluate as cli_evaluate
from ecm_torch.cli import finetune as cli_finetune
from ecm_torch.cli import submission as cli_submission
from ecm_torch.cli import train as cli_train
from ecm_torch.configs import CONFIGS
from ecm_torch.configs.base import SLICE2_OVERRIDES, SLICE_OVERRIDES, TRAIN_SLICE
from ecm_torch.data import kitti, make_batch, make_pair, tfrecord, write_pfm
from ecm_torch.data.pipeline import PipelineConfig, make_train_pipeline
from ecm_torch.data.preprocess import unpad
from ecm_torch.data.sceneflow import list_sceneflow
from ecm_torch.data.sceneflow import load_sample as sceneflow_load_sample
from ecm_torch.kernels import build
from ecm_torch.models import build_model
from ecm_torch.ops import conv_gru as grk
from ecm_torch.ops import cuda_corr1d as corrk
from ecm_torch.ops import cuda_cost_volume as cvk
from ecm_torch.ops import cuda_fused_agg as pairk
from ecm_torch.ops import cuda_geo_lookup as geok
from ecm_torch.ops import cuda_gband as gbk
from ecm_torch.ops import cuda_gdeconv as gdk
from ecm_torch.ops import cuda_regression as regk
from ecm_torch.ops import instance_norm as ink
from ecm_torch.ops.launches import COUNTERS, read_counts, read_replayed, reset_counts
from ecm_torch.parallel import dryrun
from ecm_torch.train import checkpoint as ckpt_lib
from ecm_torch.train.loop import to_device, train_loop
from ecm_torch.train.loss import stereo_loss
from ecm_torch.train.state import create_train_state, make_optimizer
from ecm_torch.train.steps import make_infer_fn, make_train_step
from ecm_torch.utils import profiling

B, H, W, MAX_DISP, C = 1, 384, 1248, 192, 32
D4, H4, W4 = MAX_DISP // 4, H // 4, W // 4
TB, (TH, TW) = CONFIGS[TRAIN_SLICE].data.global_batch, CONFIGS[TRAIN_SLICE].data.crop
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 on the CUDA cores
SFU_PER_CLOCK_PER_SM, SMS = 16, 132
RUNS = 10
# torch.profiler once returned none of the 10 correlation kernels of a window
# whose output had just been checked (H100, torch 2.11): device_ms profiles a
# window again when it misses some of the calls' kernels
PROFILE_ATTEMPTS = 3
PAIR_REL_TOL = 2e-2  # max|diff| / max|ref| in bf16 (tests/test_fused_agg.py:81); also the conv kernels
REGRESSION_TOL_PX = 1e-3
COST4_REL_TOL = 3e-2  # bf16 network, rounded at other places (9.9e-3 measured on an H100)
CORR_REL_TOL = 1e-2  # f32 sums of the same products in another order, one bf16 rounding
# the correlation path's cost map against the plain path's, on each pair of
# CORR_WITNESS_SEEDS; what it is made of is checked exactly by
# correlation_witness (3-9 volume entries of 1.44 M differ by one bf16
# spacing, which the plain network amplifies 4.7-6.8x). Read on an H100 over
# these eight pairs: 2.372e-2 to 3.334e-2; held at 1.5x the largest.
COST4_CORR_REL_TOL = 5e-2
CORR_WITNESS_SEEDS = (1, 2, 3, 4, 5, 6, 7, 8)
TRAIN_LOSS_REL_TOL = 2e-2  # one grouped step against one cuDNN step, bf16
TRAIN_GRAD_COSINE = 0.99  # the seven kernel-conv weight gradients, same comparison
TRAIN_STEPS = 20  # train_loop steps on one fixed batch; the loss must fall
GRAPH_CHECK_STEPS = 5  # graphed steps held against eager ones: 1 eager, 1 captured, 3 replays
# device-to-device copies in a profiled train step (12.75 ms when autograd
# cloned the gradient volume at each of the plain builder's 96 slice
# assignments; the closed-form VJP copies none of it)
TRAIN_MEMCPY_MS = 1.0
MEMCPY_DTOD = "memcpy device to device"
PLAIN = dict(agg_layout="standard", agg_fused="off", use_pallas=False, regress_mode="fullres")
PLAIN_BASIC = dict(use_pallas=False, regress_mode="fullres")
OUT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"
# the raft_kitti_b1 cell's configuration: the lookup's shape and bound, and
# the RAFT phase's model
RAFT_CFG = json.loads((Path(__file__).resolve().parent / "stereo_bench" / "configs" / "raft_kitti.json").read_text())
LOOKUP = "corr1d_lookup_kernel"
# fnet's instance norms on a pair (two images) at the cell's size: shape and
# norms a forward (the stem's and layer1's at full size, layer2's and
# layer3's at 1/2 and 1/4, three in each layer's first block)
FNET_NORMS = (((2, 64, H, W), 5), ((2, 96, H // 2, W // 2), 5), ((2, 128, H // 4, W // 4), 5))
# the cell's ConvGRU levels (gru08, gru16, gru32 at 1/4, 1/8, 1/16): the
# inputs' channels beside the state's 128, and the map's size
GRU_KERNELS = ("conv_gru_pack", "conv_gru_gate", "conv_gru_update")  # each counted by its own wrapper
# the igev_kitti_b1 cell's configuration: the lookup's and the group-wise
# volume's shapes and bounds, and the IGEV phase's model
IGEV_CFG = json.loads((Path(__file__).resolve().parent / "stereo_bench" / "configs" / "igev_kitti.json").read_text())
GEO_LOOKUP = "geo_lookup_kernel"
# a forward's instance norms in IGEV-Stereo: the feature decoder's 7, the
# stems' 4, the descriptor's conv's 1 (both images in one call each)
IGEV_NORMS = 12
GRU_LEVELS = (((128, 128), H // 4, W // 4), ((128, 128), H // 8, W // 8), ((128,), H // 16, W // 16))
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


def device_events(prof) -> list:
    """The kernels and copies of a torch.profiler run (not the annotations
    that the profiler also puts on the device timeline)."""
    from torch.autograd import DeviceType

    return [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]


def device_ms(fn, symbol: str, runs: int = RUNS) -> float:
    """Mean device time of the kernels named ``symbol`` per call of ``fn``
    (torch.profiler): for a kernel so short that the CUDA-event time of a
    call is the host's launch time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        events = [e for e in device_events(prof) if symbol in e.name]
        if len(events) == runs:
            return sum(e.time_range.end - e.time_range.start for e in events) / 1e3 / runs
        log(f"  device_ms: profiled {len(events)} {symbol} kernels for {runs} calls (attempt {attempt})")
    raise AssertionError(f"profiled {len(events)} {symbol} kernels for {runs} calls, {PROFILE_ATTEMPTS} times")


def device_total_ms(fn, runs: int = RUNS) -> float:
    """Mean device time of everything ``fn`` runs on the card per call
    (torch.profiler, all kernels and copies): for a library call that may
    launch more than one kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.end - e.time_range.start for e in device_events(prof)) / 1e3 / runs


def ptxas_report(text: str) -> dict:
    """Registers and spill bytes of each kernel in an ``nvcc -Xptxas -v``
    log, by (mangled) function name."""
    report, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            fn = m.group(1)
            report.setdefault(fn, {})
        elif fn and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            report[fn].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif fn and (m := re.search(r"Used (\d+) registers", line)):
            report[fn]["registers"] = int(m.group(1))
    return report


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
        device_ms=device_ms(lambda: cvk.cost_volume_concat(fl, fr, D4), "concat_kernel"),
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
    """The pair in its three main-path forms: each on the wgmma route
    (``pair_plan``, and the route's launch count), against its plain
    version; its plan (tile, items, blocks, ring, k1 resident, shared
    memory, stage-1 recompute) beside the times: the kernel's by events and
    device time, the cuDNN chain's by events and device time."""
    forms = []
    for form in ("dres0", "dres1", "classif3"):
        args, opts = _pair_inputs(gen, form)
        x, k1, _, _, k2, _, _, ctx = args
        plan = pairk.pair_plan(x.dtype, *x.shape, k1.shape[0], k2.shape[0],
                               torch.cuda.get_device_properties(0).multi_processor_count)
        if plan.route != "wgmma":
            raise AssertionError(f"fused_conv3d_pair[{form}] plans the {plan.route} route")
        before = pairk.fused_conv3d_pair.route_launches["wgmma"]
        out = pairk.fused_conv3d_pair(*args, **opts)
        torch.cuda.synchronize()
        if pairk.fused_conv3d_pair.route_launches["wgmma"] != before + 1:
            raise AssertionError(f"fused_conv3d_pair[{form}] did not launch the wgmma kernel")
        ref = pairk.fused_conv3d_pair_torch(*args, **opts)
        err = (out.float() - ref.float()).abs().max().item()
        rel = err / ref.float().abs().max().item()
        if not rel <= PAIR_REL_TOL:
            raise AssertionError(f"fused_conv3d_pair[{form}] rel err {rel} > {PAIR_REL_TOL}")
        vox = x.shape[0] * x.shape[1] * x.shape[2] * x.shape[3]
        flops = 2 * 27 * vox * (k1.shape[1] * k1.shape[0] + k2.shape[1] * k2.shape[0])
        bound_ms, by = bound(flops, PEAK_BF16_FLOPS, nbytes(x, ctx, out) + 2 * (k1.numel() + k2.numel()))
        xcf, w1, w2 = x.movedim(-1, 1), k1.bfloat16(), k2.bfloat16()

        def chain(xcf=xcf, w1=w1, w2=w2):  # yardstick: the two cuDNN convolutions, no epilogues
            return F.conv3d(F.conv3d(xcf, w1, padding=1), w2, padding=1)

        forms.append(dict(
            form=form, route=plan.route, plan=plan._asdict(), max_abs_err=err, rel_err=rel, gflop=flops / 1e9,
            ms=time_ms(lambda: pairk.fused_conv3d_pair(*args, **opts)),
            device_ms=device_ms(lambda: pairk.fused_conv3d_pair(*args, **opts), PAIR_WGMMA),
            plain_ms=time_ms(lambda: pairk.fused_conv3d_pair_torch(*args, **opts)),
            library_ms=time_ms(chain), library_device_ms=device_total_ms(chain),
            bound_ms=bound_ms, bound_by=by,
        ))
        f = forms[-1]
        log(f"  fused_conv3d_pair[{form}]: {plan}; rel err {rel:.3e}, {f['ms']:.3f} ms (device "
            f"{f['device_ms']:.3f}, {flops / f['device_ms'] / 1e9:.1f} TFLOP/s; plain {f['plain_ms']:.3f}; "
            f"cuDNN convs {f['library_ms']:.3f}, device {f['library_device_ms']:.3f}; bound {bound_ms:.4f})")
    total = {k: sum(f[k] for f in forms) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return dict(
        name="fused_conv3d_pair", route="cuda", source="ecm_torch/csrc/fused_conv3d_pair.cu",
        replaces="ecm_tpu/ops/pallas_fused_agg.py:436",
        max_abs_err=max(f["max_abs_err"] for f in forms),
        bound_by="operations" if all(f["bound_by"] == "operations" for f in forms) else "bytes",
        forms=forms, **total,
    )


def check_regression(gen, sm_clock_hz: float) -> dict:
    """The regression at the kitti_infer shape: against its plain version,
    its plan (``regression_plan``) and its device time by symbol beside the
    CUDA-event time."""
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
        plan=regk.regression_plan(*cost4.shape)._asdict(),
        ms=time_ms(lambda: regk.fused_upsample_softargmin(cost4, MAX_DISP)),
        device_ms=device_ms(lambda: regk.fused_upsample_softargmin(cost4, MAX_DISP), REGRESSION),
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
    calls on its kernel path) with CUDA events, and the kernel's and cuDNN's
    device time with torch.profiler (the kernel's symbol; all of cuDNN's
    device events). ``forms``: (form, kernel, plain, library, ops, bytes,
    plan); a form with a ``conv_plan`` must plan the tensor-core route and
    launch ``CONV_WGMMA``."""
    rows = []
    for form, kern, plain, lib, ops, moved, plan in forms:
        if plan is not None and plan.route != "tensor_cores":
            raise AssertionError(f"{name}[{form}] plans the {plan.route} route")
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
            ms=time_ms(kern), device_ms=device_ms(kern, CONV_WGMMA) if plan is not None else None,
            plain_ms=time_ms(plain), library_ms=time_ms(lib), library_device_ms=device_total_ms(lib),
            bound_ms=bound_ms, bound_by=by, plan=None if plan is None else plan._asdict(),
        ))
        r = rows[-1]
        log(f"  {name}[{form}]: rel err {rel:.3e}, {r['ms']:.3f} ms (device {r['device_ms']}; plain "
            f"{r['plain_ms']:.3f}, cuDNN {r['library_ms']:.3f}, device {r['library_device_ms']:.3f}; "
            f"ratio {r['ms'] / r['library_ms']:.2f} by events; bound {bound_ms:.4f} {by}; plan {r['plan']})")
    total = {k: sum(f[k] for f in rows) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        max_abs_err=max(f["max_abs_err"] for f in rows),
        bound_by="operations" if all(f["bound_by"] == "operations" for f in rows) else "bytes",
        forms=rows, **total,
    )


def conv_plan(mode: str, x: torch.Tensor, cout: int):
    """The plan the conv wrappers launch for x and cout on this card."""
    return gbk.conv_plan(mode, x.dtype, *x.shape, cout, torch.cuda.get_device_properties(0).multi_processor_count)


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
            2 * 27 * vox * cin * C, nbytes(x, a) + 2 * w.numel(), conv_plan("s1", x, C),
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
        2 * 27 * out_vox * C * 2 * C, nbytes(x) + 2 * w.numel(), conv_plan("s2", x, 2 * C),
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
        2 * B * taps * 2 * C * C, nbytes(x, a) + 2 * w.numel(), conv_plan("transposed", x, C),
    )
    return check_forms(
        "deconv3d_bn", "ecm_torch/csrc/deconv3d_bn.cu", "ecm_tpu/ops/pallas_gdeconv.py:213", [form]
    )


def correlation_rounding(vol: torch.Tensor, fl: torch.Tensor, fr: torch.Tensor) -> float:
    """How far a bf16 correlation volume lies from the f64 mean of the same
    products, as a share of what an f32 sum and one bf16 rounding may give:
    half a bf16 spacing plus the f32 sum's error bound ``gamma_(C-1) *
    mean |p|`` (u = 2^-24, any order of the sum). At most 1 for a volume
    whose only errors are those roundings."""
    _, _, w, c = fl.shape
    ref = torch.zeros(vol.shape[:4], dtype=torch.float64, device=fl.device)
    mag = torch.zeros_like(ref)
    for d in range(min(vol.shape[1], w)):
        p = fl[:, :, d:].double() * fr[:, :, : w - d].double()
        ref[:, d, :, d:], mag[:, d, :, d:] = p.mean(-1), p.abs().mean(-1)
    v = vol[..., 0].double()
    _, e = torch.frexp(torch.maximum(v.abs(), ref.abs()))
    gamma = (c - 1) * 2.0**-24 / (1 - (c - 1) * 2.0**-24)
    # + one f32 rounding of the scaling by 1/C (exact when C is a power of 2)
    allowed = 0.5 * torch.ldexp(torch.ones_like(ref), e - 8) + gamma * mag + 2.0**-24 * ref.abs()
    return ((v - ref).abs() / allowed).max().item()


def bf16_spacings(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``|a - b|`` of two bf16 tensors in bf16 spacings at the larger one."""
    a, b = a.double(), b.double()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    return (a - b).abs() / torch.ldexp(torch.ones_like(a), e - 8)


def check_correlation(gen) -> dict:
    """The correlation volume at the kitti_infer shape (its serving path):
    against its plain version, and each entry within one bf16 rounding and
    the f32 sum's error of the f64 correlation (``correlation_rounding``)."""
    fl = _rnd(gen, B, H4, W4, C).bfloat16()
    fr = _rnd(gen, B, H4, W4, C).bfloat16()
    out = cvk.cost_volume_correlation(fl, fr, D4)
    torch.cuda.synchronize()
    ref = cvk.cost_volume_correlation_torch(fl, fr, D4)
    err = (out.float() - ref.float()).abs().max().item()
    rel = err / ref.float().abs().max().item()
    if not rel <= CORR_REL_TOL:
        raise AssertionError(f"cost_volume_correlation rel err {rel} > {CORR_REL_TOL}")
    rounding = correlation_rounding(out, fl, fr)
    if not rounding <= 1.0:
        raise AssertionError(f"cost_volume_correlation: {rounding} x one rounding off the f64 correlation")
    # multiply-adds this input needs: columns w >= d only
    fmas = B * H4 * C * sum(max(W4 - d, 0) for d in range(D4))
    bound_ms, by = bound(2 * fmas, PEAK_F32_FLOPS, nbytes(fl, fr, out))
    return dict(
        name="cost_volume_correlation", route="cuda", source="ecm_torch/csrc/cost_volume.cu",
        replaces="ecm_tpu/ops/pallas_cost_volume.py:150", max_abs_err=err, rel_err=rel,
        roundings=rounding,
        ms=time_ms(lambda: cvk.cost_volume_correlation(fl, fr, D4)),
        device_ms=device_ms(lambda: cvk.cost_volume_correlation(fl, fr, D4), CORRELATION),
        plain_ms=time_ms(lambda: cvk.cost_volume_correlation_torch(fl, fr, D4)),
        bound_ms=bound_ms, bound_by=by, library_ms=None,
    )


def check_gband_conv_s1(gen) -> dict:
    """``gband_conv_s1`` at the train shape (B=4, 48x64x128): the forward
    forms 64->32 (dres0_1) and 32->32 (the other six sites) and the input
    gradients 32->64 and 32->32, each with its cuDNN yardstick
    (``F.conv3d``, ``torch.nn.grad.conv3d_input``). The weight gradient,
    which the port leaves to cuDNN as JAX leaves it to XLA, is timed beside
    each forward form (``wgrad_ms``)."""
    b, d, h, w = TB, MAX_DISP // 4, TH // 4, TW // 4
    vox = b * d * h * w
    forms, wgrad = [], {}
    for cin in (2 * C, C):
        x = _rnd(gen, b, d, h, w, cin).bfloat16()
        wt = _rnd(gen, C, cin, 3, 3, 3, scale=(27 * cin) ** -0.5)
        dy = _rnd(gen, b, d, h, w, C).bfloat16()
        xcf, wb, dycf = x.movedim(-1, 1), wt.bfloat16(), dy.movedim(-1, 1)

        def fwd(x=x, wt=wt):
            with torch.no_grad():
                return gbk.gband_conv_s1(x, wt)

        forms.append((
            f"forward {cin}->{C}", fwd,
            lambda x=x, wt=wt: gbk.gband_conv_s1_torch(x, wt),
            lambda xcf=xcf, wb=wb: F.conv3d(xcf, wb, padding=1),
            2 * 27 * vox * cin * C, nbytes(x) + 2 * wt.numel(), conv_plan("s1", x, C),
        ))
        forms.append((
            f"input grad {C}->{cin}",
            lambda dy=dy, wt=wt: gbk.gband_conv_s1_input_grad(dy, wt.bfloat16()),
            lambda dy=dy, wt=wt: gbk.gband_conv_s1_torch(dy, wt.flip(2, 3, 4).transpose(0, 1)),
            lambda xcf=xcf, wb=wb, dycf=dycf: torch.nn.grad.conv3d_input(xcf.shape, wb, dycf, padding=1),
            2 * 27 * vox * cin * C, nbytes(dy) + 2 * wt.numel(), conv_plan("s1", dy, cin),
        ))
        wgrad[f"{cin}->{C}"] = time_ms(lambda xcf=xcf, wb=wb, dycf=dycf: torch.ops.aten.convolution_backward(
            dycf, xcf, wb, None, [1, 1, 1], [1, 1, 1], [1, 1, 1], False, [0, 0, 0], 1, [False, True, False]))
    result = check_forms(
        "gband_conv_s1", "ecm_torch/csrc/conv3d_bn.cu", "ecm_tpu/ops/pallas_gband.py:963", forms
    )
    result["cudnn_wgrad_ms"] = wgrad
    return result


def check_corr1d_lookup(gen) -> dict:
    """RAFT-Stereo's pyramid lookup at the ``raft_kitti_b1`` shape (a 96x312
    grid, 4 levels of the float32 volume of 256-channel features, radius 4,
    float16 out, as the model calls it) against its plain version, with
    coordinates inside, on and past both borders and in (-1, 0), at the
    tolerance of ``tests/test_torch_port_raft_cuda.py``: the plain version's
    ``grid_sample`` moves x by up to ~4 float32 units in the last place of
    the row's width, times the row's slope (at most twice its largest
    value), and float16 rounds once more. Its bound is the cell's
    (``stereo_bench/families/raftstereo.lookup_form``, bytes). No TPU kernel
    has this function."""
    from stereo_bench import counts
    from stereo_bench.families import raftstereo

    s = RAFT_CFG["shapes"]
    ds = 2 ** s["n_downsample"]
    h, w, r = s["height"] // ds, s["width"] // ds, s["corr_radius"]
    pyramid = corrk.corr_pyramid(_rnd(gen, 1, s["fnet_dim"], h, w), _rnd(gen, 1, s["fnet_dim"], h, w),
                                 s["corr_levels"])
    x = torch.arange(w, device="cuda", dtype=torch.float32).expand(1, 1, h, w)
    flow = (torch.rand(1, 1, h, w, generator=gen, device="cuda") - 0.7) * 1.4 * w
    xs = torch.cat([x[..., : w // 2] + flow[..., : w // 2], torch.full_like(x[..., w // 2:], -0.5)], -1)
    xs[..., -8:] = torch.tensor([-1.0, 0.0, w - 1.0, w - 0.5, float(w), -3.7, w + 4.2, -0.25], device="cuda")
    ys = torch.arange(h, device="cuda", dtype=torch.float32).view(1, 1, h, 1).expand(1, 1, h, w)
    coords = torch.cat([xs, ys], 1).contiguous()
    out = corrk.corr1d_lookup(pyramid, coords, r, torch.float16)
    torch.cuda.synchronize()
    ref = corrk.corr1d_lookup_torch(pyramid, coords, r)
    atol = 4 * torch.finfo(torch.float32).eps * w * 2 * pyramid[0].abs().max().item()
    torch.testing.assert_close(out.float(), ref, rtol=torch.finfo(torch.float16).eps, atol=atol)
    return dict(
        name="corr1d_lookup", route="cuda", source="ecm_torch/csrc/corr1d.cu", replaces=None,
        max_abs_err=(out.float() - ref).abs().max().item(), atol=atol,
        ms=time_ms(lambda: corrk.corr1d_lookup(pyramid, coords, r, torch.float16)),
        device_ms=device_ms(lambda: corrk.corr1d_lookup(pyramid, coords, r, torch.float16), LOOKUP),
        plain_ms=time_ms(lambda: corrk.corr1d_lookup_torch(pyramid, coords, r, torch.float16)),
        bound_ms=counts.bound_s(raftstereo.lookup_form(RAFT_CFG, 1)) * 1e3, bound_by="bytes", library_ms=None,
    )


def check_instance_norm(gen) -> dict:
    """RAFT-Stereo's channels-last instance norm (``ops/instance_norm.py``'s
    Triton kernels) at ``fnet``'s float16 shapes (``FNET_NORMS``) against
    its plain version on the same values, at the tolerance of
    ``tests/test_torch_port_raft_cuda.py``: a few float32 roundings of the
    largest output (another order of the sums) and one float16 rounding.
    The times are a pair's (each shape's norms a forward): the kernels,
    the plain version, and the library's ``F.instance_norm`` on the NCHW
    tensor, which the channels-last model cannot call without a layout
    copy each way; the bound reads each input once and writes each output
    once. No TPU kernel has this function."""
    if (H, W) != (RAFT_CFG["shapes"]["height"], RAFT_CFG["shapes"]["width"]):
        raise AssertionError(f"FNET_NORMS: {H}x{W} is not the raft_kitti_b1 cell's size")
    rows, err, atol = [], 0.0, 0.0
    for shape, n in FNET_NORMS:
        b, c = shape[:2]
        x = _rnd(gen, *shape, scale=3.0) + _rnd(gen, b, c, 1, 1, scale=4.0)
        x = x.to(torch.float16, memory_format=torch.channels_last)
        ink.instance_norm.launches = 0
        out = ink.instance_norm(x)
        torch.cuda.synchronize()
        ref = ink.instance_norm_torch(x)
        if ink.instance_norm.launches != 1 or not out.is_contiguous(memory_format=torch.channels_last):
            raise AssertionError(f"instance_norm {shape}: {ink.instance_norm.launches} launches, strides "
                                 f"{out.stride()}")
        tol = 8 * torch.finfo(torch.float32).eps * ref.abs().max().item()
        torch.testing.assert_close(out.float(), ref.float(), rtol=torch.finfo(torch.float16).eps, atol=tol)
        err, atol = max(err, (out.float() - ref.float()).abs().max().item()), max(atol, tol)
        nchw = x.contiguous()
        rows.append(dict(
            shape=list(shape), norms=n, ms=time_ms(lambda: ink.instance_norm(x)),
            device_ms=device_total_ms(lambda: ink.instance_norm(x)),
            plain_ms=time_ms(lambda: ink.instance_norm_torch(x)),
            library_ms=time_ms(lambda: F.instance_norm(nchw)),
            bound_ms=bound(0, PEAK_BF16_FLOPS, nbytes(x, out))[0],
        ))
        log(f"  instance_norm {shape}: max|err| {(out.float() - ref.float()).abs().max().item():.3e}, "
            f"{rows[-1]['ms']:.4f} ms (device {rows[-1]['device_ms']:.4f}), plain {rows[-1]['plain_ms']:.4f}, "
            f"library NCHW {rows[-1]['library_ms']:.4f}; bound {rows[-1]['bound_ms']:.4f} ms a norm")
    total = {k: sum(r["norms"] * r[k] for r in rows) for k in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms")}
    return dict(name="instance_norm", route="triton", source="ecm_torch/ops/_instance_norm_triton.py",
                replaces=None, max_abs_err=err, atol=atol, bound_by="bytes", kernels_a_launch=3,
                forms=rows, **total)


def check_conv_gru(gen) -> dict:
    """RAFT-Stereo's ConvGRU kernels (``ops/conv_gru.py``: the pack, the
    gates, the update) at the cell's three levels (``GRU_LEVELS``, float16,
    a state in (-1, 1)) against their plain versions on the same values, at
    the tolerance of ``tests/test_torch_port_raft_cuda.py``: the pack bit for
    bit, the gates and the update within one float16 rounding and a few
    float32 ones. The times are a forward's (``valid_iters`` cells of each
    level): the three kernels by events and by device time, the plain
    versions, and the published cell's 17 torch ops around the same
    convolutions' outputs that the kernels replace (``library_ms``: three
    ``cat``s, three bias adds, three context sums, the gates, the products
    and the update); the bound reads each input once and writes each output
    once. No TPU kernel has this function."""
    if (H, W) != (RAFT_CFG["shapes"]["height"], RAFT_CFG["shapes"]["width"]):
        raise AssertionError(f"GRU_LEVELS: {H}x{W} is not the raft_kitti_b1 cell's size")
    iters, cl, dt = RAFT_CFG["shapes"]["valid_iters"], torch.channels_last, torch.float16
    eps = torch.finfo(torch.float32).eps
    close = dict(rtol=torch.finfo(dt).eps + 8 * eps, atol=8 * eps)
    rows, err = [], 0.0
    for inputs, h, w in GRU_LEVELS:
        def rnd(c, scale=1.0):
            return (scale * _rnd(gen, 1, c, h, w)).to(dt, memory_format=cl)

        state, xs, zr, q = torch.tanh(rnd(128, 2.0)), tuple(rnd(c) for c in inputs), rnd(256, 2.0), rnd(128, 2.0)
        cz, cr, cq = rnd(128), rnd(128), rnd(128)
        bz, br, bq = ((0.5 * _rnd(gen, 128)).to(dt) for _ in range(3))
        reset_counts()
        hx = grk.conv_gru_pack(state, xs)
        plain_hx = grk.conv_gru_pack_torch(state, xs)
        torch.cuda.synchronize()
        if not torch.equal(hx, plain_hx):
            raise AssertionError(f"conv_gru_pack {h}x{w}: not the plain pack bit for bit")
        z = grk.conv_gru_gate(zr, bz, br, cz, cr, state, hx)
        plain_z = grk.conv_gru_gate_torch(zr, bz, br, cz, cr, state, plain_hx)
        new = grk.conv_gru_update(q, bq, cq, plain_z, state)
        torch.cuda.synchronize()
        plain_new = grk.conv_gru_update_torch(q, bq, cq, plain_z, state)
        counted = read_counts()
        if counted != dict.fromkeys(COUNTERS, 0) | dict.fromkeys(GRU_KERNELS, 1) \
                or not torch.equal(hx[:, 128:], plain_hx[:, 128:]):
            raise AssertionError(f"conv_gru {h}x{w}: launches {counted}, one of each of {GRU_KERNELS} expected, or "
                                 "the gates moved hx's inputs")
        for got, ref in ((z, plain_z), (hx[:, :128], plain_hx[:, :128]), (new, plain_new)):
            torch.testing.assert_close(got, ref, **close)
            err = max(err, (got.float() - ref.float()).abs().max().item())
        zr_z, zr_r = (t.contiguous(memory_format=cl) for t in zr.split(128, 1))

        def kernels():
            hx = grk.conv_gru_pack(state, xs)
            return grk.conv_gru_update(q, bq, cq, grk.conv_gru_gate(zr, bz, br, cz, cr, state, hx), state)

        def plain():
            hx = grk.conv_gru_pack_torch(state, xs)
            return grk.conv_gru_update_torch(q, bq, cq, grk.conv_gru_gate_torch(zr, bz, br, cz, cr, state, hx), state)

        def published():  # the published cell's torch ops, zr_z, zr_r and q standing for its convolutions' outputs
            x = torch.cat(xs, 1)
            torch.cat([state, x], 1)
            zg = torch.sigmoid(zr_z + bz[:, None, None] + cz)
            rg = torch.sigmoid(zr_r + br[:, None, None] + cr)
            torch.cat([rg * state, x], 1)
            return (1 - zg) * state + zg * torch.tanh(q + bq[:, None, None] + cq)

        def host_ms(fn, calls=50):  # the host's time a call, the card's queue never full
            fn()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(calls):
                fn()
            t = time.perf_counter() - t
            torch.cuda.synchronize()
            return t / calls * 1e3

        moved = (nbytes(state, *xs, hx)  # the pack
                 + nbytes(zr, cz, cr, state, bz, br, z, hx[:, :128])  # the gates
                 + nbytes(q, cq, z, state, bq, new))  # the update
        rows.append(dict(
            shape=[1, 128, h, w], inputs=list(inputs), cells=iters, ms=time_ms(kernels),
            device_ms=device_total_ms(kernels), plain_ms=time_ms(plain), library_ms=time_ms(published),
            library_device_ms=device_total_ms(published), bound_ms=bound(0, PEAK_BF16_FLOPS, moved)[0],
            bytes=moved, host_ms=host_ms(kernels), library_host_ms=host_ms(published),
            pack_device_ms=device_total_ms(lambda: grk.conv_gru_pack(state, xs)),
            cat_device_ms=device_total_ms(lambda: grk.conv_gru_pack_torch(state, xs)),
        ))
        r = rows[-1]
        log(f"  conv_gru {h}x{w}, inputs {inputs}: {r['ms']:.4f} ms (device {r['device_ms']:.4f}, "
            f"{moved / r['device_ms'] / 1e6:.0f} GB/s), plain {r['plain_ms']:.4f}, published ops {r['library_ms']:.4f} "
            f"(device {r['library_device_ms']:.4f}); host {r['host_ms']:.4f}, published ops' {r['library_host_ms']:.4f}; "
            f"pack device {r['pack_device_ms']:.4f} against one cat {r['cat_device_ms']:.4f}; bound "
            f"{r['bound_ms']:.4f} ms a cell")
    total = {k: sum(r["cells"] * r[k] for r in rows)
             for k in ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms", "bound_ms", "host_ms",
                       "library_host_ms", "pack_device_ms", "cat_device_ms")}
    return dict(name="conv_gru", route="triton", source="ecm_torch/ops/_conv_gru_triton.py", replaces=None,
                max_abs_err=err, atol=close["atol"], rtol=close["rtol"], bound_by="bytes", kernels=GRU_KERNELS,
                forms=rows, **total)


def check_geo_lookup(gen) -> dict:
    """IGEV-Stereo's combined geometry lookup at the ``igev_kitti_b1`` shape
    (a 96x312 grid, GEV levels of 48 and 24 planes of 8 channels, the
    correlation rows of 312 and 156, radius 4, float16 out, as the model
    calls it) against its plain version, with disparities inside, on and
    past both ends of each row and at -0.5, at the tolerance of
    ``tests/test_torch_port_igev_cuda.py``: the plain version's
    ``grid_sample`` moves a position by up to ~4 float32 units in the last
    place of the row's length, times the row's slope (at most twice its
    largest value), and float16 rounds once more. Its bound is the cell's
    (``stereo_bench/families/igevstereo.lookup_form``, bytes). No TPU
    kernel has this function."""
    from stereo_bench import counts
    from stereo_bench.families import igevstereo

    s = IGEV_CFG["shapes"]
    h, w, d = s["height"] // 4, s["width"] // 4, s["max_disp"] // 4
    gev = _rnd(gen, 1, s["volume_channels"], d, h, w).half().contiguous(memory_format=torch.channels_last_3d)
    geo = geok.geo_pyramid(gev, s["corr_levels"])
    corr = corrk.corr_pyramid(_rnd(gen, 1, s["descriptor_dim"], h, w), _rnd(gen, 1, s["descriptor_dim"], h, w),
                              s["corr_levels"], scaled=False)
    disp = (torch.rand(1, 1, h, w, generator=gen, device="cuda") * 1.4 - 0.2) * d
    disp.view(-1)[:8] = torch.tensor([-0.5, -1.0, 0.0, d - 1.0, d - 0.5, float(d), -3.7, d + 4.2], device="cuda")
    r = s["corr_radius"]
    out = geok.geo_lookup(geo, corr, disp, r, torch.float16)
    torch.cuda.synchronize()
    ref = geok.geo_lookup_torch(geo, corr, disp, r)
    largest = max(t.abs().max().item() for t in (*geo, *corr))
    atol = 4 * torch.finfo(torch.float32).eps * w * 2 * largest
    torch.testing.assert_close(out.float(), ref, rtol=torch.finfo(torch.float16).eps, atol=atol)
    return dict(
        name="geo_lookup", route="cuda", source="ecm_torch/csrc/geo_lookup.cu", replaces=None,
        max_abs_err=(out.float() - ref).abs().max().item(), atol=atol,
        ms=time_ms(lambda: geok.geo_lookup(geo, corr, disp, r, torch.float16)),
        device_ms=device_ms(lambda: geok.geo_lookup(geo, corr, disp, r, torch.float16), GEO_LOOKUP),
        plain_ms=time_ms(lambda: geok.geo_lookup_torch(geo, corr, disp, r, torch.float16)),
        bound_ms=counts.bound_s(igevstereo.lookup_form(IGEV_CFG, 1)) * 1e3, bound_by="bytes", library_ms=None,
    )


def check_gwc_volume(gen) -> dict:
    """IGEV-Stereo's group-wise volume (``correlation_kernel`` at 8 groups of
    12 channels, float16, 48 planes of the 96x312 grid) against its plain
    version, within one float16 rounding (the same float32 products summed
    in another order, rounded once); and ECM's one-group launch at its
    kitti_infer shape unchanged: counted as ECM's launch, and bit for bit the
    kernel called without ``groups``. Its bound is the cell's
    (``stereo_bench/families/igevstereo.volume_form``, bytes). No TPU kernel
    has the group-wise form."""
    from stereo_bench import counts
    from stereo_bench.families import igevstereo

    s = IGEV_CFG["shapes"]
    h, w, d, c, g = s["height"] // 4, s["width"] // 4, s["max_disp"] // 4, s["descriptor_dim"], s["groups"]
    fl, fr = _rnd(gen, 1, h, w, c).half(), _rnd(gen, 1, h, w, c).half()
    out = cvk.cost_volume_correlation(fl, fr, d, groups=g)
    torch.cuda.synchronize()
    ref = cvk.cost_volume_correlation_torch(fl, fr, d, groups=g)
    err = (out.float() - ref.float()).abs()
    if not (err <= torch.finfo(torch.float16).eps * ref.float().abs() + 16 * torch.finfo(torch.float32).eps).all():
        raise AssertionError(f"gwc_volume: max|err| {err.max().item()} beyond one float16 rounding")
    el, er = _rnd(gen, B, H4, W4, C).bfloat16(), _rnd(gen, B, H4, W4, C).bfloat16()
    ecm = dict(launches=cvk.cost_volume_correlation.launches, group_launches=cvk.cost_volume_correlation.group_launches)
    one, default = cvk.cost_volume_correlation(el, er, D4, groups=1), cvk.cost_volume_correlation(el, er, D4)
    ecm = {k: getattr(cvk.cost_volume_correlation, k) - n for k, n in ecm.items()}
    if not (torch.equal(one, default) and ecm == dict(launches=2, group_launches=0)):
        raise AssertionError(f"groups=1 is not ECM's launch: counts {ecm}, equal {torch.equal(one, default)}")
    return dict(
        name="gwc_volume", route="cuda", source="ecm_torch/csrc/cost_volume.cu", replaces=None,
        max_abs_err=err.max().item(), groups=g,
        ms=time_ms(lambda: cvk.cost_volume_correlation(fl, fr, d, groups=g)),
        device_ms=device_ms(lambda: cvk.cost_volume_correlation(fl, fr, d, groups=g), CORRELATION),
        plain_ms=time_ms(lambda: cvk.cost_volume_correlation_torch(fl, fr, d, groups=g)),
        bound_ms=counts.bound_s(igevstereo.volume_form(IGEV_CFG, 1)) * 1e3, bound_by="bytes", library_ms=None,
    )


def pairs(batch: int, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    left = torch.rand(batch, H, W, 3, generator=gen, device="cuda")
    return left, torch.rand(batch, H, W, 3, generator=gen, device="cuda")


def correlation_witness(model, plain) -> dict:
    """Where the correlation path's cost map leaves the plain path's, on
    each pair of ``CORR_WITNESS_SEEDS`` at batch 1:

    1. the kernel's volume and the plain builder's are each within one bf16
       rounding and the f32 sum's error of the f64 correlation
       (``correlation_rounding`` <= 1); how many entries differ, and by how
       many bf16 spacings at most;
    2. the plain network fed the kernel's volume gives the kernel path's
       cost map bit for bit, so all of the cost-map difference is the plain
       network's response to those roundings;
    3. that response: the cost map's max|diff|/max|ref| against the plain
       path, held to ``COST4_CORR_REL_TOL``, over the volume's.
    """
    rows = []
    for seed in CORR_WITNESS_SEEDS:
        left, right = pairs(1, seed)
        fl, fr = plain.feature(left), plain.feature(right)
        vol_k = cvk.cost_volume_correlation(fl, fr, D4)
        vol_p = cvk.cost_volume_correlation_torch(fl, fr, D4)
        rounding = [correlation_rounding(v, fl, fr) for v in (vol_k, vol_p)]
        if not max(rounding) <= 1.0:
            raise AssertionError(f"basic_correlation seed {seed}: volume {rounding} x one rounding off f64")
        (cost_k,) = model.cost_maps(left, right)
        (cost_kp,) = plain.aggregate(vol_k, fl)
        if not torch.equal(cost_k, cost_kp):
            raise AssertionError(f"basic_correlation seed {seed}: the plain network on the kernel's volume "
                                 f"differs from the kernel path by {(cost_k - cost_kp).abs().max().item()}")
        (cost_p,) = plain.cost_maps(left, right)
        vol_rel = ((vol_k.float() - vol_p.float()).abs().max() / vol_p.float().abs().max()).item()
        cost_rel = ((cost_k.float() - cost_p.float()).abs().max() / cost_p.float().abs().max()).item()
        rows.append(dict(
            seed=seed, roundings_kernel=rounding[0], roundings_plain=rounding[1],
            entries=vol_k.numel(), entries_differ=int((vol_k != vol_p).sum().item()),
            max_spacings=bf16_spacings(vol_k, vol_p).max().item(), volume_rel=vol_rel,
            cost4_rel=cost_rel, amplification=cost_rel / vol_rel if vol_rel else None,
        ))
        log(f"  basic_correlation witness: {json.dumps(rows[-1])}")
    worst = max(r["cost4_rel"] for r in rows)
    if not worst <= COST4_CORR_REL_TOL:
        raise AssertionError(f"basic_correlation: cost4 rel err {worst} > {COST4_CORR_REL_TOL}")
    return dict(seeds=rows, cost4_rel_max=worst)


# the four serving paths: path -> (model, overrides, kernel launches a
# forward, batch 8 too, fields of the preset replaced)
SERVE_PATHS = {
    "slice1_standard": ("stackhourglass", SLICE_OVERRIDES, dict(
        cost_volume_concat=1, fused_conv3d_pair=3, fused_upsample_softargmin=1), True, {}),
    "slice2_grouped": ("stackhourglass", SLICE2_OVERRIDES, dict(
        cost_volume_concat=1, conv3d_bn_s1=4, conv3d_bn_down=3, deconv3d_bn=3,
        fused_conv3d_pair=1, fused_upsample_softargmin=1), True, {}),
    "basic": ("basic", dict(use_pallas=True, regress_mode="fused"), dict(
        cost_volume_concat=1, fused_upsample_softargmin=1), False, {}),
    "basic_correlation": ("basic", dict(use_pallas=True, regress_mode="fused"), dict(
        cost_volume_correlation=1, fused_upsample_softargmin=1), False, dict(cost_mode="correlation")),
}


def build_path(path: str):
    """``path``'s model at full width, random weights from seed 0."""
    name, overrides, _, _, fields = SERVE_PATHS[path]
    cfg = dataclasses.replace(CONFIGS["kitti_infer"].model, name=name, **fields)
    return cfg.build(generator=torch.Generator().manual_seed(0), **overrides)


def serve(path: str, name: str, overrides: dict, per_forward: dict, batch8: bool,
          cost_tol: float = COST4_REL_TOL, **fields) -> dict:
    """Serve one path: every launch count set to 0 just before, read just
    after; then the cost map against the plain path (max|diff|/max|ref| <=
    ``cost_tol``) and the timings. ``fields`` replace fields of the preset
    (both paths)."""
    cfg = dataclasses.replace(CONFIGS["kitti_infer"].model, name=name, **fields)
    model = cfg.build(generator=torch.Generator().manual_seed(0), **overrides)
    requests = [pairs(1, s) for s in (1, 2, 3)[: 3 if batch8 else 2]] + ([pairs(8, 4)] if batch8 else [])
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        reset_counts()
        disps = [model(left, right)[0] for left, right in requests]
        torch.cuda.synchronize()
        launches = read_counts()
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
        if not cost_err <= cost_tol:
            raise AssertionError(f"{path}: cost4 rel err {cost_err} > {cost_tol}")
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
        if model.cost_mode == "correlation":
            result["witness"] = correlation_witness(model, plain)
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


# the port's kernels by symbol, in matching order: the conv core's
# transposed mode is conv3d_wgmma_kernel<0, ...>, and deconv3d_bn_kernel
# contains conv3d_bn_kernel; the pair's tensor-core kernel is
# fused_pair_wgmma_kernel, its CUDA-core kernel fused_pair_kernel, and the
# mma.sync kernel it replaced (PAIR_OLD_MMA) must be in no profile.
# OLD_CONV_MMA is the WMMA core that conv_wgmma.cuh replaced: no profile may
# hold it.
PAIR_WGMMA, PAIR_CORES, PAIR_OLD_MMA = "fused_pair_wgmma_kernel", "fused_pair_kernel", "fused_pair_mma_kernel"
REGRESSION, CORRELATION = "upsample_softargmin_kernel", "correlation_kernel"
CONV_WGMMA, OLD_CONV_MMA = "conv3d_wgmma_kernel", "conv3d_mma_kernel"
CONV_CUDA_CORES = "conv3d_bn_kernel"  # the f32 route of conv3d_bn.cu (deconv3d_bn_kernel contains it)
# kernels none of whose instantiations may spill: source -> (symbol, count).
# The conv core: (modes) x Cout_pad 16, 32, 64; the pair: output rows a tile 2
# x N2 8, 16, 32, and 4 x N2 8; the regression: f32, bf16; the correlation: f32, bf16 x C
# padded to 8, 16, 32, 64
# and float16 (IGEV's groups); the geometry lookup: float32, float16, bfloat16
NO_SPILL = {
    "conv3d_bn": (CONV_WGMMA, 6), "deconv3d_bn": (CONV_WGMMA, 3), "fused_conv3d_pair": (PAIR_WGMMA, 4),
    "regression": (REGRESSION, 2), "cost_volume": (CORRELATION, 12), "geo_lookup": (GEO_LOOKUP, 3),
}
PORT_SYMBOLS = (
    (f"{CONV_WGMMA}<0", "deconv3d_bn"), (CONV_WGMMA, "conv3d_bn"),
    ("deconv3d_bn_kernel", "deconv3d_bn"), ("conv3d_bn_kernel", "conv3d_bn"),
    (PAIR_WGMMA, "fused_conv3d_pair"), (PAIR_CORES, "fused_conv3d_pair (CUDA cores)"),
    ("concat_kernel", "cost_volume_concat"),
    (REGRESSION, "fused_upsample_softargmin"),
)


# each counted kernel by the symbol of its instantiations (the conv core's
# template's first argument is its mode: 0 transposed, 1 stride 1, 2 stride 2)
KERNEL_SYMBOLS = {
    "cost_volume_concat": "concat_kernel", "cost_volume_correlation": CORRELATION,
    "conv3d_bn_s1": f"{CONV_WGMMA}<1", "conv3d_bn_down": f"{CONV_WGMMA}<2", "deconv3d_bn": f"{CONV_WGMMA}<0",
    "fused_conv3d_pair": PAIR_WGMMA, "fused_upsample_softargmin": REGRESSION,
}


def profile_forward(path: str, graphed: bool = False, runs: int = 3) -> dict:
    """``runs`` batch-1 forwards of ``path`` (eager, or ``graphed``: replays
    of ``make_infer_fn``'s graph) under ``ecm_torch.utils.profiling.trace``
    after two calls (graphed: an eager call, then the capture), read back
    from the trace file it writes: device time per kernel (ms per forward), the port's kernels
    against everything else (cuDNN, elementwise, copies), each counted
    kernel's launches, the host-to-device copies, and the idle share of the
    window (1 - union of device intervals / host wall time, profiler
    overhead included); profiled again (``PROFILE_ATTEMPTS``) where the
    trace misses a kernel, and failed at once where it holds one kernel too
    many. Then ``profiling.timed`` of the same forward."""
    model = build_path(path)
    forward = make_infer_fn(model) if graphed else model
    per_forward = SERVE_PATHS[path][2]
    want = {k: per_forward.get(k, 0) * runs for k in KERNEL_SYMBOLS}
    reqs = [pairs(1, 400 + i) for i in range(runs + 1)]
    logdir = OUT_DIR / "trace" / (path + ("_graphed" if graphed else ""))
    with torch.inference_mode():
        forward(*reqs[0])
        forward(*reqs[0])
        torch.cuda.synchronize()
        for attempt in range(1, PROFILE_ATTEMPTS + 1):
            shutil.rmtree(logdir, ignore_errors=True)
            with profiling.trace(logdir=str(logdir)):
                t0 = time.perf_counter()
                for left, right in reqs[1:]:
                    forward(left, right)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            (trace_file,) = logdir.glob("*.pt.trace.json")
            # the kernels and copies (not the annotations the profiler also
            # puts on the device timeline), in microseconds
            events = [(e["name"], e["ts"], e["ts"] + e["dur"])
                      for e in json.loads(trace_file.read_text())["traceEvents"]
                      if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
            kernels = {k: sum(sym in e[0] for e in events) for k, sym in KERNEL_SYMBOLS.items()}
            if kernels == want:
                break
            # a dropped event (see PROFILE_ATTEMPTS) misses a kernel; it never
            # adds one, nor a replaced kernel or a host-to-device copy
            over = {k: n for k, n in kernels.items() if n > want[k]}
            over.update({sym: n for sym in (PAIR_CORES, PAIR_OLD_MMA, OLD_CONV_MMA, "HtoD")
                         if (n := sum(sym in e[0] for e in events))})
            if over:
                raise AssertionError(f"profile {path}: traced {over} beyond {want} for {runs} forwards")
            log(f"  profile {path}: traced kernels {kernels} for {runs} forwards (attempt {attempt})")
        timed_ms = profiling.timed(forward, *reqs[0]) * 1e3
    by_name, port = {}, {}
    for name, start, stop in events:
        ms = (stop - start) / 1e3
        by_name[name] = by_name.get(name, 0.0) + ms
        label = next((lab for sym, lab in PORT_SYMBOLS if sym in name), "other")
        port[label] = port.get(label, 0.0) + ms
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted(e[1:] for e in events):
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    del model, forward
    torch.cuda.empty_cache()
    return dict(
        path=path, graphed=graphed, runs=runs, device_events=len(events),
        trace_file=str(trace_file.relative_to(OUT_DIR)), kernels=kernels, kernels_expected=want,
        htod_copies=sum("HtoD" in e[0] for e in events),
        pair_kernels={sym: sum(sym in e[0] for e in events) for sym in (PAIR_WGMMA, PAIR_CORES, PAIR_OLD_MMA)},
        conv_kernels={sym: sum(sym in e[0] for e in events) for sym in (CONV_WGMMA, OLD_CONV_MMA)},
        wall_ms_per_forward=wall_ms / runs, device_busy_ms_per_forward=busy_us / 1e3 / runs,
        idle_share=1 - busy_us / 1e3 / wall_ms if events else None, timed_ms=timed_ms,
        ms_per_forward_by_group={k: v / runs for k, v in sorted(port.items(), key=lambda kv: -kv[1])},
        top_kernels_ms_per_forward=[(k[:90], v / runs) for k, v in top],
    )


def check_profile(prof: dict) -> None:
    """A profiled window ran each of its path's kernels once per launch a
    forward (the pair on its wgmma route, never its CUDA-core kernel or the
    mma.sync kernel it replaced; the conv core, never the WMMA core it
    replaced) and copied nothing from the host."""
    if prof["kernels"] != prof["kernels_expected"]:
        raise AssertionError(f"{prof['trace_file']}: kernels {prof['kernels']}, expected {prof['kernels_expected']}")
    per, runs = SERVE_PATHS[prof["path"]][2], prof["runs"]
    if prof["pair_kernels"] != {PAIR_WGMMA: per.get("fused_conv3d_pair", 0) * runs, PAIR_CORES: 0, PAIR_OLD_MMA: 0}:
        raise AssertionError(f"{prof['trace_file']}: pair kernels {prof['pair_kernels']}")
    convs = sum(per.get(k, 0) for k in ("conv3d_bn_s1", "conv3d_bn_down", "deconv3d_bn"))
    if prof["conv_kernels"] != {CONV_WGMMA: convs * runs, OLD_CONV_MMA: 0}:
        raise AssertionError(f"{prof['trace_file']}: conv kernels {prof['conv_kernels']}")
    if prof["htod_copies"]:
        raise AssertionError(f"{prof['trace_file']}: {prof['htod_copies']} host-to-device copies in the window")


def graphs_phase(card: str, profiled: dict) -> dict:
    """Serving through ``make_infer_fn``'s CUDA graphs (``ecm_torch/train/
    graphs.py``) on the four paths (see the module's docstring, item 4)."""
    t_phase = time.perf_counter()
    out = {}
    for path, (_, _, per_forward, batch8, _) in SERVE_PATHS.items():
        model = build_path(path)
        infer = make_infer_fn(model)
        want = {k: per_forward.get(k, 0) for k in COUNTERS}
        res = out[path] = {}
        for batch in (1, 8) if batch8 else (1,):
            req = pairs(batch, 800 + batch)
            graphs_before = len(infer.graphs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            first = infer(*req)  # the signature's first sighting: eager
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            second = infer(*req)  # the second: warm-up and capture
            torch.cuda.synchronize()
            first_s, second_s = t1 - t0, time.perf_counter() - t1
            if len(infer.graphs) != graphs_before + 1:
                raise AssertionError(f"graphs {path} b{batch}: {len(infer.graphs)} graphs after two calls")
            captured = next(reversed(infer.graphs.values()))
            if captured.launches != want:
                raise AssertionError(f"graphs {path} b{batch}: captured launches {captured.launches}, expected {want}")
            reset_counts()
            replay = infer(*req)
            torch.cuda.synchronize()
            if read_counts() != dict.fromkeys(COUNTERS, 0) or read_replayed() != want:
                raise AssertionError(f"graphs {path} b{batch}: a replay counted {read_counts()}, "
                                     f"replayed {read_replayed()}, expected {want} replayed")
            with torch.inference_mode():
                eager = model(*req)[-1]
            diff = {"replay": (replay - eager).abs().max().item(), "first_call": (first - eager).abs().max().item(),
                    "capturing_call": (second - eager).abs().max().item()}
            if not max(diff.values()) <= REGRESSION_TOL_PX or not torch.isfinite(replay).all():
                raise AssertionError(f"graphs {path} b{batch}: graphed disparity off the eager one by {diff} px")
            reqs = [pairs(batch, 900 + i) for i in range(RUNS + 1)]
            with torch.inference_mode():
                it = iter(reqs)
                eager_runs = times_ms(lambda: model(*next(it)))
            it = iter(reqs)
            graphed_runs = times_ms(lambda: infer(*next(it)))
            res[f"b{batch}"] = dict(
                eager_ms=statistics.median(eager_runs), graphed_ms=statistics.median(graphed_runs),
                eager_runs_ms=eager_runs, graphed_runs_ms=graphed_runs, max_abs_diff_px=diff,
                capture_ms=captured.capture_ms, first_call_s=first_s, capturing_call_s=second_s,
                pool_bytes=captured.pool_bytes,
                launches_per_replay={k: n for k, n in captured.launches.items() if n},
            )
            log(f"phase graphs: {path} b{batch}: eager {res[f'b{batch}']['eager_ms']:.2f} ms, graphed "
                f"{res[f'b{batch}']['graphed_ms']:.2f} ms a forward (medians of {RUNS}); capture "
                f"{captured.capture_ms:.1f} ms, first call {first_s:.2f} s, capturing call {second_s:.2f} s, "
                f"pool {captured.pool_bytes} bytes; "
                f"max|graphed - eager| {diff} px [{card}]")
        res["idle_share"] = {"eager": profiled.get(path, {}).get("idle_share"),
                             "graphed": profiled[path + "_graphed"]["idle_share"]}
        del model, infer, first, second, replay, eager, reqs
        torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    return out


# the seven stride-1 convs of the full-resolution stack that the grouped
# training dispatch sends through gband_conv_s1
GBAND_SITES = (
    "aggregation.dres0_1", "aggregation.dres0_2", "aggregation.dres1_1", "aggregation.dres1_2",
    "aggregation.classif1.conv1", "aggregation.classif2.conv1", "aggregation.classif3.conv1",
)
GBAND_WEIGHTS = tuple(f"{s}.conv.weight" for s in GBAND_SITES)


def train_batch(seed: int) -> dict:
    """One synthetic batch of the preset's size (numpy, made from a seed)."""
    data = CONFIGS[TRAIN_SLICE].data
    return make_batch(seed, data.global_batch, *data.crop)


def compare_train_paths(batch: dict) -> dict:
    """One step of the grouped path against one of the standard (cuDNN)
    path on the same weights and batch, the heads' conv2 scaled by 1e-3 on
    both so that the soft-argmin is soft: loss at rel <= TRAIN_LOSS_REL_TOL,
    the seven kernel sites' weight gradients at cosine >= TRAIN_GRAD_COSINE,
    and the three cost maps before the soft-argmin at COST4_REL_TOL (with
    heads this soft, every prediction is close to the mean disparity, so
    the loss alone says little)."""
    cfg = CONFIGS[TRAIN_SLICE].model
    out = {}
    for layout in ("grouped", "standard"):
        model = cfg.build(generator=torch.Generator().manual_seed(0), agg_layout=layout)
        scale_heads(model, 1e-3)
        model.train()
        costs = []
        hook = model.aggregation.register_forward_hook(lambda m, i, o: costs.extend(c.detach().float() for c in o))
        reset_counts()
        preds = model(batch["left"], batch["right"])
        loss = stereo_loss(preds, batch["disparity"], cfg.max_disp)
        loss.backward()
        torch.cuda.synchronize()
        hook.remove()
        counts = read_counts()
        params = dict(model.named_parameters())
        out[layout] = dict(loss=loss.item(), gband=(counts["gband_conv_s1"], counts["gband_conv_s1_input_grad"]),
                           costs=costs,
                           grads={s: params[f"{s}.conv.weight"].grad.float().flatten() for s in GBAND_SITES})
        del model, params, preds, loss
    if out["grouped"]["gband"] != (7, 7) or out["standard"]["gband"] != (0, 0):
        raise AssertionError(f"gband_conv_s1 launches grouped {out['grouped']['gband']}, "
                             f"standard {out['standard']['gband']}; expected (7, 7) and (0, 0)")
    lg, ls = out["grouped"]["loss"], out["standard"]["loss"]
    loss_rel = abs(lg - ls) / abs(ls)
    cos = {s: F.cosine_similarity(out["grouped"]["grads"][s], out["standard"]["grads"][s], dim=0).item()
           for s in GBAND_SITES}
    cost_rel = [((g - r).abs().max() / r.abs().max()).item()
                for g, r in zip(out["grouped"]["costs"], out["standard"]["costs"])]
    result = dict(loss_grouped=lg, loss_standard=ls, loss_rel=loss_rel, grad_cosine=cos, cost_rel=cost_rel,
                  loss_rel_tol=TRAIN_LOSS_REL_TOL, grad_cosine_min=TRAIN_GRAD_COSINE, cost_rel_tol=COST4_REL_TOL)
    log("  train grouped vs standard: " + json.dumps(result))
    if not loss_rel <= TRAIN_LOSS_REL_TOL:
        raise AssertionError(f"train loss grouped {lg} vs standard {ls}: rel {loss_rel} > {TRAIN_LOSS_REL_TOL}")
    if not min(cos.values()) >= TRAIN_GRAD_COSINE:
        raise AssertionError(f"weight-gradient cosine {cos} below {TRAIN_GRAD_COSINE}")
    if len(cost_rel) != 3 or not max(cost_rel) <= COST4_REL_TOL:
        raise AssertionError(f"train cost maps grouped vs standard: rel {cost_rel} > {COST4_REL_TOL}")
    del out
    torch.cuda.empty_cache()
    return result


def profile_train_step(state, step, batch, symbol: str = f"{CONV_WGMMA}<1") -> dict:
    """One train step under torch.profiler, after one unprofiled step: the
    device's idle share, and its time in the gband_conv_s1 kernel (the first
    7 launches of the step are the forwards, the next 7 the input
    gradients: one stream, or one graph captured from one stream, runs them
    in order), in cuDNN's weight-gradient kernels, and in the rest.
    ``symbol``: the kernel's, the conv core's stride-1 mode in bf16, the
    CUDA-core kernel in f32."""
    from torch.profiler import ProfilerActivity, profile

    step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = sorted(device_events(prof), key=lambda e: e.time_range.start)
    groups, by_name, gband = {}, {}, 0
    for e in events:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
        if symbol in e.name:
            label = "gband_conv_s1 forward" if gband < 7 else "gband_conv_s1 input grad"
            gband += 1
        elif "wgrad" in e.name.lower():
            label = "cuDNN weight grad (every conv)"
        elif "Memcpy DtoD" in e.name:
            label = MEMCPY_DTOD
        else:
            label = "other"
        groups[label] = groups.get(label, 0.0) + ms
    if gband != 14:
        raise AssertionError(f"profiled train step ran {gband} gband_conv_s1 kernels, expected 14")
    memcpy = groups.get(MEMCPY_DTOD, 0.0)
    log(f"  train step device ms by group: {json.dumps(groups)}; device-to-device memcpy {memcpy:.3f} ms")
    if not memcpy < TRAIN_MEMCPY_MS:
        raise AssertionError(f"train step: {memcpy} ms of device-to-device memcpy, not under {TRAIN_MEMCPY_MS}")
    busy_us, end = 0.0, float("-inf")
    for e in events:
        busy_us += max(0.0, e.time_range.end - max(e.time_range.start, end))
        end = max(end, e.time_range.end)
    return dict(
        wall_ms=wall_ms, device_busy_ms=busy_us / 1e3, idle_share=1 - busy_us / 1e3 / wall_ms,
        device_ms_by_group=groups, memcpy_dtod_ms=memcpy, device_events=len(events),
        top_kernels_ms=[(k[:90], v) for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
    )


def _train_tensors(state) -> dict[str, torch.Tensor]:
    """Every parameter, buffer, Adam moment and Adam step count by name."""
    out = dict(state.model.state_dict())
    names = {id(p): n for n, p in state.model.named_parameters()}
    for p in state.optimizer.params:
        for k, v in state.optimizer.adam.state[p].items():
            out[f"{names[id(p)]}:{k}"] = v
    return out


def compare_graphed_to_eager(batch: dict) -> dict:
    """``GRAPH_CHECK_STEPS`` graphed steps against as many eager ones
    (``graphed=False``) from three states built from one seed, on one batch,
    with ``torch.backends.cudnn.deterministic`` on, the learning rate
    dropping to 1e-4 at step 4 (steps 3 on are replays): each step's
    metrics and then every parameter, buffer, Adam moment and step count
    equal to the eager run's within twice its difference from a second eager
    run (0 where eager is deterministic: bit for bit), as
    ``tests/test_torch_port_train_graphs_cuda.py`` holds them. Also the
    graphed state's first (eager) and second (warm-up and capture) calls'
    wall times and the capture's ms and pool."""
    cfg = CONFIGS[TRAIN_SLICE]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs, walls = {}, []
        for name in ("graphed", "eager", "eager_again"):
            model = cfg.model.build(generator=torch.Generator().manual_seed(0))
            state = create_train_state(model, make_optimizer(cfg.train.lr, [(3, 1e-4)]))
            step = make_train_step(model, cfg.model.max_disp, graphed=name == "graphed")
            metrics = []
            for i in range(GRAPH_CHECK_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                metrics.append(step(state, batch)[1])
                torch.cuda.synchronize()
                if name == "graphed":
                    walls.append(time.perf_counter() - t0)
            if name == "graphed":
                (captured,) = step.graphed.graphs.values()
                if captured.replays != GRAPH_CHECK_STEPS - 2:
                    raise AssertionError(f"train graphs: {captured.replays} replays of {GRAPH_CHECK_STEPS} steps")
            runs[name] = dict(metrics=metrics, tensors=_train_tensors(state))
            del model, state, step
        out, worst = {}, {}
        for part in ("metrics", "tensors"):
            if part == "metrics":
                flat = {n: {f"{i}:{k}": v for i, m in enumerate(r["metrics"]) for k, v in m.items()}
                        for n, r in runs.items()}
            else:
                flat = {n: r["tensors"] for n, r in runs.items()}
            diff = {k: (flat["graphed"][k].double() - flat["eager"][k].double()).abs().max().item()
                    for k in flat["eager"]}
            spread = {k: (flat["eager_again"][k].double() - flat["eager"][k].double()).abs().max().item()
                      for k in flat["eager"]}
            bad = {k: (diff[k], spread[k]) for k in diff if diff[k] > 2 * spread[k]}
            worst[part] = sorted(((diff[k], spread[k], k) for k in diff), reverse=True)[:3]
            out[part] = dict(compared=len(diff), beyond_twice_the_spread=len(bad),
                             max_graphed_vs_eager=max(diff.values()), max_eager_spread=max(spread.values()),
                             nonzero_spread=[k for k in spread if spread[k]][:10])
            if bad:
                raise AssertionError(f"train graphs: {len(bad)} {part} beyond twice the eager spread: "
                                     f"{list(bad.items())[:5]}")
        out.update(first_call_s=walls[0], capturing_call_s=walls[1], replay_walls_s=walls[2:],
                   capture_ms=captured.capture_ms, pool_bytes=captured.pool_bytes, worst=worst)
        log("  train graphed vs eager: " + json.dumps(out))
        del runs, captured
        torch.cuda.empty_cache()
        return out
    finally:
        torch.backends.cudnn.deterministic = deterministic


def train(card: str) -> dict:
    """Slice 3's path: ``train_loop`` over ``TRAIN_STEPS`` steps of one fixed
    synthetic batch through ``make_train_step`` (slice 15: one CUDA graph per
    batch signature, the first step eager, the second captured, the rest
    replayed), counts 0 just before and read just after; then graphed and
    eager steps timed in one call, each profiled, the graphed steps against
    eager ones, and the grouped/standard comparison."""
    cfg = CONFIGS[TRAIN_SLICE]
    model = cfg.model.build(generator=torch.Generator().manual_seed(0))
    if model.resolve_layout(torch.device("cuda")) != "grouped":
        raise AssertionError(f"{TRAIN_SLICE} does not resolve to the grouped layout on CUDA")
    fixed = train_batch(1)
    state = create_train_state(model, make_optimizer(cfg.train.lr))
    step = make_train_step(model, cfg.model.max_disp)
    metrics_path = OUT_DIR / "train_metrics.jsonl"
    metrics_path.unlink(missing_ok=True)
    reset_counts()
    state = train_loop(state, step, itertools.repeat(fixed), TRAIN_STEPS, log_every=1,
                       metrics_path=str(metrics_path))
    torch.cuda.synchronize()
    counted, replayed = read_counts(), read_replayed()
    launches = {k: counted[k] + replayed[k] for k in COUNTERS}
    want = _steps(TRAIN_STEPS)
    if counted != want["expected"] or replayed != want["replayed"]:
        raise AssertionError(f"train: launches {counted} and replayed {replayed} for {TRAIN_STEPS} steps, "
                             f"expected {want}")
    (captured,) = step.graphed.graphs.values()
    losses = [json.loads(line)["loss"] for line in metrics_path.read_text().splitlines()]
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"train: losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: loss did not fall on a fixed batch: {losses}")
    log(f"  train: {TRAIN_STEPS} steps, launches {counted} and replayed {replayed}, gband_conv_s1 copies "
        f"{gbk.gband_conv_s1.copies}; losses {losses}")

    batch = to_device(fixed, torch.device("cuda"))
    eager = make_train_step(model, cfg.model.max_disp, graphed=False)
    torch.cuda.reset_peak_memory_stats()
    graphed_runs = times_ms(lambda: step(state, batch))
    graphed_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    eager_runs = times_ms(lambda: eager(state, batch))
    eager_peak = torch.cuda.max_memory_allocated() / 1e9
    reserved = torch.cuda.memory_reserved() / 1e9
    if captured.replays != TRAIN_STEPS - 2 + RUNS + 1 or len(step.graphed.graphs) != 1:
        raise AssertionError(f"train: {captured.replays} replays, {len(step.graphed.graphs)} graphs")
    profile = profile_train_step(state, step, batch)
    profile_eager = profile_train_step(state, eager, batch)
    ms, eager_ms = statistics.median(graphed_runs), statistics.median(eager_runs)
    capture_ms, pool_bytes = captured.capture_ms, captured.pool_bytes
    del state, model, step, eager, captured
    torch.cuda.empty_cache()
    graphed_vs_eager = compare_graphed_to_eager(batch)
    compare = compare_train_paths(to_device(train_batch(2), torch.device("cuda")))
    log(f"phase train: graphed {ms:.2f} ms a step ({cfg.data.global_batch / ms * 1e3:.2f} pairs/s), eager "
        f"{eager_ms:.2f} ms ({cfg.data.global_batch / eager_ms * 1e3:.2f} pairs/s), medians of {RUNS}; idle share "
        f"graphed {profile['idle_share']:.3f}, eager {profile_eager['idle_share']:.3f}; capture "
        f"{graphed_vs_eager['capture_ms']:.1f} ms, pool {graphed_vs_eager['pool_bytes']} bytes, first call "
        f"{graphed_vs_eager['first_call_s']:.2f} s, capturing call {graphed_vs_eager['capturing_call_s']:.2f} s; "
        f"peak allocated graphed {graphed_peak:.2f} GB, eager {eager_peak:.2f} GB, reserved {reserved:.2f} GB "
        f"[{card}]")
    return dict(
        card=card, steps=TRAIN_STEPS, launches=launches, counted=counted, replayed=replayed, losses=losses,
        ms_per_step=ms, runs_ms=graphed_runs, pairs_per_s=cfg.data.global_batch / ms * 1e3,
        eager_ms_per_step=eager_ms, eager_runs_ms=eager_runs, eager_pairs_per_s=cfg.data.global_batch / eager_ms * 1e3,
        peak_mem_gb=graphed_peak, eager_peak_mem_gb=eager_peak, reserved_gb=reserved,
        loop_capture_ms=capture_ms, loop_pool_bytes=pool_bytes,
        profile=profile, profile_eager=profile_eager, graphed_vs_eager=graphed_vs_eager,
        grouped_vs_standard=compare,
    )


# the cli phase: a SceneFlow-layout tree (train) and a KITTI 2015-layout
# tree (finetune on training/, evaluate on its validation split, submission
# on testing/)
CLI_SF_PAIRS, CLI_SF_SIZE = 8, (540, 960)
CLI_KITTI_PAIRS, CLI_KITTI_SIZE = 4, (375, 1242)
CLI_TRAIN_STEPS, CLI_RESUME_STEPS, CLI_FINETUNE_STEPS, CLI_FINETUNE_EVAL_EVERY = 4, 6, 4, 2
# the grouped eval path's launches a pair (evaluate, submission); --pallas
# adds the concat kernel
CLI_EVAL_PER_PAIR = dict(conv3d_bn_s1=4, conv3d_bn_down=3, deconv3d_bn=3, fused_conv3d_pair=1,
                         fused_upsample_softargmin=1)
SUBMISSION_TOL_CODES = 1  # uint16 codes, 1/256 px


def _uint8(img: np.ndarray) -> np.ndarray:
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def write_cli_trees(root: Path) -> tuple[str, str]:
    """SceneFlow (``frames_cleanpass``, PFM disparities) and KITTI 2015
    (``training/`` with uint16 ``disp_occ_0``, ``testing/``) trees of
    synthetic stereo pairs (``make_pair``, seeded) under ``root``."""
    from PIL import Image

    rng = np.random.default_rng(0)
    sf = root / "sceneflow"
    for i in range(CLI_SF_PAIRS):
        s = make_pair(rng, *CLI_SF_SIZE, max_disp=60.0, normalized=False)
        frames = sf / "frames_cleanpass" / "TRAIN" / "A" / "0000"
        disp_dir = sf / "disparity" / "TRAIN" / "A" / "0000" / "left"
        for side in ("left", "right"):
            (frames / side).mkdir(parents=True, exist_ok=True)
            Image.fromarray(_uint8(s[side])).save(frames / side / f"{i:04d}.png")
        disp_dir.mkdir(parents=True, exist_ok=True)
        write_pfm(str(disp_dir / f"{i:04d}.pfm"), s["disparity"])
    kt = root / "kitti"
    for split in ("training", "testing"):
        for i in range(CLI_KITTI_PAIRS):
            s = make_pair(rng, *CLI_KITTI_SIZE, max_disp=60.0, normalized=False)
            name = f"{i:06d}_10.png"
            for side, sub in (("left", "image_2"), ("right", "image_3")):
                (kt / split / sub).mkdir(parents=True, exist_ok=True)
                Image.fromarray(_uint8(s[side])).save(kt / split / sub / name)
            if split == "training":
                (kt / split / "disp_occ_0").mkdir(parents=True, exist_ok=True)
                kitti.save_disp_png(str(kt / split / "disp_occ_0" / name), s["disparity"])
    return str(sf), str(kt)


class _Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.copy = out, io.StringIO()

    def write(self, text: str) -> int:
        self.copy.write(text)
        return self.out.write(text)

    def flush(self) -> None:
        self.out.flush()


def drive(name: str, cli, argv: list[str], expected: dict, replayed: dict | None = None) -> tuple[dict, str]:
    """``cli.main(argv)`` in-process, the launch counts set to 0 just before
    and read just after and held to ``expected``, and the launches of CUDA
    graph replays to ``replayed`` (0 for a kernel not named). Returns
    ({launches (counted plus replayed: what ran), counted, replayed,
    wall_s}, what it printed)."""
    log(f"  cli {name}: python -m {cli.__name__} {' '.join(argv)}")
    tee = _Tee(sys.stdout)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counted, ran = read_counts(), read_replayed()
    want = {k: expected.get(k, 0) for k in COUNTERS}
    want_ran = {k: (replayed or {}).get(k, 0) for k in COUNTERS}
    if counted != want or ran != want_ran:
        raise AssertionError(f"cli {name}: launches {counted} and replayed {ran}, expected {want} and {want_ran}")
    return dict(launches={k: counted[k] + ran[k] for k in COUNTERS}, counted=counted, replayed=ran,
                wall_s=wall), tee.copy.getvalue()


def _graphed(per: dict, n: int) -> dict:
    """The launches of ``n`` calls of one signature through one CUDA graph,
    ``per`` a call: the first call runs eagerly, the second warms up (a
    call's launches) and is captured (none), and each later call replays
    them. ``expected`` is what the wrappers count, ``replayed`` what the
    replays add."""
    return dict(expected={k: min(n, 2) * per.get(k, 0) for k in COUNTERS},
                replayed={k: max(n - 2, 0) * per.get(k, 0) for k in COUNTERS})


def _steps(n: int) -> dict:
    """A train run's launches over ``n`` steps of one batch shape in one
    process: 7 + 7 ``gband_conv_s1`` a step, through one CUDA graph."""
    return _graphed(dict(gband_conv_s1=7, gband_conv_s1_input_grad=7), n)


def _pairs(n: int, pallas: bool = False) -> dict:
    """An eval CLI's launches over ``n`` pairs of one shape, which it serves
    through one CUDA graph (the second pair's disparity is its warm-up's)."""
    return _graphed(dict(CLI_EVAL_PER_PAIR, cost_volume_concat=1) if pallas else CLI_EVAL_PER_PAIR, n)


def _plus(*runs: dict) -> dict:
    """The sum of ``_graphed`` expectations."""
    return {part: {k: sum(r[part][k] for r in runs) for k in COUNTERS} for part in ("expected", "replayed")}


@contextlib.contextmanager
def preset_train(name: str, **fields):
    """``CONFIGS[name]`` with its train fields replaced inside (the CLIs read
    the presets when they run)."""
    saved = CONFIGS[name]
    CONFIGS[name] = dataclasses.replace(saved, train=dataclasses.replace(saved.train, **fields))
    try:
        yield
    finally:
        CONFIGS[name] = saved


def loader_rate(specs: list, batches: int = 24) -> dict:
    """The train pipeline alone at the preset's batch, crop and workers: the
    time to its first batch (worker start-up) and the pairs/s it delivers
    after that."""
    data = CONFIGS[TRAIN_SLICE].data
    t0 = time.perf_counter()
    it = make_train_pipeline(specs, sceneflow_load_sample, PipelineConfig(
        batch_size=data.global_batch, crop=data.crop, seed=1, num_workers=data.workers))
    next(it)
    t1 = time.perf_counter()
    for _ in range(batches):
        next(it)
    t2 = time.perf_counter()
    del it
    return dict(workers=data.workers, first_batch_s=t1 - t0, pairs_per_s=batches * data.global_batch / (t2 - t1))


def tfrecord_rate(specs: list, root: Path) -> dict:
    """The SceneFlow-layout pairs as the train preset's crops (seeded),
    packed into two TFRecord shards by ``ecm_torch.data.tfrecord`` and read
    back, equal bit for bit: the host's MB/s each way (files in the page
    cache; no gate)."""
    rng = np.random.default_rng(0)
    samples = [sceneflow_load_sample(s, CONFIGS[TRAIN_SLICE].data.crop, rng) for s in specs]
    t0 = time.perf_counter()
    paths = tfrecord.write_shards(iter(samples), str(root / "tfrecord"), samples_per_shard=len(samples) // 2)
    t1 = time.perf_counter()
    back = list(tfrecord.read_shards(paths))
    t2 = time.perf_counter()
    if len(paths) != 2 or len(back) != len(samples) or not all(
            np.array_equal(a[k], b[k]) for a, b in zip(samples, back) for k in ("left", "right", "disparity")):
        raise AssertionError(f"tfrecord: {len(paths)} shards, {len(back)} of {len(samples)} records read back equal")
    size = sum(os.path.getsize(p) for p in paths)
    return dict(shards=len(paths), records=len(back), bytes=size, write_s=t1 - t0, read_s=t2 - t1,
                write_mb_s=size / (t1 - t0) / 1e6, read_mb_s=size / (t2 - t1) / 1e6)


def checkpoint_times(ck: str, repeats: int = 3) -> dict:
    """The size of the newest checkpoint in ``ck``, and the median time to
    restore it into a fresh ``kitti_infer`` state on the card and to save
    that state again (to another directory)."""
    cfg = cli_common.resolve_config(cli_common.base_parser("").parse_args([]), "kitti_infer")
    manager = ckpt_lib.make_manager(ck)
    size = os.path.getsize(manager.path(manager.latest_step()))
    restores, saves = [], []
    with tempfile.TemporaryDirectory(prefix="ecm_ckpt_") as tmp:
        out = ckpt_lib.make_manager(tmp)
        for i in range(repeats):
            state = cli_common.build_state(cfg, None, 0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = ckpt_lib.restore_latest(manager, state)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ckpt_lib.save(out, i + 1, state)
            saves.append(time.perf_counter() - t1)
            restores.append(t1 - t0)
            del state
    return dict(bytes=size, restore_ms=statistics.median(restores) * 1e3, save_ms=statistics.median(saves) * 1e3,
                restore_runs_ms=[r * 1e3 for r in restores], save_runs_ms=[v * 1e3 for v in saves])


def check_submission(kt: str, ck: str, outdir: Path) -> float:
    """Each submission PNG against ``encode_disp_png`` of the unpadded
    disparity computed here on the same pair with the same restored weights:
    at most ``SUBMISSION_TOL_CODES`` apart. Returns the largest difference."""
    from PIL import Image

    cfg = cli_common.resolve_config(cli_common.base_parser("").parse_args([]), "kitti_infer")
    state, _ = cli_common.restore(cli_common.build_state(cfg, None, 0), ck)
    specs, _ = kitti.list_kitti(kt, split="testing")
    if len(specs) != CLI_KITTI_PAIRS:
        raise AssertionError(f"submission: {len(specs)} test pairs listed")
    worst = 0
    with torch.inference_mode():
        state.model.eval()
        for spec in specs:
            png = np.asarray(Image.open(outdir / os.path.basename(spec.left)))
            if png.dtype != np.uint16 or png.shape != CLI_KITTI_SIZE:
                raise AssertionError(f"submission: {spec.left}: PNG {png.dtype} {png.shape}")
            sample = kitti.load_sample(spec, crop=None)
            left, right = (torch.from_numpy(sample[k])[None].cuda() for k in ("left", "right"))
            disp = state.model(left, right)[0][0].float().cpu().numpy()
            want = kitti.encode_disp_png(unpad(disp, tuple(sample["pads"])))
            worst = max(worst, int(np.abs(png.astype(np.int32) - want).max()))
    if worst > SUBMISSION_TOL_CODES:
        raise AssertionError(f"submission PNGs differ from the in-process disparity by {worst} codes")
    del state
    return worst


def cli_phase(card: str, root: Path) -> dict:
    """The command-line drivers on files under ``root`` (see the module's
    docstring, item 6). Returns the runs and the trees' paths."""
    t_phase = time.perf_counter()
    runs = {}
    sf, kt = write_cli_trees(root)
    specs, _ = list_sceneflow(sf)
    if len(specs) != CLI_SF_PAIRS:
        raise AssertionError(f"list_sceneflow found {len(specs)} pairs, wrote {CLI_SF_PAIRS}")
    ck, ck2, outdir = str(root / "ck"), str(root / "ck2"), root / "disp_0"

    train_args = ["--config", TRAIN_SLICE, "--datapath", sf, "--savemodel", ck]
    runs["cli_train"], out = drive("train", cli_train, [*train_args, "--steps", str(CLI_TRAIN_STEPS)],
                                   **_steps(CLI_TRAIN_STEPS))
    runs["cli_train_resume"], out = drive(
        "train (resume)", cli_train, [*train_args, "--steps", str(CLI_RESUME_STEPS)],
        **_steps(CLI_RESUME_STEPS - CLI_TRAIN_STEPS))
    if f"auto-resumed from step {CLI_TRAIN_STEPS}" not in out:
        raise AssertionError("train did not auto-resume from its checkpoint")
    if ckpt_lib.make_manager(ck).all_steps() != [CLI_TRAIN_STEPS, CLI_RESUME_STEPS]:
        raise AssertionError(f"train checkpoints {ckpt_lib.make_manager(ck).all_steps()}")
    logged = [json.loads(line) for line in Path(ck, "metrics.jsonl").read_text().splitlines()]
    if [m["step"] for m in logged] != [CLI_TRAIN_STEPS, CLI_RESUME_STEPS] or not all(
            math.isfinite(m["loss"]) for m in logged):
        raise AssertionError(f"train metrics {logged}")
    runs["cli_train"]["logged"] = logged[0]
    runs["cli_train_resume"]["logged"] = logged[1]
    loader = loader_rate(specs)
    records = tfrecord_rate(specs, root)

    # finetune's validation eval every CLI_FINETUNE_EVAL_EVERY steps (the
    # preset's is its checkpoint interval, 1000): at step 2 on the weights of
    # the step its train graph was captured at, at step 4 after two replays.
    # The train replays update the weights in place, at the addresses the
    # eval graph reads, so every validation's pairs go through one eval
    # graph: the first pair eager, the second captured, the rest replayed
    _, val = kitti.list_kitti(kt)
    evals = CLI_FINETUNE_STEPS // CLI_FINETUNE_EVAL_EVERY
    want = _plus(_steps(CLI_FINETUNE_STEPS), _pairs(evals * len(val)))
    with preset_train("kitti_finetune", eval_every=CLI_FINETUNE_EVAL_EVERY):
        runs["cli_finetune"], out = drive("finetune", cli_finetune, [
            "--datapath", kt, "--loadmodel", ck, "--steps", str(CLI_FINETUNE_STEPS), "--batch", "4",
            "--savemodel", ck2], **want)
    if f"loaded pretrained weights (step {CLI_RESUME_STEPS})" not in out:
        raise AssertionError("finetune did not load the train checkpoint")
    validated = {r["step"]: r["eval"] for r in map(json.loads, Path(ck2, "metrics.jsonl").read_text().splitlines())
                 if "eval" in r}
    if sorted(validated) != list(range(CLI_FINETUNE_EVAL_EVERY, CLI_FINETUNE_STEPS + 1, CLI_FINETUNE_EVAL_EVERY)):
        raise AssertionError(f"finetune validated at steps {sorted(validated)}")
    runs["cli_finetune"]["validation"] = validated
    ckpt = checkpoint_times(ck2)

    for name, extra in (("cli_evaluate", []), ("cli_evaluate_pallas", ["--pallas"])):
        runs[name], out = drive(name[4:], cli_evaluate, [
            "--dataset", "kitti2015", "--datapath", kt, "--loadmodel", ck2, *extra], **_pairs(len(val), bool(extra)))
        metrics = json.loads(out.strip().splitlines()[-1])
        if metrics.get("num_pairs") != len(val) or not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"evaluate metrics {metrics}")
        runs[name]["metrics"] = metrics
    # finetune's last validation, after replayed train steps, against evaluate
    # on the checkpoint those steps wrote: an eval graph that replayed packs
    # or folds made before the replays would serve the weights of step 2
    last = validated[CLI_FINETUNE_STEPS]
    off = {k: abs(last[k] - runs["cli_evaluate"]["metrics"][k]) for k in last}
    runs["cli_finetune"]["validation_vs_evaluate"] = off
    log(f"  cli finetune: validation at step {CLI_FINETUNE_STEPS} {last}, evaluate on its checkpoint "
        f"{runs['cli_evaluate']['metrics']}: |diff| {off}")
    if not max(off.values()) <= REGRESSION_TOL_PX:
        raise AssertionError(f"finetune's validation after replayed steps is off evaluate's by {off}")

    runs["cli_submission"], out = drive("submission", cli_submission, [
        "--datapath", kt, "--loadmodel", ck2, "--outdir", str(outdir)], **_pairs(CLI_KITTI_PAIRS))
    ms = [float(line.split()[-2]) for line in out.splitlines() if line.endswith(" ms")]
    if len(ms) != CLI_KITTI_PAIRS:
        raise AssertionError(f"submission printed {len(ms)} times for {CLI_KITTI_PAIRS} pairs")
    runs["cli_submission"].update(ms_per_pair=statistics.median(ms), runs_ms=ms,
                                  max_codes_off=check_submission(kt, ck2, outdir))

    t0 = time.perf_counter()
    demo = subprocess.run(
        [sys.executable, "-m", "ecm_torch.cli.test_img", "--synthetic", "--loadmodel", ck2,
         "--out", str(root / "d.png")],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=300,
    )
    log(f"  cli test_img (subprocess, no --device): exit {demo.returncode}; {demo.stdout.strip()[-300:]}")
    if demo.returncode != 0 or not (root / "d.png").exists():
        raise AssertionError(f"test_img exited {demo.returncode}: {demo.stderr[-2000:]}")
    runs["cli_test_img"] = dict(wall_s=time.perf_counter() - t0, stdout=demo.stdout.strip()[-300:])

    wall = time.perf_counter() - t_phase
    pairs = CONFIGS[TRAIN_SLICE].data.global_batch
    log(f"phase cli: train CLI {runs['cli_train']['logged']['pairs_per_s']:.2f} pairs/s over steps "
        f"1-{CLI_TRAIN_STEPS} and {runs['cli_train_resume']['logged']['pairs_per_s']:.2f} pairs/s over steps "
        f"{CLI_TRAIN_STEPS + 1}-{CLI_RESUME_STEPS} (batch {pairs}, start-up included) [{card}]")
    log(f"phase cli: DataLoader alone {loader['pairs_per_s']:.2f} pairs/s with {loader['workers']} workers, "
        f"first batch after {loader['first_batch_s']:.2f} s [{card}]")
    log(f"phase cli: TFRecord ({records['records']} crops of {CONFIGS[TRAIN_SLICE].data.crop}, "
        f"{records['shards']} shards, {records['bytes']} bytes) write {records['write_mb_s']:.1f} MB/s, read "
        f"{records['read_mb_s']:.1f} MB/s (host) [{card}]")
    log(f"phase cli: checkpoint {ckpt['bytes']} bytes, save {ckpt['save_ms']:.1f} ms, restore "
        f"{ckpt['restore_ms']:.1f} ms (median of 3) [{card}]")
    log(f"phase cli: submission {runs['cli_submission']['ms_per_pair']:.2f} ms a pair (median of "
        f"{CLI_KITTI_PAIRS}, host arrays to host disparity) [{card}]")
    log(f"phase cli: wall {wall:.1f} s [{card}]")
    return dict(card=card, runs=runs, loader=loader, tfrecord=records, checkpoint=ckpt, wall_s=wall,
                trees=(sf, kt))


# the parallel phase (slice 9): the data axis on the one card
PAR_CONFIG = "sceneflow_dp"
PAR_RANKS = 2
PAR_TIMEOUT = 600  # seconds, for each group of processes and each collective
PAR_LOSS_REL_TOL = 2e-2  # two ranks of 6 against one process of 12, bf16
PAR_GRAD_COSINE = 0.99  # the seven gband_conv_s1 sites' weight gradients
PAR_BN_REL_TOL = 2e-2  # each running statistic, max|diff| / max|ref|
PAR_TIMED_STEPS = 3
PAR_CLI_STEPS = 2
# the gband sites' weight gradients, the first feature conv's (the 2D nets
# reach the loss through every slab) and a 3D BatchNorm weight's under remat
PAR_GRADS = (*GBAND_WEIGHTS, "feature.firstconv1.conv.weight", "aggregation.hourglass1.conv1.bn.weight")


def par_batch() -> dict:
    """``sceneflow_dp``'s global batch: 12 seeded synthetic 256x512 pairs;
    the second rank's ground truth is mostly beyond max-disp (invalid), so
    the ranks' valid-pixel counts differ."""
    cfg = CONFIGS[PAR_CONFIG]
    batch = make_batch(3, cfg.data.global_batch, *cfg.data.crop)
    half = cfg.data.global_batch // PAR_RANKS
    gt = batch["disparity"][half:]
    gt[np.random.default_rng(3).uniform(size=gt.shape) < 0.8] = 2.0 * cfg.model.max_disp
    return batch


def check_gband_rank_shape(gen, planes: int = D4) -> float:
    """``gband_conv_s1`` against its plain version at a rank's shape of the
    parallel path (6 pairs, ``planes`` disparity planes: all 48 on the data
    axis, a halo-padded slab on the disparity axis), both forward forms and
    both input gradients; the largest max|diff| / max|ref|."""
    b = CONFIGS[PAR_CONFIG].data.global_batch // PAR_RANKS
    worst = 0.0
    for cin in (2 * C, C):
        x = _rnd(gen, b, planes, TH // 4, TW // 4, cin).bfloat16()
        wt = _rnd(gen, C, cin, 3, 3, 3, scale=(27 * cin) ** -0.5)
        dy = _rnd(gen, b, planes, TH // 4, TW // 4, C).bfloat16()
        with torch.no_grad():
            pairs_ = ((gbk.gband_conv_s1(x, wt), gbk.gband_conv_s1_torch(x, wt)),
                      (gbk.gband_conv_s1_input_grad(dy, wt.bfloat16()),
                       gbk.gband_conv_s1_torch(dy, wt.flip(2, 3, 4).transpose(0, 1))))
        for out, ref in pairs_:
            worst = max(worst, ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item())
    if not worst <= PAIR_REL_TOL:
        raise AssertionError(f"gband_conv_s1 at B={b}, {planes} planes: rel err {worst} > {PAIR_REL_TOL}")
    return worst


def par_reference(batch: dict, start: dict | None = None, dtype: torch.dtype | None = None) -> tuple[dict, dict]:
    """One process's ``sceneflow_dp`` step on the global batch (the heads'
    conv2 scaled by 1e-3, as in ``compare_train_paths``; or from the
    weights ``start``), in the preset's bf16 or in ``dtype``. Returns the
    start weights (on the host) and the step's loss, the weight gradients
    of ``PAR_GRADS``, running statistics, launches, ms a step and peak
    memory."""
    cfg = CONFIGS[PAR_CONFIG]
    model = cfg.model.build(generator=torch.Generator().manual_seed(0), **({} if dtype is None else dict(dtype=dtype)))
    if model.resolve_layout(torch.device("cuda")) != "grouped" or not model.remat:
        raise AssertionError(f"{PAR_CONFIG} does not resolve to the grouped layout with remat on CUDA")
    if start is None:
        scale_heads(model, 1e-3)
        start = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    else:
        model.load_state_dict(start)
    state = create_train_state(model, make_optimizer(cfg.train.lr))
    step = make_train_step(model, cfg.model.max_disp, graphed=False)  # eager, as each rank's step is
    cuda_batch = to_device(batch, torch.device("cuda"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    state, metrics = step(state, cuda_batch)
    torch.cuda.synchronize()
    launches = read_counts()
    params = dict(model.named_parameters())
    ref = dict(
        loss=metrics["loss"].item(), valid_px=metrics["valid_px"].item(), launches=launches,
        grads={n: params[n].grad.detach().float().cpu().clone() for n in PAR_GRADS},
        stats={k: v.detach().float().cpu().clone() for k, v in model.state_dict().items()
               if k.endswith(("running_mean", "running_var"))},
    )
    ref["step_ms"] = times_ms(lambda: step(state, cuda_batch), PAR_TIMED_STEPS)
    ref["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del state, step, model, params, cuda_batch, metrics
    torch.cuda.empty_cache()
    return start, ref


def compare_ranks(ref: dict, ranks: list[dict], phase: str = "parallel", grads=GBAND_WEIGHTS,
                  norm_band: tuple[float, float] | None = None) -> dict:
    """Each rank's step against the one-process reference: logged loss,
    the weight gradients ``grads`` (cosine, and with ``norm_band`` the ratio
    of the norms within it; both are reported for every gradient the rank
    returned), every running statistic, 7 + 7 gband_conv_s1 launches and no
    other kernel."""
    want = {k: 0 for k in COUNTERS}
    want.update(gband_conv_s1=7, gband_conv_s1_input_grad=7)
    out = []
    for r, got in enumerate(ranks):
        if got["launches"] != want:
            raise AssertionError(f"{phase} rank {r}: launches {got['launches']}, expected {want}")
        loss_rel = abs(got["metrics"]["loss"] - ref["loss"]) / abs(ref["loss"])
        mine = {n: g.float().flatten() for n, g in got["grads"].items()}
        cos = {n: F.cosine_similarity(g, ref["grads"][n].flatten(), dim=0).item() for n, g in mine.items()}
        norm = {n: (g.norm() / ref["grads"][n].norm()).item() for n, g in mine.items()}
        bn_rel = max(((got["state"][k].float() - v).abs().max() / v.abs().max()).item()
                     for k, v in ref["stats"].items())
        out.append(dict(rank=r, loss=got["metrics"]["loss"], loss_rel=loss_rel, grad_cosine=cos, grad_norm_ratio=norm,
                        bn_rel=bn_rel, valid_px=got["metrics"]["valid_px"], launches=got["launches"],
                        traffic=got["traffic"], step_ms=got["step_ms"], step_ms_median=got["step_ms_median"],
                        peak_mem_gb=got["peak_mem_gb"]))
        if not loss_rel <= PAR_LOSS_REL_TOL:
            raise AssertionError(f"{phase} rank {r}: loss {got['metrics']['loss']} vs {ref['loss']}: rel {loss_rel}")
        if not min(cos[n] for n in grads) >= PAR_GRAD_COSINE:
            raise AssertionError(f"{phase} rank {r}: weight-gradient cosine {cos} below {PAR_GRAD_COSINE}")
        if norm_band is not None and not all(norm_band[0] <= norm[n] <= norm_band[1] for n in grads):
            raise AssertionError(f"{phase} rank {r}: weight-gradient norm ratios {norm} outside {norm_band}")
        if not bn_rel <= PAR_BN_REL_TOL:
            raise AssertionError(f"{phase} rank {r}: BatchNorm statistics rel {bn_rel} > {PAR_BN_REL_TOL}")
        if got["metrics"]["valid_px"] != ref["valid_px"]:
            raise AssertionError(f"{phase} rank {r}: valid_px {got['metrics']['valid_px']} vs {ref['valid_px']}")
    return dict(ranks=out)


def run_session(cmd: list[str], timeout: float, env: dict | None = None) -> subprocess.CompletedProcess:
    """``cmd`` from the repository's root in a session of its own (with
    ``env``, default this process's), killed whole (the launcher and its
    workers) after ``timeout`` seconds."""
    proc = subprocess.Popen(cmd, cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True, env=env)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def nccl_world_one(root: Path, sf: str, kt: str) -> dict:
    """``train --multihost`` under ``torch.distributed.run`` with one rank
    (NCCL, DDP) for ``PAR_CLI_STEPS`` steps of ``sceneflow_dp`` on the cli
    phase's SceneFlow-layout tree ``sf``; then the single-process
    ``evaluate`` restores the checkpoint it saved on the KITTI validation
    pairs of ``kt`` (launches 4/3/3/1/1 a pair)."""
    ck = root / "ck_multihost"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "1", "--nnodes", "1",
           "--master_addr", "localhost", "--master_port", str(dryrun.free_port()),
           "-m", "ecm_torch.cli.train", "--multihost", "--config", PAR_CONFIG, "--datapath", sf,
           "--steps", str(PAR_CLI_STEPS), "--savemodel", str(ck)]
    log(f"  parallel: {' '.join(cmd[1:])}")
    t0 = time.perf_counter()
    run = run_session(cmd, PAR_TIMEOUT)
    wall = time.perf_counter() - t0
    log(f"  parallel NCCL train: exit {run.returncode}; {run.stdout.strip()[-600:]}")
    if run.returncode != 0:
        raise AssertionError(f"train --multihost exited {run.returncode}: {run.stderr[-3000:]}")
    for text in ("multihost: 1 ranks, backend nccl, rank 0 on cuda:0", f"done at step {PAR_CLI_STEPS}"):
        if text not in run.stdout:
            raise AssertionError(f"train --multihost did not print {text!r}")
    if ckpt_lib.make_manager(str(ck)).all_steps() != [PAR_CLI_STEPS]:
        raise AssertionError(f"train --multihost checkpoints {ckpt_lib.make_manager(str(ck)).all_steps()}")
    logged = json.loads(Path(ck, "metrics.jsonl").read_text().splitlines()[-1])
    _, val = kitti.list_kitti(kt)
    evaluated, out = drive("evaluate (the multihost checkpoint)", cli_evaluate, [
        "--dataset", "kitti2015", "--datapath", kt, "--loadmodel", str(ck)], **_pairs(len(val)))
    if f"loaded checkpoint step {PAR_CLI_STEPS}" not in out:
        raise AssertionError("evaluate did not restore the multihost checkpoint")
    metrics = json.loads(out.strip().splitlines()[-1])
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"evaluate metrics {metrics}")
    return dict(train_wall_s=wall, train_logged=logged, evaluate=dict(evaluated, metrics=metrics))


def parallel_phase(card: str, gen, sf: str, kt: str) -> tuple[dict, dict, dict, dict]:
    """Slice 9's path, the data axis, on the one card (see the module's
    docstring, item 7), the NCCL train CLI on the cli phase's trees.
    Returns the phase's record, and the global batch, the start weights and
    the one-process reference, which the disp_train phase reuses."""
    t_phase = time.perf_counter()
    dry = dryrun.dryrun_multichip(PAR_RANKS, device="cuda:0", backend="gloo", timeout=PAR_TIMEOUT)
    dry["wall_s"] = time.perf_counter() - t_phase
    log(f"phase parallel: dry run, {PAR_RANKS} ranks over gloo on cuda:0: loss {dry['loss']} (one process "
        f"{dry['loss_one_process']}), parameter norm {dry['param_norm']} (one process "
        f"{dry['param_norm_one_process']}) [{card}]")
    gband_rel = check_gband_rank_shape(gen)
    batch = par_batch()
    t0 = time.perf_counter()
    start, ref = par_reference(batch)
    ref["wall_s"] = time.perf_counter() - t0
    log(f"  parallel reference, one process on {len(batch['left'])} pairs: loss {ref['loss']}, steps "
        f"{ref['step_ms']} ms, peak {ref['peak_mem_gb']:.2f} GB")
    with tempfile.TemporaryDirectory(prefix="ecm_parallel_") as tmp:
        root = Path(tmp)
        torch.save([dict(name=PAR_CONFIG, kind="step", config=PAR_CONFIG, state_dict=start,
                         batch={k: torch.from_numpy(v) for k, v in batch.items()},
                         lr=CONFIGS[PAR_CONFIG].train.lr, grads=list(GBAND_WEIGHTS),
                         timed_steps=PAR_TIMED_STEPS)], root / "cases.pt")
        t0 = time.perf_counter()
        dryrun.launch(["--cases", str(root / "cases.pt"), "--out", str(root), "--device", "cuda:0",
                       "--backend", "gloo", "--timeout", str(PAR_TIMEOUT)], PAR_RANKS, PAR_TIMEOUT)
        group_wall = time.perf_counter() - t0
        ranks = [torch.load(root / f"rank{r}.pt", weights_only=True)[PAR_CONFIG] for r in range(PAR_RANKS)]
        compared = compare_ranks(ref, ranks)
        nccl = nccl_world_one(root, sf, kt)
    for r in compared["ranks"]:
        log(f"phase parallel: rank {r['rank']} of {PAR_RANKS} (gloo, both ranks on one shared card; not a "
            f"scaling number): loss {r['loss']} (rel {r['loss_rel']:.2e}), gband weight-gradient cosine min "
            f"{min(r['grad_cosine'].values()):.5f}, BatchNorm statistics rel {r['bn_rel']:.2e}, step "
            f"{r['step_ms_median']:.2f} ms (runs {r['step_ms']}), peak {r['peak_mem_gb']:.2f} GB [{card}]")
    wall = time.perf_counter() - t_phase
    log(f"phase parallel: one process on {len(batch['left'])} pairs {statistics.median(ref['step_ms']):.2f} ms a "
        f"step; NCCL world-size-1 train CLI {nccl['train_wall_s']:.1f} s; wall {wall:.1f} s [{card}]")
    record = dict(card=card, dryrun=dry, gband_rank_shape_rel=gband_rel, reference={
        k: v for k, v in ref.items() if k not in ("grads", "stats")}, group_wall_s=group_wall,
        launches=compared["ranks"][0]["launches"], nccl=nccl, wall_s=wall, **compared)
    return record, batch, start, ref


# the disp phase (slice 10): BASELINE config 4, the disparity axis, on the one
# card: four ranks share cuda:0 over gloo (NCCL refuses two ranks on one device)
DISP_CONFIG = "middlebury_disp_sharded"
DISP_RANKS = CONFIGS[DISP_CONFIG].train.mesh_disp
DISP_MAX_DISP = CONFIGS[DISP_CONFIG].model.max_disp  # 384; the CLIs need --maxdisp 384
# a Middlebury 2014 half-resolution frame (about 1000x1500), padded to a
# multiple of 32 as data/middlebury.py pads it
DISP_H, DISP_W = 1024, 1504
DISP_F32_H, DISP_F32_W = 256, 512
DISP_TIMED = 5
DISP_TIMEOUT = 600  # seconds, for each group of processes and each collective
DISP_PX_TOL = 1e-3  # f32 disparity, as tests/test_parallel.py:193-195
DISP_EPE_TOL = 1e-3
# the f32 checks scale the heads' conv2 (scale_heads) so that the largest
# cost of the f32 pair is this: at random init the costs reach 1e4-1e6,
# where the soft-argmin is a hard argmax that a rounding flips at near-ties
# (on the CPU, at 1e-3 of the init, costs of 2.5e3 moved a disparity by 0.079
# px for cost maps 2e-6 apart); at 10 it reads every plane of every slab
DISP_COST_MAX = 10.0
DISP_CLI_SCENES, DISP_CLI_SIZE = 2, (480, 640)
DISP_PER_FORWARD = dict(cost_volume_concat=1, conv3d_bn_s1=4, conv3d_bn_down=3, deconv3d_bn=3,
                        fused_conv3d_pair=1, fused_upsample_softargmin=1)


def check_cost_volume_ranges(gen) -> dict:
    """Both builders over a first, an interior and a last rank's range of
    ``middlebury_disp_sharded``'s D/4 (96 planes, 24 a rank; features
    256x376x32 bf16): each kernel slab against its plain version and against
    the same planes of the kernel's whole volume; concat bit-identical,
    correlation at ``CORR_REL_TOL``."""
    d4, per = DISP_MAX_DISP // 4, DISP_MAX_DISP // 4 // DISP_RANKS
    fl = _rnd(gen, 1, DISP_H // 4, DISP_W // 4, C).bfloat16()
    fr = _rnd(gen, 1, DISP_H // 4, DISP_W // 4, C).bfloat16()
    out = {}
    for mode, kernel, plain in (("concat", cvk.cost_volume_concat, cvk.cost_volume_concat_torch),
                                ("correlation", cvk.cost_volume_correlation, cvk.cost_volume_correlation_torch)):
        whole = kernel(fl, fr, d4)
        ranges = []
        for start in (0, per, d4 - per):
            slab = kernel(fl, fr, per, start)
            torch.cuda.synchronize()
            ref = plain(fl, fr, per, start)
            part = whole[:, start:start + per]
            rel_plain, rel_whole = (((slab.float() - r.float()).abs().max() / r.float().abs().max().clamp_min(1e-30))
                                    .item() for r in (ref, part))
            row = dict(d_start=start, planes=per, rel_vs_plain=rel_plain, rel_vs_whole=rel_whole,
                       equal_plain=torch.equal(slab, ref), equal_whole=torch.equal(slab, part))
            ranges.append(row)
            if mode == "concat" and not (row["equal_plain"] and row["equal_whole"]):
                raise AssertionError(f"cost_volume_concat from d_start {start}: not bit-identical {row}")
            if mode == "correlation" and not max(rel_plain, rel_whole) <= CORR_REL_TOL:
                raise AssertionError(f"cost_volume_{mode} from d_start {start}: {row}")
        out[mode] = ranges
        del whole
    log(f"phase kernels: d_start ranges {json.dumps(out)}")
    return out


def disp_case(name: str, bf16: bool, h: int, w: int, seed: int, head_scale: float = 1.0) -> dict:
    """An eval case of ``DISP_CONFIG`` with ``SLICE2_OVERRIDES`` (grouped
    dispatch, the concat and regression kernels) at full width, random
    weights from seed 0 (the heads' conv2 scaled by ``head_scale``), on one
    seeded synthetic pair of ``h`` x ``w`` (``dryrun.disp_eval``)."""
    overrides = dict(SLICE2_OVERRIDES, dtype=torch.bfloat16 if bf16 else torch.float32)
    model = CONFIGS[DISP_CONFIG].model.build(device="cpu", generator=torch.Generator().manual_seed(0), **overrides)
    scale_heads(model, head_scale)
    batch = make_batch(seed, 1, h, w, max_disp=0.8 * DISP_MAX_DISP)
    return dict(name=name, kind="disp_eval", mesh=(1, DISP_RANKS), config=DISP_CONFIG, timed=DISP_TIMED,
                overrides=overrides, state_dict=model.state_dict(),
                batch={k: torch.from_numpy(batch[k]) for k in ("left", "right")})


@torch.no_grad()
def scale_heads(model, scale: float) -> None:
    """The classifier heads' conv2 times ``scale``, and so the cost maps
    (the regression's upsample is linear): see ``DISP_COST_MAX``."""
    for i in (1, 2, 3):
        head = getattr(model.aggregation, f"classif{i}").conv2
        head.weight.mul_(scale)
        head.bias.mul_(scale)


def write_middlebury_tree(root: Path) -> str:
    """``DISP_CLI_SCENES`` Middlebury-layout scenes of seeded synthetic
    pairs (``make_pair``): ``im0.png``, ``im1.png``, ``disp0GT.pfm`` and
    ``calib.txt`` with ``ndisp``."""
    from PIL import Image

    rng = np.random.default_rng(7)
    for i in range(DISP_CLI_SCENES):
        s = make_pair(rng, *DISP_CLI_SIZE, max_disp=0.5 * DISP_MAX_DISP, normalized=False)
        scene = root / f"Scene{i}"
        scene.mkdir(parents=True, exist_ok=True)
        for side, name in (("left", "im0.png"), ("right", "im1.png")):
            Image.fromarray(_uint8(s[side])).save(scene / name)
        write_pfm(str(scene / "disp0GT.pfm"), s["disparity"])
        (scene / "calib.txt").write_text(f"cam0=[1 0 0; 0 1 0; 0 0 1]\nndisp={DISP_MAX_DISP}\n")
    return str(root)


def disp_cli(root: Path, head_scale: float) -> dict:
    """``evaluate --config middlebury_disp_sharded --multihost --mesh-disp 4
    --dist-backend gloo`` under ``torch.distributed.run`` (four ranks on
    cuda:0, TF32 off as here: in TF32 cuDNN's rounding moved the EPE by
    0.06 px) and ``evaluate --mesh-disp 1`` in this process, on a
    Middlebury-layout tree, in f32 from one checkpoint (random weights, the
    heads' conv2 scaled by ``head_scale``), with ``--pallas`` (the
    concat kernel over each rank's range): the metrics within
    ``DISP_EPE_TOL``."""
    tree = write_middlebury_tree(root / "middlebury")
    args = ["--config", DISP_CONFIG, "--maxdisp", str(DISP_MAX_DISP), "--no-bf16", "--pallas",
            "--dataset", "middlebury", "--datapath", tree, "--loadmodel", str(root / "ck")]
    cfg = dataclasses.replace(CONFIGS[DISP_CONFIG].model, bf16=False)
    state = create_train_state(cfg.build(generator=torch.Generator().manual_seed(0)))
    scale_heads(state.model, head_scale)
    ckpt_lib.save(ckpt_lib.make_manager(str(root / "ck")), 1, state)
    del state
    torch.cuda.empty_cache()
    # the ranks run evaluate with TF32 off, as this process runs it
    shim = root / "evaluate_f32.py"
    shim.write_text("import sys\nimport torch\n\ntorch.backends.cudnn.allow_tf32 = False\n"
                    "torch.backends.cuda.matmul.allow_tf32 = False\nfrom ecm_torch.cli import evaluate\n\n"
                    "evaluate.main(sys.argv[1:])\n")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(DISP_RANKS), "--nnodes", "1",
           "--master_addr", "localhost", "--master_port", str(dryrun.free_port()), str(shim),
           *args, "--multihost", "--mesh-disp", str(DISP_RANKS), "--dist-backend", "gloo", "--device", "cuda:0",
           "--dist-timeout", str(DISP_TIMEOUT)]
    log(f"  disp: {' '.join(cmd[1:])}")
    t0 = time.perf_counter()
    run = run_session(cmd, DISP_TIMEOUT, env={**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent)})
    wall = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"evaluate --mesh-disp {DISP_RANKS} exited {run.returncode}: {run.stderr[-3000:]}")
    if run.stdout.count(f"disp-sharded eval mesh: data 1, disp {DISP_RANKS}") != 1:
        raise AssertionError(f"evaluate --mesh-disp {DISP_RANKS}: rank 0 alone must print the mesh: {run.stdout}")
    sharded = json.loads(run.stdout.strip().splitlines()[-1])
    one, out = drive("evaluate (one process)", cli_evaluate, [*args, "--mesh-disp", "1"],
                     **_pairs(DISP_CLI_SCENES, pallas=True))
    metrics = json.loads(out.strip().splitlines()[-1])
    diff = {k: abs(sharded[k] - v) for k, v in metrics.items()}
    log(f"  disp evaluate: {DISP_RANKS} ranks {sharded}; one process {metrics}; wall {wall:.1f} s")
    if sharded["num_pairs"] != DISP_CLI_SCENES or not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"evaluate metrics {sharded} / {metrics}")
    if not max(diff.values()) <= DISP_EPE_TOL:
        raise AssertionError(f"evaluate on {DISP_RANKS} ranks against one process: |diff| {diff}")
    return dict(sharded=sharded, one_process=metrics, abs_diff=diff, ranks_wall_s=wall, one_process_cli=one)


def check_disp_ranks(name: str, ref: dict, ranks: list[dict], h: int, w: int) -> dict:
    """Each rank's forward against one process's: the launches
    (``DISP_PER_FORWARD``), the disparity finite in [0, max-disp - 1] and
    the same on every rank; returns the cost map's and the disparity's
    largest differences from the one process's."""
    want = {k: DISP_PER_FORWARD.get(k, 0) for k in COUNTERS}
    if ref["launches"] != want:
        raise AssertionError(f"disp {name}: one process's launches {ref['launches']}, expected {want}")
    cost_rel, disp_px = [], []
    for r, got in enumerate(ranks):
        if got["launches"] != want:
            raise AssertionError(f"disp {name} rank {r}: launches {got['launches']}, expected {want}")
        d = got["disp"]
        if d.shape != (1, h, w) or not torch.isfinite(d).all() or d.min() < 0 or d.max() > DISP_MAX_DISP - 1:
            raise AssertionError(f"disp {name} rank {r}: disparity {tuple(d.shape)} not finite in range")
        if not torch.equal(d, ranks[0]["disp"]):
            raise AssertionError(f"disp {name}: rank {r}'s disparity differs from rank 0's")
        cost_rel.append(((got["cost"].float() - ref["cost"].float()).abs().max()
                         / ref["cost"].float().abs().max()).item())
        disp_px.append((d.float() - ref["disp"].float()).abs().max().item())
    return dict(cost4_rel=cost_rel, disp_px=disp_px)


def gloo_cuda_probe(root: Path) -> dict:
    """Whether gloo all-gathers and sends CUDA tensors on this machine's
    torch (two ranks on cuda:0; the halos stage them through host memory
    either way, as gloo's documentation lists neither): rank 0's answers, or
    how the ranks failed. A report, not a gate."""
    torch.save([dict(name="gloo_cuda", kind="gloo_cuda")], root / "probe.pt")
    try:
        dryrun.launch(["--cases", str(root / "probe.pt"), "--out", str(root / "probe"), "--device", "cuda:0",
                       "--backend", "gloo", "--timeout", "60"], 2, 120)
    except (RuntimeError, subprocess.TimeoutExpired) as e:
        return dict(failed=str(e)[-600:])
    return torch.load(root / "probe" / "rank0.pt", weights_only=True)["gloo_cuda"]


def disp_phase(card: str) -> dict:
    """Slice 10's path, the disparity axis (see the module's docstring,
    item 8): the ranks' forwards against one process's, then the CLI."""
    t_phase = time.perf_counter()
    cuda = torch.device("cuda")
    unscaled = dryrun.disp_eval(disp_case("f32", False, DISP_F32_H, DISP_F32_W, 22), None, cuda)
    head_scale = DISP_COST_MAX / unscaled["cost"].abs().max().item()
    cases = [disp_case("bf16", True, DISP_H, DISP_W, 21),
             disp_case("f32", False, DISP_F32_H, DISP_F32_W, 22, head_scale)]
    refs = {}
    for c in cases:
        refs[c["name"]] = dryrun.disp_eval(c, None, cuda)
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="ecm_disp_") as tmp:
        root = Path(tmp)
        torch.save(cases, root / "cases.pt")
        t0 = time.perf_counter()
        dryrun.launch(["--cases", str(root / "cases.pt"), "--out", str(root), "--device", "cuda:0",
                       "--backend", "gloo", "--timeout", str(DISP_TIMEOUT)], DISP_RANKS, DISP_TIMEOUT)
        group_wall = time.perf_counter() - t0
        ranks = [torch.load(root / f"rank{r}.pt", weights_only=True) for r in range(DISP_RANKS)]
        bf16 = check_disp_ranks("bf16", refs["bf16"], [r["bf16"] for r in ranks], DISP_H, DISP_W)
        if not max(bf16["cost4_rel"]) <= COST4_REL_TOL:
            raise AssertionError(f"disp bf16: gathered cost map against one process's {bf16['cost4_rel']}")
        f32 = check_disp_ranks("f32", refs["f32"], [r["f32"] for r in ranks], DISP_F32_H, DISP_F32_W)
        if not max(f32["disp_px"]) <= DISP_PX_TOL:
            raise AssertionError(f"disp f32: disparity against one process's {f32['disp_px']} px")
        cli = disp_cli(root, head_scale)
        probe = gloo_cuda_probe(root)
    log(f"phase disp: gloo with CUDA tensors on torch {torch.__version__}: {probe}")
    per_rank = []
    for r, res in enumerate(ranks):
        got = res["bf16"]
        per_rank.append(dict(rank=r, ms=got["ms"], ms_median=got["ms_median"], peak_mem_gb=got["peak_mem_gb"],
                             traffic=got["traffic"], f32_ms_median=res["f32"]["ms_median"],
                             f32_traffic=res["f32"]["traffic"]))
        log(f"phase disp: rank {r} of {DISP_RANKS} (gloo, four ranks on one shared card; not a scaling number): "
            f"{DISP_H}x{DISP_W} max-disp {DISP_MAX_DISP} bf16 {got['ms_median']:.2f} ms a forward (runs "
            f"{got['ms']}), peak {got['peak_mem_gb']:.3f} GB, traffic a forward {got['traffic']}; cost4 rel "
            f"{bf16['cost4_rel'][r]:.3e}; f32 {DISP_F32_H}x{DISP_F32_W} disparity {f32['disp_px'][r]:.3e} px [{card}]")
    one = refs["bf16"]
    wall = time.perf_counter() - t_phase
    log(f"phase disp: one process {DISP_H}x{DISP_W} bf16 {one['ms_median']:.2f} ms a forward (runs {one['ms']}), "
        f"peak {one['peak_mem_gb']:.3f} GB; ranks {group_wall:.1f} s; CLI {cli['ranks_wall_s']:.1f} s; "
        f"wall {wall:.1f} s [{card}]")
    return dict(card=card, launches=ranks[0]["bf16"]["launches"], ranks=per_rank, bf16=bf16, f32=f32, cli=cli,
                gloo_cuda=probe, f32_head_scale=head_scale, f32_unscaled_cost_max=unscaled["cost"].abs().max().item(),
                one_process=dict(ms=one["ms"], ms_median=one["ms_median"], peak_mem_gb=one["peak_mem_gb"],
                                 f32_ms_median=refs["f32"]["ms_median"]),
                group_wall_s=group_wall, wall_s=wall)


# the disp_train phase (slice 11): sceneflow_dp's step on a (data 2, disp 2)
# grid of four ranks that share cuda:0 over gloo, held against the parallel
# phase's one-process step on the same 12 pairs from the same weights
DTRAIN_MESH = (2, 2)
DTRAIN_RANKS = DTRAIN_MESH[0] * DTRAIN_MESH[1]
DTRAIN_NORM_BAND = (0.97, 1.03)  # each gated weight gradient's norm over one process's
# in bf16 the early feature convs' gradients are mostly rounding noise, in
# one process too (the phase prints one process's bf16 step against its f32
# step on the same pairs): the bf16 step gates the gband sites and a 3D
# BatchNorm and prints the rest; an f32 step on 4 of the 12 pairs (2 a data
# row) gates every gradient of PAR_GRADS
DTRAIN_BF16_GRADS = (*GBAND_WEIGHTS, "aggregation.hourglass1.conv1.bn.weight")
DTRAIN_F32_ROWS = [0, 1, 6, 7]
# a rank's halo-padded slab of the 48 planes at disp 2 (24 + one plane from
# its one neighbour), and an interior rank's of a longer grid (24 + 2)
DTRAIN_SLAB_PLANES = (D4 // DTRAIN_MESH[1] + 1, D4 // DTRAIN_MESH[1] + 2)
DTRAIN_CLI_DISP = 2


def crop_copy_ms(gen) -> float:
    """ms (CUDA events, median of 10) of the copy ``halo._crop`` makes of a
    ``gband_conv_s1`` output slab at a rank's shape, 6 x 25 planes cropped
    to 24: at batch > 1 the narrowed planes are not contiguous."""
    b = CONFIGS[PAR_CONFIG].data.global_batch // PAR_RANKS
    y = _rnd(gen, b, DTRAIN_SLAB_PLANES[0], TH // 4, TW // 4, C).bfloat16()
    return time_ms(lambda: y.narrow(1, 0, D4 // DTRAIN_MESH[1]).clone(memory_format=torch.contiguous_format))


def disp_train_cli(sf: str, kt: str, root: Path) -> dict:
    """``train --multihost --mesh-disp 2 --dist-backend gloo --device
    cuda:0`` under ``torch.distributed.run`` (two ranks on the one card, a
    ``(1, 2)`` grid) for ``PAR_CLI_STEPS`` steps of ``sceneflow_dp`` on the
    cli phase's SceneFlow-layout tree ``sf``: rank 0 alone prints the mesh
    and writes one checkpoint, the logged loss is finite; then the
    single-process ``evaluate`` restores it on the KITTI validation pairs of
    ``kt`` (launches 4/3/3/1/1 a pair)."""
    ck = root / "ck_disp_train"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(DTRAIN_CLI_DISP), "--nnodes", "1",
           "--master_addr", "localhost", "--master_port", str(dryrun.free_port()),
           "-m", "ecm_torch.cli.train", "--multihost", "--mesh-disp", str(DTRAIN_CLI_DISP), "--dist-backend", "gloo",
           "--device", "cuda:0", "--dist-timeout", str(PAR_TIMEOUT), "--config", PAR_CONFIG, "--datapath", sf,
           "--steps", str(PAR_CLI_STEPS), "--savemodel", str(ck)]
    log(f"  disp_train: {' '.join(cmd[1:])}")
    t0 = time.perf_counter()
    run = run_session(cmd, PAR_TIMEOUT)
    wall = time.perf_counter() - t0
    log(f"  disp_train CLI: exit {run.returncode}; {run.stdout.strip()[-600:]}")
    if run.returncode != 0:
        raise AssertionError(f"train --mesh-disp {DTRAIN_CLI_DISP} exited {run.returncode}: {run.stderr[-3000:]}")
    for text in (f"multihost: {DTRAIN_CLI_DISP} ranks, backend gloo, rank 0 on cuda:0",
                 f"training mesh: data 1, disp {DTRAIN_CLI_DISP}", f"done at step {PAR_CLI_STEPS}"):
        if run.stdout.count(text) != 1:
            raise AssertionError(f"train --mesh-disp {DTRAIN_CLI_DISP}: rank 0 alone must print {text!r}")
    if ckpt_lib.make_manager(str(ck)).all_steps() != [PAR_CLI_STEPS]:
        raise AssertionError(f"train --mesh-disp checkpoints {ckpt_lib.make_manager(str(ck)).all_steps()}")
    logged = json.loads(Path(ck, "metrics.jsonl").read_text().splitlines()[-1])
    if not math.isfinite(logged["loss"]):
        raise AssertionError(f"train --mesh-disp {DTRAIN_CLI_DISP}: logged loss {logged['loss']}")
    _, val = kitti.list_kitti(kt)
    evaluated, out = drive("evaluate (the disp-trained checkpoint)", cli_evaluate, [
        "--dataset", "kitti2015", "--datapath", kt, "--loadmodel", str(ck)], **_pairs(len(val)))
    if f"loaded checkpoint step {PAR_CLI_STEPS}" not in out:
        raise AssertionError("evaluate did not restore the disp-trained checkpoint")
    metrics = json.loads(out.strip().splitlines()[-1])
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"evaluate metrics {metrics}")
    return dict(train_wall_s=wall, train_logged=logged, evaluate=dict(evaluated, metrics=metrics))


def disp_train_phase(card: str, gen, batch: dict, start: dict, ref: dict, sf: str, kt: str) -> dict:
    """Slice 11's path, training on the disparity axis (see the module's
    docstring, item 9)."""
    t_phase = time.perf_counter()
    slab_rel = {planes: check_gband_rank_shape(gen, planes) for planes in DTRAIN_SLAB_PLANES}
    crop_ms = crop_copy_ms(gen)
    log(f"phase disp_train: gband_conv_s1 at 6 pairs x {list(slab_rel)} planes against its plain version, "
        f"forward and input gradient: rel {slab_rel} (<= {PAIR_REL_TOL}); a slab crop's copy {crop_ms:.4f} ms [{card}]")
    small = {k: v[DTRAIN_F32_ROWS] for k, v in batch.items()}
    _, ref32 = par_reference(small, start, torch.float32)
    _, ref16 = par_reference(small, start)
    torch.cuda.empty_cache()
    floor = {n: (F.cosine_similarity(g.flatten(), ref32["grads"][n].flatten(), dim=0).item(),
                 (g.norm() / ref32["grads"][n].norm()).item()) for n, g in ref16["grads"].items()}
    log(f"phase disp_train: one process, bf16 against f32 on {len(DTRAIN_F32_ROWS)} pairs, weight gradients (cosine, "
        f"norm ratio): {floor} [{card}]")
    lr = CONFIGS[PAR_CONFIG].train.lr
    with tempfile.TemporaryDirectory(prefix="ecm_disp_train_") as tmp:
        root = Path(tmp)
        torch.save([dict(name="bf16", kind="step", mesh=DTRAIN_MESH, config=PAR_CONFIG, state_dict=start,
                         batch={k: torch.from_numpy(v) for k, v in batch.items()}, lr=lr, grads=list(PAR_GRADS),
                         timed_steps=PAR_TIMED_STEPS),
                    dict(name="f32", kind="step", mesh=DTRAIN_MESH, config=PAR_CONFIG, state_dict=start,
                         overrides=dict(dtype=torch.float32), batch={k: torch.from_numpy(v) for k, v in small.items()},
                         lr=lr, grads=list(PAR_GRADS))], root / "cases.pt")
        t0 = time.perf_counter()
        dryrun.launch(["--cases", str(root / "cases.pt"), "--out", str(root), "--device", "cuda:0",
                       "--backend", "gloo", "--timeout", str(PAR_TIMEOUT)], DTRAIN_RANKS, PAR_TIMEOUT)
        group_wall = time.perf_counter() - t0
        results = [torch.load(root / f"rank{r}.pt", weights_only=True) for r in range(DTRAIN_RANKS)]
        ranks = [res["bf16"] for res in results]
        compared = compare_ranks(ref, ranks, "disp_train bf16", DTRAIN_BF16_GRADS, DTRAIN_NORM_BAND)
        f32 = compare_ranks(ref32, [res["f32"] for res in results], "disp_train f32", PAR_GRADS, DTRAIN_NORM_BAND)
        cli = disp_train_cli(sf, kt, root)
    for r, r32, got in zip(compared["ranks"], f32["ranks"], ranks):
        t = got["traffic"]
        log(f"phase disp_train: rank {r['rank']} of {DTRAIN_RANKS}, data {DTRAIN_MESH[0]} x disp {DTRAIN_MESH[1]} "
            f"(four ranks sharing one card over gloo; not a scaling number): bf16 on 12 pairs: loss {r['loss']} (rel "
            f"{r['loss_rel']:.2e}), weight gradients (cosine, norm ratio) {_grad_summary(r)}, BatchNorm statistics "
            f"rel {r['bn_rel']:.2e}; f32 on 4 pairs: loss rel {r32['loss_rel']:.2e}, weight gradients "
            f"{_grad_summary(r32)}, BatchNorm statistics rel {r32['bn_rel']:.2e}; bf16 step {r['step_ms_median']:.2f} "
            f"ms (runs {r['step_ms']}), peak "
            f"{r['peak_mem_gb']:.2f} GB (one process on 12 pairs {ref['peak_mem_gb']:.2f} GB); a step's traffic: "
            f"halo forward {t['halo_messages']} messages {t['halo_bytes']} B (with the remat recomputation), halo "
            f"backward {t['halo_grad_messages']} messages {t['halo_grad_bytes']} B, gather {t['gather_messages']} "
            f"messages {t['gather_bytes']} B (its backward sends nothing), slab crop copies {t['copies']}, "
            f"gband_conv_s1 copies {got['gband_copies']} [{card}]")
    wall = time.perf_counter() - t_phase
    log(f"phase disp_train: one process on {len(batch['left'])} pairs {statistics.median(ref['step_ms']):.2f} ms a "
        f"step; ranks {group_wall:.1f} s; CLI {cli['train_wall_s']:.1f} s; wall {wall:.1f} s [{card}]")
    return dict(card=card, mesh=DTRAIN_MESH, gband_slab_rel=slab_rel, crop_copy_ms=crop_ms,
                launches=ranks[0]["launches"], gband_copies=[got["gband_copies"] for got in ranks], cli=cli,
                f32=dict(reference={k: v for k, v in ref32.items() if k not in ("grads", "stats")}, **f32),
                bf16_against_f32_one_process=floor,
                group_wall_s=group_wall, wall_s=wall, **compared)


# the overfit phase (slice 12): the JAX package's convergence gate
# (benchmarks/overfit_gate.py) through the port's train CLI
OVERFIT_PRESETS = ("overfit_gate", "overfit_gate_grouped")
OVERFIT_EPE_PX = 2.0  # benchmarks/overfit_gate.py:31
# the TPU's step-50 and step-600 EPE (benchmarks/OVERFIT.json), printed as
# context only: the reference's result, not a number of the port
OVERFIT_TPU_EPE = {"overfit_gate": (3.9488, 0.1414), "overfit_gate_grouped": (5.8788, 0.1614)}
# the port's eager step's step-600 EPE on this phase's H100 runs before its
# train step was captured (PERF.md §6), printed as context
OVERFIT_EAGER_EPE = {"overfit_gate": "0.34-0.60", "overfit_gate_grouped": "1.1561"}


def time_train_step(cfg, batch_size: int, crop: tuple[int, int]) -> dict:
    """One state of ``cfg`` (a resolved ``ExperimentConfig``) stepping on one
    synthetic batch: ``RUNS`` graphed steps (after the first, eager, and
    the second, captured) and ``RUNS`` eager ones in one call, each
    profiled, with the capture's ms and pool and each side's peak."""
    model = cfg.model.build(generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, make_optimizer(cfg.train.lr))
    batch = to_device(make_batch(3, batch_size, *crop), torch.device("cuda"))
    graphed = make_train_step(model, cfg.model.max_disp)
    eager = make_train_step(model, cfg.model.max_disp, graphed=False)
    graphed(state, batch)
    torch.cuda.reset_peak_memory_stats()
    graphed_runs = times_ms(lambda: graphed(state, batch))  # the first is the capture
    graphed_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    eager_runs = times_ms(lambda: eager(state, batch))
    eager_peak = torch.cuda.max_memory_allocated() / 1e9
    (captured,) = graphed.graphed.graphs.values()
    out = dict(
        ms_per_step=statistics.median(graphed_runs), eager_ms_per_step=statistics.median(eager_runs),
        runs_ms=graphed_runs, eager_runs_ms=eager_runs, capture_ms=captured.capture_ms,
        pool_bytes=captured.pool_bytes, peak_mem_gb=graphed_peak, eager_peak_mem_gb=eager_peak,
    )
    symbol = f"{CONV_WGMMA}<1" if cfg.model.bf16 else CONV_CUDA_CORES
    out.update(profile=profile_train_step(state, graphed, batch, symbol),
               profile_eager=profile_train_step(state, eager, batch, symbol))
    del model, state, graphed, eager, captured, batch
    torch.cuda.empty_cache()
    return out


def overfit_phase(card: str, root: Path) -> dict:
    """Both gate presets through ``ecm_torch.cli.train`` for their 600
    steps over 4 fixed synthetic batches (see the module's docstring, item
    10): the launch counts set to 0 just before and read just after each
    run, the step-600 EPE below ``OVERFIT_EPE_PX`` and every logged loss
    finite. Each run's train step is one CUDA graph: 1 eager step, 1
    captured, 598 replayed."""
    t_phase = time.perf_counter()
    out = {}
    for preset in OVERFIT_PRESETS:
        # the preset as the CLI resolves it: --maxdisp (default 192) sets
        # max_disp over the preset's, in both packages
        # (ecm_tpu/cli/common.py:75), so "auto" is the grouped dispatch,
        # whose 7 + 7 gband_conv_s1 launches a step drive holds each run to
        cfg = cli_common.resolve_config(cli_common.base_parser("").parse_args(["--config", preset]), preset)
        steps = cfg.train.num_steps
        ck = root / f"ck_{preset}"
        run, _ = drive(preset, cli_train, ["--config", preset, "--savemodel", str(ck)], **_steps(steps))
        rows = [json.loads(line) for line in Path(ck, "metrics.jsonl").read_text().splitlines()]
        first, last = rows[0], rows[-1]
        if last["step"] != steps or not all(math.isfinite(r["loss"]) for r in rows):
            raise AssertionError(f"overfit {preset}: logged {[(r['step'], r['loss']) for r in rows]}")
        per_step = {k: v / steps for k, v in run["launches"].items() if v}
        out[preset] = dict(
            run, max_disp=cfg.model.max_disp, bf16=cfg.model.bf16, first={k: first[k] for k in ("step", "loss", "epe")},
            last={k: last[k] for k in ("step", "loss", "epe")},
            epe_by_step={r["step"]: r["epe"] for r in rows},
            ms_per_step_median=statistics.median(r["step_time_ms"] for r in rows),
            launches_per_step=per_step, gate_epe_px=OVERFIT_EPE_PX,
        )
        tpu = OVERFIT_TPU_EPE[preset]
        log(f"phase overfit: {preset} ({cfg.model.max_disp} disparities, the preset's {CONFIGS[preset].model.max_disp} "
            f"overridden by --maxdisp's default; {'bf16' if cfg.model.bf16 else 'f32'}, "
            f"grouped): step {first['step']} loss {first['loss']:.4f} EPE "
            f"{first['epe']:.4f} px, step {last['step']} loss {last['loss']:.4f} EPE {last['epe']:.4f} px (gate < "
            f"{OVERFIT_EPE_PX}); {run['wall_s']:.1f} s, {out[preset]['ms_per_step_median']:.2f} ms a step (median "
            f"of {len(rows)} logged windows), launches a step {per_step} ({run['replayed']['gband_conv_s1'] // 7} "
            f"steps replayed) [{card}]; for context, the port's eager step ended at EPE "
            f"{OVERFIT_EAGER_EPE[preset]} px (PERF.md §6) and the TPU's went {tpu[0]} -> {tpu[1]} px "
            f"(benchmarks/OVERFIT.json)")
        if not last["epe"] < OVERFIT_EPE_PX:
            raise AssertionError(f"overfit {preset}: step-{steps} EPE {last['epe']} px, not below {OVERFIT_EPE_PX}")
        shutil.rmtree(ck)
    # one overfit_gate step (f32, remat) timed and profiled, graphed and eager
    cfg = cli_common.resolve_config(cli_common.base_parser("").parse_args(["--config", "overfit_gate"]),
                                    "overfit_gate")
    gate = out["overfit_gate_step"] = time_train_step(cfg, cfg.data.global_batch, cfg.data.crop)
    log(f"phase overfit: one overfit_gate step ({cfg.data.global_batch} x {cfg.data.crop}, max-disp "
        f"{cfg.model.max_disp}, f32, remat): graphed {gate['ms_per_step']:.2f} ms, eager "
        f"{gate['eager_ms_per_step']:.2f} ms (medians of {RUNS}); idle share graphed "
        f"{gate['profile']['idle_share']:.3f}, eager {gate['profile_eager']['idle_share']:.3f}; capture "
        f"{gate['capture_ms']:.1f} ms, pool {gate['pool_bytes']} bytes; peak allocated graphed "
        f"{gate['peak_mem_gb']:.2f} GB, eager {gate['eager_peak_mem_gb']:.2f} GB [{card}]")
    out["wall_s"] = time.perf_counter() - t_phase
    return out


def profiling_phase(card: str, served: dict, profiled: dict) -> dict:
    """``ecm_torch.utils.profiling`` on the card (see the module's
    docstring, item 11): the grouped path's profiled window (``trace`` and
    ``timed``, ``profile_forward``) beside the serving median, and the
    formula's FLOPs against ``FlopCounterMode``'s."""
    from torch.utils.flop_counter import FlopCounterMode

    t_phase = time.perf_counter()
    parts = profiling.flops_stereo_parts(H, W, MAX_DISP, num_heads=1, regress_mode="fused")
    plain = CONFIGS["kitti_infer"].model.build(generator=torch.Generator().manual_seed(0), **PLAIN)
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        plain(*pairs(1, 600))
    counts = counter.get_flop_counts()
    convs = {k.split(".", 1)[-1]: v.get(torch.ops.aten.convolution, 0) / 1e9 for k, v in counts.items()
             if k in ("Global", "ECMStereo.feature", "ECMStereo.aggregation")}
    hg_deconv = sum(counts[f"ECMStereo.aggregation.hourglass{i}.conv{k}"].get(torch.ops.aten.convolution, 0)
                    for i in (1, 2, 3) for k in (5, 6)) / 1e9
    del plain
    torch.cuda.empty_cache()
    formula_gf, counter_gf = sum(parts.values()) / 1e9, convs["Global"]
    ms_pair = served["ms_per_pair_b8"]
    conv = profiled["conv_kernels"][CONV_WGMMA] / profiled["runs"]
    out = dict(
        card=card, trace_file=profiled["trace_file"], trace_device_events=profiled["device_events"],
        conv_core_per_forward=conv, timed_ms=profiled["timed_ms"], event_median_ms=served["ms_per_forward_b1"],
        formula_gflop_per_pair=formula_gf, formula_parts_gflop={k: v / 1e9 for k, v in parts.items()},
        counter_conv_gflop_per_pair=counter_gf, counter_gflop_by_module=convs, counter_deconv5_6_gflop=hg_deconv,
        formula_over_counter=formula_gf / counter_gf, ms_per_pair_b8=ms_pair,
        formula_tflop_s=formula_gf / ms_pair, counter_tflop_s=counter_gf / ms_pair,
    )
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase profiling: trace of {profiled['runs']} grouped batch-1 forwards in {out['trace_file']}: "
        f"{profiled['device_events']} device events, {CONV_WGMMA} {conv:g} a forward [{card}]")
    log(f"phase profiling: timed {profiled['timed_ms']:.2f} ms a forward (mean of 10 after 2, one pair) against "
        f"the serving phase's CUDA-event median {served['ms_per_forward_b1']:.2f} ms [{card}]")
    log(f"phase profiling: FLOPs a pair at 384x1248, max-disp 192, one head: the formula "
        f"(flops_stereo_parts, over-counts: ecm_tpu/utils/profiling.py:56-63, :76, :82-83) {formula_gf:.1f} GF, "
        f"{out['formula_tflop_s']:.1f} TFLOP/s at the grouped batch-8 {ms_pair:.3f} ms a pair; FlopCounterMode "
        f"over the plain path's convolutions {counter_gf:.1f} GF (features {convs['feature']:.1f}, aggregation "
        f"{convs['aggregation']:.1f}, of which the transposed convs {hg_deconv:.1f}), {out['counter_tflop_s']:.1f} "
        f"TFLOP/s; formula / counter {out['formula_over_counter']:.3f} [{card}]")
    return out


def _grad_summary(r: dict) -> str:
    return ", ".join(f"{n.replace('aggregation.', '').replace('.weight', '')} ({c:.5f}, {r['grad_norm_ratio'][n]:.4f})"
                     for n, c in r["grad_cosine"].items())


def raft_phase(card: str) -> dict:
    """RAFT-Stereo served through ``make_infer_fn`` at the ``raft_kitti_b1``
    size (see the module's docstring, item 12): one 384x1248 pair eager,
    captured, then replayed with the launch counts set to 0 just before the
    replay; the replay equal to the eager forward bit for bit, 32 lookups a
    replay and none counted by the wrapper, as many instance norms as
    ``fnet`` has (``FNET_NORMS``: 15) and three ConvGRU cells an iteration,
    each a launch of each of ``GRU_KERNELS``;
    then the graphed and the eager
    forward timed (CUDA events, median of ``RUNS``)."""
    t_phase = time.perf_counter()
    s = RAFT_CFG["shapes"]
    iters = s["valid_iters"]
    torch.cuda.reset_peak_memory_stats()
    model = build_model("raft_stereo", device="cuda", generator=torch.Generator().manual_seed(0),
                        dtype=torch.float16, iters=iters, corr_levels=s["corr_levels"], corr_radius=s["corr_radius"])
    infer = make_infer_fn(model)
    left, right = pairs(1, 700)
    reset_counts()
    eager = infer(left, right)
    eager_launches = read_counts()
    infer(left, right)
    (captured,) = infer.graphs.values()
    reset_counts()
    replay = infer(left, right)
    torch.cuda.synchronize()
    launches, counted = read_replayed(), read_counts()
    want = {k: 0 for k in COUNTERS} | {"corr1d_lookup": iters, "instance_norm": sum(n for _, n in FNET_NORMS)} \
        | dict.fromkeys(GRU_KERNELS, 3 * iters)
    if not (captured.launches == launches == eager_launches == want and not any(counted.values())):
        raise AssertionError(f"raft: eager {eager_launches}, captured {captured.launches}, replay counted "
                             f"{counted} and replayed {launches}; {want} a forward expected")
    if eager.shape != (1, H, W) or not torch.isfinite(eager).all() or not torch.equal(replay, eager):
        raise AssertionError(f"raft: replay against eager max|diff| {(replay - eager).abs().max().item()}, "
                             f"shape {tuple(eager.shape)}, finite {torch.isfinite(eager).all().item()}")
    graphed_runs = times_ms(lambda: infer(left, right))
    with torch.inference_mode():
        eager_runs = times_ms(lambda: model(left, right)[-1])
    out = dict(
        card=card, iters=iters, launches=launches, eager_launches=eager_launches, replays=captured.replays,
        ms_per_forward=statistics.median(graphed_runs), eager_ms_per_forward=statistics.median(eager_runs),
        runs_ms=graphed_runs, eager_runs_ms=eager_runs, capture_ms=captured.capture_ms,
        pool_bytes=captured.pool_bytes, peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
        disparity_range=[eager.min().item(), eager.max().item()],
    )
    del model, infer, captured
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase raft: 384x1248, {iters} iterations, float16: replay equal to eager, {launches['corr1d_lookup']} "
        f"lookups, {launches['instance_norm']} instance norms and "
        f"{', '.join(f'{launches[k]} {k}' for k in GRU_KERNELS)} a replay; graphed {out['ms_per_forward']:.2f} ms, eager {out['eager_ms_per_forward']:.2f} ms a "
        f"forward (medians of {RUNS}); capture {out['capture_ms']:.1f} ms, pool {out['pool_bytes']} bytes, peak "
        f"reserved {out['peak_reserved_gb']:.2f} GB; wall {out['wall_s']:.1f} s [{card}]")
    return out


def igev_phase(card: str) -> dict:
    """IGEV-Stereo served through ``make_infer_fn`` at the ``igev_kitti_b1``
    size (see the module's docstring, item 13): one 384x1248 pair eager,
    captured, then replayed with the launch counts set to 0 just before the
    replay; the replay equal to the eager forward bit for bit, one group-wise
    volume, 32 lookups, ``IGEV_NORMS`` instance norms and three ConvGRU cells
    an iteration a replay, none counted by the wrappers; the device
    operations a replay runs (torch.profiler); then the graphed and the
    eager forward timed (CUDA events, median of ``RUNS``)."""
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    s = IGEV_CFG["shapes"]
    iters = s["valid_iters"]
    torch.cuda.reset_peak_memory_stats()
    model = build_model("igev_stereo", device="cuda", generator=torch.Generator().manual_seed(0),
                        dtype=torch.float16, iters=iters, max_disp=s["max_disp"], corr_levels=s["corr_levels"],
                        corr_radius=s["corr_radius"])
    infer = make_infer_fn(model)
    left, right = pairs(1, 701)
    reset_counts()
    eager = infer(left, right)
    eager_launches = read_counts()
    infer(left, right)
    (captured,) = infer.graphs.values()
    reset_counts()
    replay = infer(left, right)
    torch.cuda.synchronize()
    launches, counted = read_replayed(), read_counts()
    want = {k: 0 for k in COUNTERS} | {"geo_lookup": iters, "gwc_volume": 1, "instance_norm": IGEV_NORMS} \
        | dict.fromkeys(GRU_KERNELS, 3 * iters)
    if not (captured.launches == launches == eager_launches == want and not any(counted.values())):
        raise AssertionError(f"igev: eager {eager_launches}, captured {captured.launches}, replay counted "
                             f"{counted} and replayed {launches}; {want} a forward expected")
    if eager.shape != (1, H, W) or not torch.isfinite(eager).all() or not torch.equal(replay, eager):
        raise AssertionError(f"igev: replay against eager max|diff| {(replay - eager).abs().max().item()}, "
                             f"shape {tuple(eager.shape)}, finite {torch.isfinite(eager).all().item()}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        infer(left, right)
        torch.cuda.synchronize()
    ops = [e for e in device_events(prof) if "Memcpy" not in e.name]
    graphed_runs = times_ms(lambda: infer(left, right))
    with torch.inference_mode():
        eager_runs = times_ms(lambda: model(left, right)[-1])
    out = dict(
        card=card, iters=iters, launches=launches, eager_launches=eager_launches, replays=captured.replays,
        device_ops_a_replay=len(ops), geo_lookups_profiled=sum(GEO_LOOKUP in e.name for e in ops),
        ms_per_forward=statistics.median(graphed_runs), eager_ms_per_forward=statistics.median(eager_runs),
        runs_ms=graphed_runs, eager_runs_ms=eager_runs, capture_ms=captured.capture_ms,
        pool_bytes=captured.pool_bytes, peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
        disparity_range=[eager.min().item(), eager.max().item()],
    )
    del model, infer, captured
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase igev: 384x1248, {iters} iterations, float16: replay equal to eager, {launches['gwc_volume']} "
        f"group-wise volume, {launches['geo_lookup']} lookups, {launches['instance_norm']} instance norms and "
        f"{', '.join(f'{launches[k]} {k}' for k in GRU_KERNELS)} a replay, {out['device_ops_a_replay']} device "
        f"ops; graphed {out['ms_per_forward']:.2f} ms, eager {out['eager_ms_per_forward']:.2f} ms a forward "
        f"(medians of {RUNS}); capture {out['capture_ms']:.1f} ms, pool {out['pool_bytes']} bytes, peak reserved "
        f"{out['peak_reserved_gb']:.2f} GB; wall {out['wall_s']:.1f} s [{card}]")
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--only", choices=["raft", "igev"],
                   help="raft: the build, RAFT's three kernel checks and the RAFT phase alone (items 1 and 12); "
                        "igev: the build, IGEV's two kernel checks and the IGEV phase alone (items 1 and 13)")
    args = p.parse_args(argv)
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
    for src, (symbol, count) in NO_SPILL.items():
        if src not in logs:
            continue
        found = {fn: r for fn, r in ptxas_report(logs[src]).items() if symbol in fn}
        for fn, r in found.items():
            log(f"  {symbol} {fn}: {r}")
        if len(found) != count or any(r.get("spill_stores", 1) or r.get("spill_loads", 1) for r in found.values()):
            raise AssertionError(f"{symbol} in {src}: ptxas report {found}")
    # ptxas serialises the wgmmas of a kernel where a branch around them is
    # not provably warp-uniform (C7520) or where other instructions may read
    # their accumulators before a wait (C7514)
    serialised = [line for line in logs.get("fused_conv3d_pair", "").splitlines()
                  if "C7520" in line or "C7514" in line]
    if serialised:
        raise AssertionError(f"fused_conv3d_pair: {serialised}")
    log(f"phase build: {len(logs)} kernels compiled in {time.time() - t0:.1f} s")

    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.only == "raft":
        kernels = [check_corr1d_lookup(gen), check_instance_norm(gen), check_conv_gru(gen)]
    elif args.only == "igev":
        kernels = [check_geo_lookup(gen), check_gwc_volume(gen)]
    else:
        kernels = [
            check_cost_volume(gen), check_fused_pair(gen), check_regression(gen, sm_clock_hz),
            check_conv3d_bn_s1(gen), check_conv3d_bn_down(gen), check_deconv3d_bn(gen),
            check_correlation(gen), check_gband_conv_s1(gen), check_corr1d_lookup(gen), check_instance_norm(gen),
            check_conv_gru(gen), check_geo_lookup(gen), check_gwc_volume(gen),
        ]
        ranges = check_cost_volume_ranges(gen)
        for k in kernels:
            if k["name"] in ("cost_volume_concat", "cost_volume_correlation"):
                k["d_start_ranges"] = ranges[k["name"].rsplit("_", 1)[1]]
    for k in kernels:
        log(f"phase kernels: {k['name']}: max|err| {k['max_abs_err']:.3e}, {k['ms']:.4f} ms, "
            f"plain {k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms ({k['bound_by']}) [{card}]")
    if args.only == "raft":
        paths = {"raft_stereo": raft_phase(card)}
    elif args.only == "igev":
        paths = {"igev_stereo": igev_phase(card)}
    else:
        paths = other_phases(card, gen)
        paths["raft_stereo"] = raft_phase(card)
        paths["igev_stereo"] = igev_phase(card)
    for path in ("raft_stereo", "igev_stereo"):
        if path in paths:
            log(f"phase {path.split('_')[0]} [{card}]: " + json.dumps(paths[path]))
    # launches: each kernel's count on its main path (the grouped serving
    # path runs the six slice-1/2 kernels, basic_correlation the correlation
    # kernel, the train path gband_conv_s1: forwards + input gradients, and
    # the RAFT path the lookup, the instance norm and the ConvGRU: a replay's)
    main_path = {"cost_volume_correlation": "basic_correlation", "gband_conv_s1": "train_sceneflow_single",
                 "corr1d_lookup": "raft_stereo", "instance_norm": "raft_stereo", "conv_gru": "raft_stereo",
                 "geo_lookup": "igev_stereo", "gwc_volume": "igev_stereo"}
    for k in kernels:
        # a row of several kernels, each with a counter (the ConvGRU's), reads each kernel's count
        by_path = {p: {n: r["launches"][n] for n in k["kernels"]} if "kernels" in k else r["launches"][k["name"]]
                   for p, r in paths.items() if "launches" in r}
        if k["name"] == "gband_conv_s1":
            for p in by_path:
                by_path[p] += paths[p]["launches"]["gband_conv_s1_input_grad"]
            k["launches_forward"] = paths["train_sceneflow_single"]["launches"]["gband_conv_s1"]
            k["launches_input_grad"] = paths["train_sceneflow_single"]["launches"]["gband_conv_s1_input_grad"]
        k["launches"] = by_path[main_path.get(k["name"], "slice2_grouped")]
        k["launches_by_path"] = by_path
    log(f"total {time.time() - t0:.1f} s")
    log(json.dumps({"kernels": kernels, "card": card}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


def other_phases(card: str, gen) -> dict:
    """Items 2-11 of the module's docstring; returns each path's result by
    name, with its launch counts where it has them."""
    paths = {
        path: serve(path, name, overrides, per_forward, batch8,
                    COST4_CORR_REL_TOL if fields.get("cost_mode") == "correlation" else COST4_REL_TOL, **fields)
        for path, (name, overrides, per_forward, batch8, fields) in SERVE_PATHS.items()
    }
    for path, result in paths.items():
        log(f"phase serving {path} [{card}]: " + json.dumps(result))
    profiled = {}
    for path in SERVE_PATHS:
        for graphed in (False, True) if SERVE_PATHS[path][0] == "stackhourglass" else (True,):
            prof = profiled[path + ("_graphed" if graphed else "")] = profile_forward(path, graphed)
            log(f"phase profile {path}{' graphed' if graphed else ''} [{card}]: " + json.dumps(prof))
            check_profile(prof)
    graphed = graphs_phase(card, profiled)
    log("phase graphs [" + card + "]: " + json.dumps(graphed))
    trained = train(card)
    log(f"phase train {TRAIN_SLICE} [{card}]: " + json.dumps(trained))
    paths["train_sceneflow_single"] = trained
    with tempfile.TemporaryDirectory(prefix="ecm_cli_") as tmp:
        cli = cli_phase(card, Path(tmp))
        log("phase cli [" + card + "]: " + json.dumps(cli))
        par, par_global, par_start, par_ref = parallel_phase(card, gen, *cli["trees"])
        log("phase parallel [" + card + "]: " + json.dumps(par))
        disp = disp_phase(card)
        log("phase disp [" + card + "]: " + json.dumps(disp))
        dtrain = disp_train_phase(card, gen, par_global, par_start, par_ref, *cli["trees"])
        log("phase disp_train [" + card + "]: " + json.dumps(dtrain))
        overfit = overfit_phase(card, Path(tmp))
        log("phase overfit [" + card + "]: " + json.dumps(overfit))
    prof = profiling_phase(card, paths["slice2_grouped"], profiled["slice2_grouped"])
    log("phase profiling [" + card + "]: " + json.dumps(prof))
    paths.update(cli["runs"])
    paths["parallel_" + PAR_CONFIG] = par
    paths["parallel_nccl_evaluate"] = par["nccl"]["evaluate"]
    paths["disp_" + DISP_CONFIG + "_rank0"] = disp
    paths["disp_evaluate_one_process"] = disp["cli"]["one_process_cli"]
    paths["disp_train_" + PAR_CONFIG + "_rank0"] = dtrain
    paths["disp_train_evaluate"] = dtrain["cli"]["evaluate"]
    for preset in OVERFIT_PRESETS:
        paths["overfit_" + preset] = overfit[preset]
    return paths


if __name__ == "__main__":
    sys.exit(main())
