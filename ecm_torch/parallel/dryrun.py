"""Multi-process dry run: the counterpart of
``__graft_entry__.dryrun_multichip``, on a ``(data, disp)`` grid of the
ranks (``--mesh-disp``, default 1: every rank on the data axis).

Each rank draws its own weights, takes rank 0's (``replicate``, as the JAX
dry run replicates its state) and its data row's rows of one global batch,
and runs one full train step (forward, halo exchanges with a disp axis,
loss, backward, gradient reduction, Adam, BatchNorm statistics) through
``make_train_step`` over the grid. Rank 0 first runs the same step on the
whole batch in one process and asserts that the grid's loss and
updated-parameter global norm equal it, at ``dryrun_multichip``'s
tolerances. Shapes as there: max-disp 32, 32x64, width 8, ``remat`` on, 2
pairs a data row.

    python -m ecm_torch.parallel.dryrun --nproc 2                  # 2 CPU ranks, gloo
    python -m ecm_torch.parallel.dryrun --nproc 4 --mesh-disp 2    # a (2, 2) grid
    python -m ecm_torch.parallel.dryrun --nproc 2 --device cuda:0  # 2 ranks on one card, gloo
    python -m torch.distributed.run --nproc_per_node 2 -m ecm_torch.parallel.dryrun

Without ``torch.distributed.run``'s environment the module starts the
ranks itself (``--nproc``, a free localhost port, ``--timeout`` seconds for
the whole run and for each collective), one torch thread a rank.
``--cases FILE --out DIR`` runs, on every rank, the cases of a file that
``torch.save`` wrote (a list of dicts, see :func:`run_case`) and writes
``DIR/rank<r>.pt``: the tests and ``chip_smoke.py`` hold the group's step,
and the disparity axis's primitives, conv forms and eval forward, against a
reference that way.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

MAX_DISP, H, W, FEATURES, PER_RANK = 32, 32, 64, 8, 2
ROOT = Path(__file__).resolve().parents[2]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(argv: list[str], nproc: int, timeout: float) -> list[str]:
    """Run ``python -m ecm_torch.parallel.dryrun *argv`` as ``nproc`` ranks
    of one group on this host; every rank is killed when one fails or the
    run outlasts ``timeout`` seconds. Returns each rank's standard output;
    raises with the failing rank's standard error."""
    base = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(free_port()), WORLD_SIZE=str(nproc))
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "ecm_torch.parallel.dryrun", *argv],
            env={**base, "RANK": str(r), "LOCAL_RANK": str(r)}, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for r in range(nproc)
    ]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} of {nproc} exited {p.returncode}:\n{out[-2000:]}\n{err[-4000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def dryrun_multichip(n_ranks: int, device: str = "cpu", backend: str = "gloo", timeout: float = 240.0,
                     disp: int = 1) -> dict:
    """The dry run on ``n_ranks`` ranks, a ``(n_ranks / disp, disp)`` grid,
    on ``device`` (every rank on the same one, e.g. ``cuda:0``, over gloo;
    NCCL takes one card a rank). Returns rank 0's record: the grid's and
    one process's loss and parameter norm."""
    outs = launch(["--device", device, "--backend", backend, "--timeout", str(timeout), "--mesh-disp", str(disp)],
                  n_ranks, timeout)
    line = [s for s in outs[0].splitlines() if s.startswith("dryrun ")][-1]
    return json.loads(line[len("dryrun "):])


def _to(batch: dict, device) -> dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def param_norm(model: torch.nn.Module) -> float:
    return math.sqrt(sum(p.detach().double().square().sum().item() for p in model.parameters()))


def _dryrun_rank(mesh, device) -> dict | None:
    import torch.distributed as dist

    from ecm_torch.models import build_model
    from ecm_torch.parallel.sharding import batch_sharding, replicate
    from ecm_torch.train.state import create_train_state, make_optimizer
    from ecm_torch.train.steps import make_train_step

    n = PER_RANK * mesh.data
    rng = np.random.default_rng(0)
    batch = {
        "left": rng.normal(size=(n, H, W, 3)).astype(np.float32),
        "right": rng.normal(size=(n, H, W, 3)).astype(np.float32),
        "disparity": rng.uniform(1.0, MAX_DISP - 1, size=(n, H, W)).astype(np.float32),
    }

    def one_step(batch, mesh=None):
        # every rank draws its own weights; replicate gives each rank 0's
        seed = 0 if mesh is None else mesh.rank
        model = build_model("stackhourglass", device=device, max_disp=MAX_DISP, feature_channels=FEATURES,
                            remat=True, generator=torch.Generator().manual_seed(seed))
        if mesh is not None:
            norm = torch.tensor([param_norm(replicate(model, mesh))] * 2, dtype=torch.float64, device=device)
            dist.all_reduce(norm[:1], op=dist.ReduceOp.MIN, group=mesh.group)
            dist.all_reduce(norm[1:], op=dist.ReduceOp.MAX, group=mesh.group)
            if norm[0] != norm[1]:
                raise AssertionError(f"replicate left the ranks' parameter norms in [{norm[0]}, {norm[1]}]")
        state = create_train_state(model, make_optimizer(1e-3))
        state, metrics = make_train_step(model, MAX_DISP, mesh)(state, _to(batch, device))
        return float(metrics["loss"]), param_norm(model)

    ref = one_step(batch) if mesh.rank == 0 else None
    rows = batch_sharding(mesh, n)
    loss, norm = one_step({k: v[rows] for k, v in batch.items()}, mesh)
    if ref is None:
        return None
    ref_loss, ref_norm = ref
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    # a wrong collective (a missed reduction, per-rank statistics) shifts the
    # loss and the Adam update
    grid = f"a ({mesh.data}, {mesh.disp}) grid"
    if not abs(loss - ref_loss) <= 1e-3 * max(1.0, abs(ref_loss)):
        raise AssertionError(f"loss {loss} over {grid}, {ref_loss} in one process")
    if not abs(norm - ref_norm) <= 1e-4 * max(1.0, ref_norm):
        raise AssertionError(f"parameter norm {norm} over {grid}, {ref_norm} in one process")
    return dict(ranks=mesh.data * mesh.disp, data=mesh.data, disp=mesh.disp, device=str(device), loss=loss,
                loss_one_process=ref_loss, param_norm=norm, param_norm_one_process=ref_norm)


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().clone()


def _slab(t: torch.Tensor, mesh, scale: float = 1.0) -> torch.Tensor:
    """This rank's planes of a global ``[B, D, ...]`` tensor whose planes
    are ``scale`` times the volume's (``scale`` 2 for a transposed conv's
    output)."""
    start, length = mesh.disp_range(round(t.shape[1] / scale))
    return t[:, round(start * scale):round((start + length) * scale)]


def _halo_case(case: dict, mesh, device) -> dict:
    from ecm_torch.parallel import halo

    vol = _slab(case["vol"], mesh).to(device)
    out = {f"halo{h}": _host(halo.halo_exchange_d(vol, mesh, h)) for h in (1, 2)}
    out["conv"] = _host(halo.conv3d_d_sharded(vol, case["weight"].to(device), mesh))
    out["gather"] = _host(halo.gather_d(vol, mesh))
    out.update({name: _host(halo.softargmin_d_sharded(_slab(c, mesh).to(device), mesh))
                for name, c in case["costs"].items()})
    return out


def _slab_form(case: dict, mesh, device) -> torch.Tensor:
    """One 3D conv form of the eval forward on this rank's slab of
    ``case["x"]``, through the helper of ``halo`` that the model uses for it:
    a module (``ConvBN``, ``ConvTransposeBN``, ``ClassifHead`` with
    ``case["module_args"]`` and ``case["state_dict"]``, which pick their
    helper themselves) or a kernel's wrapper (``case["kernel"]`` with the
    tensors ``case["args"]``, the keywords ``case["kwargs"]`` and an
    ``add``: a ``[B, 1, ...]`` context map, a residual of x's planes, or for
    ``deconv3d_bn`` one of the output's planes)."""
    from ecm_torch.models import aggregation, layers
    from ecm_torch.ops import cuda_fused_agg, cuda_gband, cuda_gdeconv
    from ecm_torch.parallel import halo

    x = _slab(case["x"], mesh).to(device)
    if "module" in case:
        cls = {"ConvBN": layers.ConvBN, "ConvTransposeBN": layers.ConvTransposeBN,
               "ClassifHead": aggregation.ClassifHead}[case["module"]]
        module = cls(*case["module_args"]).to(device).eval()
        module.load_state_dict(case["state_dict"])
        return module(x)
    name, kw = case["kernel"], case.get("kwargs", {})
    args = [a.to(device) for a in case["args"]]
    add = case.get("add")
    if add is not None and add.shape[1] != 1:
        add = _slab(add, mesh, 2.0 if name == "deconv3d_bn" else 1.0)
    add = None if add is None else add.to(device)
    if name == "conv3d_bn_s1":
        return halo.slab_s1(lambda v, a=None: cuda_gband.conv3d_bn_s1(v, *args, a, **kw), x, add=add)
    if name == "conv3d_bn_down":
        return halo.slab_down(lambda v: cuda_gband.conv3d_bn_down(v, *args, **kw), x)
    if name == "deconv3d_bn":
        return halo.slab_up(lambda v, a=None: cuda_gdeconv.deconv3d_bn(v, *args, a, **kw), x, add)
    if name == "fused_conv3d_pair":
        ctx = None if add is None else add[:, 0]
        return halo.slab_s1(lambda v: cuda_fused_agg.fused_conv3d_pair(v, *args, ctx, **kw), x, halo=2)
    raise ValueError(f"unknown kernel form {name!r}")


def _slab_train(case: dict, mesh, device) -> dict:
    """A module of the 3D stack in training on this rank's slab of
    ``case["x"]`` (``case["module"]`` with ``case["module_args"]``,
    ``case["state_dict"]`` and the forward's ``case.get("kwargs", {})``),
    backward from its slab of ``case["dy"]``: the output, the input's
    gradient, the parameters' gradients (this rank's share), the running
    statistics and the halo traffic (counts 0 just before)."""
    from ecm_torch.models import aggregation, layers
    from ecm_torch.parallel import halo
    from ecm_torch.parallel.sharding import use_mesh

    cls = {"ConvBN": layers.ConvBN, "ConvTransposeBN": layers.ConvTransposeBN,
           "ClassifHead": aggregation.ClassifHead}[case["module"]]
    module = cls(*case["module_args"]).to(device, case["x"].dtype)
    module.load_state_dict(case["state_dict"])
    module.train()
    x = _slab(case["x"], mesh).to(device).requires_grad_(True)
    halo.reset_traffic()
    with use_mesh(mesh):
        y = module(x, **case.get("kwargs", {}))
        y.backward(_slab(case["dy"], mesh, y.shape[1] / x.shape[1]).to(device))
    return dict(out=_host(y), dx=_host(x.grad), traffic=halo.read_traffic(),
                grads={n: _host(p.grad) for n, p in module.named_parameters()},
                state={k: _host(v) for k, v in module.state_dict().items()})


def _gather_grad(case: dict, mesh, device) -> dict:
    """``gather_d`` of this rank's slab of ``case["x"]``, backward from the
    whole ``case["dy"]``: the gathered tensor and the slab's gradient."""
    from ecm_torch.parallel import halo

    x = _slab(case["x"], mesh).to(device).requires_grad_(True)
    y = halo.gather_d(x, mesh)
    y.backward(case["dy"].to(device))
    return dict(out=_host(y), dx=_host(x.grad))


def _rows(case: dict, mesh) -> dict:
    """The first ``case["batches"]`` batches of this rank's train pipeline
    over ``mesh`` (``make_train_pipeline`` on the SceneFlow tree
    ``case["tree"]``, and ``make_synthetic_pipeline``), with
    ``case["pipeline"]``'s PipelineConfig fields."""
    from ecm_torch.data.pipeline import PipelineConfig, make_synthetic_pipeline, make_train_pipeline
    from ecm_torch.data.sceneflow import list_sceneflow, load_sample

    cfg = PipelineConfig(**case["pipeline"])
    specs, _ = list_sceneflow(case["tree"])
    out = {}
    for name, it in (("sceneflow", make_train_pipeline(specs, load_sample, cfg, mesh)),
                     ("synthetic", make_synthetic_pipeline(cfg, h=16, w=32, max_disp=8.0, mesh=mesh))):
        out[name] = [{k: torch.from_numpy(v) for k, v in next(it).items()} for _ in range(case["batches"])]
    return out


def disp_eval(case: dict, mesh, device) -> dict:
    """``CONFIGS[case["config"]].model`` (named ``case["model"]`` where
    given) built with ``case["overrides"]`` (``case["double"]``: in f64) and
    ``case["state_dict"]``, in eval on this rank's rows of ``case["batch"]``
    under ``mesh``: the disparity of one forward, the kernels' launches and
    the halo traffic during it (counts 0 just before), the gathered cost
    map, ``case.get("timed", 0)`` more forwards' ms and the peak memory.
    ``mesh`` None: one process on the whole batch (the reference). TF32 is
    off, as ``chip_smoke.py`` sets it for its reference."""
    from ecm_torch.configs import CONFIGS
    from ecm_torch.ops.launches import read_counts, reset_counts
    from ecm_torch.parallel import halo
    from ecm_torch.parallel.sharding import batch_sharding, use_mesh

    cfg = CONFIGS[case["config"]].model
    if "model" in case:
        cfg = dataclasses.replace(cfg, name=case["model"])
    model = cfg.build(device=device, **case.get("overrides", {}))
    if case.get("double"):
        model.double()
    model.load_state_dict(case["state_dict"])
    rows = slice(None) if mesh is None else batch_sharding(mesh, case["batch"]["left"].shape[0])
    left, right = (case["batch"][k][rows].to(device) for k in ("left", "right"))
    cuda = device.type == "cuda"
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    def forward():
        with torch.inference_mode(), use_mesh(mesh):
            return model(left, right)[-1]

    forward()  # warm-up: kernel builds, weight packs
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    halo.reset_traffic()
    disp = forward()
    if cuda:
        torch.cuda.synchronize(device)
    launches, traffic = read_counts(), halo.read_traffic()
    peak = torch.cuda.max_memory_allocated(device) / 1e9 if cuda else None
    with torch.inference_mode(), use_mesh(mesh):
        (cost,) = model.cost_maps(left, right)
    times = []
    for _ in range(case.get("timed", 0)):
        t0 = time.perf_counter()
        forward()
        if cuda:
            torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return dict(disp=_host(disp), cost=_host(cost), launches=launches, traffic=traffic, peak_mem_gb=peak,
                ms=times, ms_median=statistics.median(times) if times else None)


def _gloo_cuda(mesh, device) -> dict:
    import torch.distributed as dist

    def attempt(fn, want) -> str:
        try:
            got = fn()
        except RuntimeError as e:
            return "raises: " + (str(e).splitlines() or [""])[0]
        return "ok" if all(torch.equal(g, w) for g, w in zip(got, want)) else "wrong values"

    t = torch.full((4, 3), float(mesh.rank), device=device)

    def gather():
        parts = [torch.empty_like(t) for _ in range(mesh.data)]
        dist.all_gather(parts, t, group=mesh.group)
        return parts

    def p2p():
        buf = torch.empty_like(t)
        ops = [dist.P2POp(dist.isend, t, mesh.rank ^ 1), dist.P2POp(dist.irecv, buf, mesh.rank ^ 1)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [buf]

    return dict(all_gather=attempt(gather, [torch.full_like(t, float(r)) for r in range(mesh.data)]),
                p2p=attempt(p2p, [torch.full_like(t, float(mesh.rank ^ 1))]))


def run_case(case: dict, mesh, device) -> dict:
    """One case on this rank. ``case["kind"]``:

    - ``"step"``: ``CONFIGS[case["config"]].model.build(**case["overrides"])``
      (``case["double"]``: in f64) with ``case["state_dict"]``, one
      ``make_train_step`` over the mesh on this rank's rows of
      ``case["batch"]`` (global tensors) at learning rate ``case["lr"]``;
      then ``case.get("timed_steps", 0)`` more steps, timed. Returns the
      logged loss and metrics, this rank's predictions, the gradients of
      ``case.get("grads")`` (every parameter for None; TF32 off, as
      ``chip_smoke.py`` steps its references), the state after the
      step, the kernels' launch counts, the halo traffic and the copies
      ``gband_conv_s1`` made of a strided input during it, the timed steps'
      ms and the peak device memory.
    - ``"bn"``: ``BatchNorm{case["ndim"]}d`` with ``case["state_dict"]`` in
      training on this rank's rows of ``case["x"]``, backward from its rows
      of ``case["dy"]``. Returns y, dx, the weight and bias gradients (this
      rank's share) and the running statistics.
    - ``"dryrun"``: the dry run; rank 0's record (None on the others).
    - ``"halo"`` (under a ``case["mesh"]`` of ``(data, disp)``, as the next
      two): ``halo_exchange_d`` (halos 1 and 2), ``conv3d_d_sharded`` with
      ``case["weight"]`` and ``gather_d`` on this rank's slab of
      ``case["vol"]``, ``softargmin_d_sharded`` on its slab of each of
      ``case["costs"]``.
    - ``"slab"``: one conv form on this rank's slab (:func:`_slab_form`);
      returns ``{"out": ...}``.
    - ``"slab_train"``: a 3D module in training on this rank's slab,
      forward and backward (:func:`_slab_train`).
    - ``"gather_grad"``: ``gather_d`` and its backward (:func:`_gather_grad`).
    - ``"rows"``: this rank's first batches of the train pipelines
      (:func:`_rows`).
    - ``"disp_eval"``: the eval forward (:func:`disp_eval`).
    - ``"gloo_cuda"``: whether the group's backend all-gathers CUDA tensors
      and sends them point to point (``batch_isend_irecv`` with the rank
      ``rank ^ 1``): "ok", "wrong values" or the first line of the error.
    - ``"grid"``: ``make_mesh(*case["shape"])``: the mesh's axes, this
      rank's place in them, its range of 16 planes and the sum of the ranks'
      numbers over its data axis; or the ``ValueError``'s message.
    - ``"loop"``: ``train_loop`` over the mesh on ``make_synthetic_pipeline``
      batches (``case["pipeline"]``: PipelineConfig fields, ``h``, ``w``,
      ``max_disp``), to step ``case["steps"][0]`` with a checkpoint every
      ``case["ckpt_every"]`` steps in ``case["ckpt_dir"]`` and the JSONL at
      ``case["metrics_path"]``, then on to ``case["steps"][1]``. Returns the
      state after the last step.
    """
    from ecm_torch.configs import CONFIGS
    from ecm_torch.models.layers import BatchNorm2d, BatchNorm3d
    from ecm_torch.ops.cuda_gband import gband_conv_s1
    from ecm_torch.ops.launches import read_counts, reset_counts
    from ecm_torch.parallel import halo
    from ecm_torch.parallel.sharding import batch_sharding, use_mesh
    from ecm_torch.train import checkpoint as ckpt_lib
    from ecm_torch.train.loop import train_loop
    from ecm_torch.train.state import create_train_state, make_optimizer
    from ecm_torch.train.steps import make_train_step

    if case["kind"] == "dryrun":
        return _dryrun_rank(mesh, device)
    if case["kind"] == "halo":
        return _halo_case(case, mesh, device)
    if case["kind"] == "slab":
        from ecm_torch.parallel.sharding import use_mesh

        with torch.no_grad(), use_mesh(mesh):
            return {"out": _host(_slab_form(case, mesh, device))}
    if case["kind"] == "disp_eval":
        return disp_eval(case, mesh, device)
    if case["kind"] == "slab_train":
        return _slab_train(case, mesh, device)
    if case["kind"] == "gather_grad":
        return _gather_grad(case, mesh, device)
    if case["kind"] == "rows":
        return _rows(case, mesh)
    if case["kind"] == "gloo_cuda":
        return _gloo_cuda(mesh, device)
    if case["kind"] == "grid":
        from ecm_torch.parallel.sharding import make_mesh

        try:
            grid = make_mesh(*case["shape"])
        except ValueError as e:
            return dict(error=str(e))
        total = grid.sum(torch.tensor([float(grid.rank)], device=device)).item()
        return dict(data=grid.data, disp=grid.disp, data_index=grid.data_index, disp_index=grid.disp_index,
                    disp_ranks=list(grid.disp_ranks), disp_range=grid.disp_range(16), data_sum=total)
    if case["kind"] == "bn":
        bn = (BatchNorm2d if case["ndim"] == 2 else BatchNorm3d)(case["x"].shape[1])
        bn.to(device, case["x"].dtype).load_state_dict(case["state_dict"])
        bn.train()
        rows = batch_sharding(mesh, case["x"].shape[0])
        x = case["x"][rows].to(device).clone().requires_grad_(True)
        with use_mesh(mesh):
            y = bn(x)
            y.backward(case["dy"][rows].to(device))
        return dict(y=_host(y), dx=_host(x.grad), weight_grad=_host(bn.weight.grad),
                    bias_grad=_host(bn.bias.grad), state={k: _host(v) for k, v in bn.state_dict().items()})

    model = CONFIGS[case["config"]].model.build(device=device, **case.get("overrides", {}))
    if case.get("double"):
        model.double()
    if "state_dict" in case:
        model.load_state_dict(case["state_dict"])
    state = create_train_state(model, make_optimizer(case.get("lr", 1e-3)))
    # as chip_smoke.py computes its one-process references (an f32 step)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    step = make_train_step(model, model.max_disp, mesh)
    if case["kind"] == "loop":
        from ecm_torch.data.pipeline import PipelineConfig, make_synthetic_pipeline

        pipe = dict(case["pipeline"])
        h, w, max_disp = pipe.pop("h"), pipe.pop("w"), pipe.pop("max_disp")
        data = make_synthetic_pipeline(PipelineConfig(**pipe), h=h, w=w, max_disp=max_disp, mesh=mesh)
        manager = ckpt_lib.make_manager(case["ckpt_dir"])
        for num_steps in case["steps"]:
            state = train_loop(state, step, data, num_steps, mesh=mesh, log_every=1, ckpt_manager=manager,
                               ckpt_every=case["ckpt_every"], metrics_path=case["metrics_path"])
        return dict(step=state.step, state={k: _host(v) for k, v in model.state_dict().items()})

    rows = batch_sharding(mesh, case["batch"]["left"].shape[0])
    batch = {k: v[rows].to(device) for k, v in case["batch"].items()}
    preds = []
    hook = model.register_forward_hook(lambda m, i, o: preds.extend(p.detach() for p in o))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    halo.reset_traffic()
    copies = gband_conv_s1.copies
    state, metrics = step(state, batch)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    launches, traffic = read_counts(), halo.read_traffic()
    copies = gband_conv_s1.copies - copies
    hook.remove()
    names = case.get("grads") or [n for n, _ in model.named_parameters()]
    params = dict(model.named_parameters())
    out = dict(
        metrics={k: float(v) for k, v in metrics.items()}, preds=[_host(p) for p in preds],
        grads={n: _host(params[n].grad) for n in names},
        state={k: _host(v) for k, v in model.state_dict().items()}, launches=launches, traffic=traffic,
        gband_copies=copies,
    )
    times = []
    for _ in range(case.get("timed_steps", 0)):
        t0 = time.perf_counter()
        step(state, batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    out.update(step_ms=times, step_ms_median=statistics.median(times) if times else None,
               peak_mem_gb=torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda" else None)
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="data-parallel dry run over torch.distributed")
    p.add_argument("--nproc", type=int, default=2, help="ranks to start when not under torch.distributed.run")
    p.add_argument("--device", default="cpu", help="cpu, cuda (cuda:LOCAL_RANK) or cuda:K (every rank)")
    p.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    p.add_argument("--timeout", type=float, default=240.0, help="seconds for the run and for each collective")
    p.add_argument("--mesh-disp", type=int, default=1, help="the disp axis of the ranks' (data, disp) grid")
    p.add_argument("--cases", default=None, help="a torch.save file of cases (see run_case)")
    p.add_argument("--out", default=None, help="with --cases: a directory for rank<r>.pt")
    args = p.parse_args(argv)
    if "RANK" not in os.environ:
        forwarded = argv if argv is not None else sys.argv[1:]
        outs = launch(forwarded, args.nproc, args.timeout)
        sys.stdout.write(outs[0])
        return 0

    import torch.distributed as dist

    from ecm_torch.parallel.sharding import init_from_env, make_mesh

    torch.set_num_threads(1)  # ranks share the host's cores
    device = torch.device(init_from_env(args.device, args.backend, args.timeout))
    try:
        mesh = make_mesh(disp=args.mesh_disp)
        if args.cases:
            cases = torch.load(args.cases, weights_only=True)
            # every rank makes each case's mesh (and its subgroups) in the
            # same order: the cases' order
            meshes = {(mesh.data, mesh.disp): mesh}
            results = {}
            for c in cases:
                shape = tuple(c.get("mesh", (mesh.data, mesh.disp)))
                if shape not in meshes:
                    meshes[shape] = make_mesh(*shape)
                results[c["name"]] = run_case(c, meshes[shape], device)
            os.makedirs(args.out, exist_ok=True)
            torch.save(results, os.path.join(args.out, f"rank{mesh.rank}.pt"))
        else:
            record = _dryrun_rank(mesh, device)
            if record is not None:
                print("dryrun " + json.dumps(record), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
