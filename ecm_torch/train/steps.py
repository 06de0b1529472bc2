"""Train, eval and inference steps (port of ``ecm_tpu/train/steps.py``).

On the card the train step, the eval step and the inference function are
each captured once per input signature into a CUDA graph and replayed
(``train/graphs.py``), the counterpart of their ``jax.jit`` (the train
step's with the state donated: its graph updates the parameters, the
BatchNorm statistics and Adam's state in place). The train step's host
bookkeeping (the schedule's learning rate written to the card, the step
and schedule counts) runs around the graph, once a call, and the whole call
is an ``ecm.train.step`` span (``utils/profiling.span``). The train step
stays eager, each by an explicit branch: on CPU tensors, in anomaly mode
(``GraphedTrainStep``), and under any mesh (below). Each puts the model in
the mode it needs (``train()``: batch-statistics BatchNorm, every head;
``eval()``: running statistics, the last head). The model's own dtype casts
(bf16 activations, f32 parameters and statistics) are the mixed precision;
there is no autocast.

Data parallelism (``ecm_tpu`` shards the batch and lets GSPMD reduce): with
a ``mesh`` the train step wraps the model in ``DistributedDataParallel``
over the mesh's group and runs under ``use_mesh``, so that each rank's
BatchNorm, loss and metrics see the global batch and DDP's mean of the
ranks' gradients is the global batch's gradient; the optimizer, clipping
included, then runs on identical gradients on every rank. DDP broadcasts
rank 0's parameters and buffers when it wraps the model and no buffers
after that (``broadcast_buffers=False``): the synced statistics keep the
running buffers equal.

On a mesh with a disparity axis (``disp > 1``) each rank's gradient of
every parameter is its slab's share of its data row's: the 3D layers see
only its slab, and the feature and context nets reach the loss only through
its slab of the volume and its context maps. So the gradients are summed
over disp and averaged over data: no DDP (its mean over the group would
divide by data x disp); rank 0's parameters and buffers are broadcast once
(``replicate``), and after the backward one all-reduce of the flattened
gradients over the grid, divided by ``data``. One reduce after the backward
also keeps the halo exchanges of the backward, which run point to point on
the disp groups, from interleaving with bucketed all-reduces on the whole
group (which could deadlock under gloo). A step under a mesh is never
captured: DDP's reducer, the grid's halo exchanges and ``sum_over_grid``
run collectives through gloo's host buffers or NCCL's, which the graph
would have to hold.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from ecm_torch.parallel.sharding import Mesh, reduction_mesh, replicate, use_mesh
from ecm_torch.train.graphs import GraphedForward, GraphedTrainStep
from ecm_torch.train.loss import stereo_loss
from ecm_torch.train.metrics import disparity_metrics
from ecm_torch.train.state import TrainState
from ecm_torch.utils.profiling import span


def data_parallel(model: nn.Module, mesh: Mesh) -> DistributedDataParallel:
    """``model`` in ``DistributedDataParallel`` over ``mesh``'s group. Every
    parameter of the port's models gets a gradient in a train step, so DDP
    does not search for unused ones."""
    device = next(model.parameters()).device
    return DistributedDataParallel(
        model,
        device_ids=[device] if device.type == "cuda" else None,
        broadcast_buffers=False,
        process_group=mesh.group,
    )


@torch.no_grad()
def sum_over_grid(model: nn.Module, mesh: Mesh) -> None:
    """Each parameter's gradient summed over ``mesh``'s grid and divided by
    its data axis, in one all-reduce of the gradients flattened."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    flat /= mesh.data
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def make_train_step(model: nn.Module, max_disp: int, mesh: Mesh | None = None, graphed: bool = True):
    """``(state, batch) -> (state, metrics)``: one optimizer step on
    ``batch`` (tensors on the model's device: left/right ``[B, H, W, 3]``,
    disparity ``[B, H, W]``; with ``mesh``, this rank's rows of the global
    batch). Metrics stay on the device; with ``mesh`` they are the global
    batch's on every rank. Without a mesh the step's device work is a
    ``GraphedTrainStep`` (``.graphed``): one CUDA graph per batch signature
    on the card. ``graphed=False``: every step eager (what a mesh runs; the
    reference the graph is held to)."""
    over_disp = mesh is not None and mesh.disp > 1
    if over_disp:
        forward = replicate(model, mesh)
    else:
        forward = model if mesh is None else data_parallel(model, mesh)

    def train_step(state: TrainState, left: torch.Tensor, right: torch.Tensor, gt: torch.Tensor):
        """The step's device work: all a captured graph holds."""
        with use_mesh(mesh):
            model.train()
            preds = forward(left, right)
            loss = stereo_loss(preds, gt, max_disp)
            state.optimizer.zero_grad()
            loss.backward()
            if over_disp:
                sum_over_grid(model, mesh)
            state.optimizer.update()
            loss = loss.detach()
            if (reducing := reduction_mesh()) is not None:
                loss = reducing.sum(loss) / reducing.data
            metrics = {"loss": loss}
            metrics.update(disparity_metrics(preds[-1].detach(), gt, max_disp))
        return metrics

    # under a mesh: eager, as the module's docstring says
    run = GraphedTrainStep(train_step, model) if graphed and mesh is None else train_step

    def step(state: TrainState, batch: dict[str, torch.Tensor]):
        with span("ecm.train.step"):
            state.optimizer.set_lr()
            metrics = run(state, batch["left"], batch["right"], batch["disparity"])
            state.optimizer.count += 1
            state.step += 1
        return state, metrics

    step.graphed = run if isinstance(run, GraphedTrainStep) else None
    return step


def make_eval_step(model: nn.Module, max_disp: int):
    """``(state, batch) -> (disp [B, H, W], metrics)`` in eval mode. On CUDA
    tensors the forward and the metrics are one CUDA graph per input
    signature (``train/graphs.py``), as ``ecm_tpu``'s step is one ``jit``."""

    @torch.inference_mode()
    def eval_forward(left: torch.Tensor, right: torch.Tensor, gt: torch.Tensor):
        model.eval()
        disp = model(left, right)[-1]
        return disp, disparity_metrics(disp, gt, max_disp)

    graphed = GraphedForward(eval_forward, model)

    def eval_step(state: TrainState, batch: dict[str, torch.Tensor]):
        return graphed(batch["left"], batch["right"], batch["disparity"])

    eval_step.graphed = graphed
    return eval_step


def make_infer_fn(model: nn.Module):
    """``(left, right) -> disp [B, H, W]`` in eval mode, for serving. On CUDA
    tensors one CUDA graph per input signature (``train/graphs.py``), as
    ``ecm_tpu``'s is one ``jit``."""

    @torch.inference_mode()
    def infer(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
        model.eval()
        return model(left, right)[-1]

    return GraphedForward(infer, model)
