"""The data axis of ``ecm_tpu/parallel/sharding.py`` over ``torch.distributed``.

``ecm_tpu`` shards the batch over a ``("data", "disp")`` mesh and lets GSPMD
insert the collectives: the gradient ``psum`` and BatchNorm's global-batch
statistics. Here one process trains on one card (or on the CPU), every
process of a group is a row of the ``"data"`` axis, and the collectives are
explicit:

- :class:`Mesh` names the process group, its ``data`` size and ``disp``;
- :func:`batch_sharding` is this rank's rows of a global batch;
- :func:`replicate` broadcasts a module's parameters and buffers from rank 0;
- under :func:`use_mesh`, BatchNorm in training takes the global batch's
  statistics and the loss and metrics the global batch's masked means
  (``ecm_torch.models.layers``, ``ecm_torch.train``), through
  :meth:`Mesh.sum`; ``train.steps.make_train_step`` reduces the gradients.

Intended difference: ``ecm_tpu`` may build its mesh over a subset of its
devices; here every rank of the group trains, so ``data`` is the group's
size. The disparity axis (``disp > 1``) is slice 10 of the port and raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import threading

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn
from torch import nn

from ecm_torch.data.pipeline import _rank_slice

DISP_NOT_PORTED = (
    "disparity-axis sharding (mesh disp > 1) is not ported yet: it is slice 10 of the port "
    "(ROADMAP queue 1, parallel: the halo exchange around each 3D conv)"
)

_state = threading.local()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``("data", "disp")`` mesh over a process group (None: the default
    group): ``data`` ranks, this one ``rank``; ``disp`` is 1."""

    group: dist.ProcessGroup | None
    data: int
    rank: int
    disp: int = 1

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the group, on every rank. Autograd-aware:
        the gradient of each rank's ``t`` is the sum of the ranks' gradients
        of the result, so a step through it is the step of one process on
        the concatenated batch."""
        if not t.requires_grad:
            t = t.clone()
            dist.all_reduce(t, group=self.group)
            return t
        return dist_fn.all_reduce(t, group=self.group)

    def barrier(self) -> None:
        dist.barrier(group=self.group)


def make_mesh(data: int | None = None, disp: int = 1, group: dist.ProcessGroup | None = None) -> Mesh:
    """The mesh of ``group`` (default: the initialised default group).
    ``data=None`` is the group's size; another size raises, as does
    ``disp > 1`` (slice 10)."""
    if disp > 1:
        raise NotImplementedError(DISP_NOT_PORTED)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed process group")
    world = dist.get_world_size(group)
    if data is not None and data != world:
        raise ValueError(
            f"mesh data={data} with {world} ranks: every rank of the group trains, so the data "
            "axis is the group's size (ecm_tpu may take a subset of its devices; the port does not)"
        )
    return Mesh(group=group, data=world, rank=dist.get_rank(group))


@contextlib.contextmanager
def use_mesh(mesh: Mesh | None):
    """Activate ``mesh`` for the synced statistics and reductions
    (thread-local)."""
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def active_mesh() -> Mesh | None:
    return getattr(_state, "mesh", None)


def reduction_mesh() -> Mesh | None:
    """The active mesh when it spans more than one rank, else None: one
    rank's sums are already the global batch's."""
    mesh = active_mesh()
    return mesh if mesh is not None and mesh.data > 1 else None


def constrain_volume(vol: torch.Tensor) -> torch.Tensor:
    """Identity. In ``ecm_tpu`` it shards a cost volume's disparity axis
    over ``disp``; each rank already holds its own batch rows, and the
    disparity axis stays whole until slice 10 shards it."""
    return vol


def constrain_features(x: torch.Tensor) -> torch.Tensor:
    """Identity, as :func:`constrain_volume` (``ecm_tpu`` shards the feature
    maps' width over ``disp``); slice 10 gives it work."""
    return x


def batch_sharding(mesh: Mesh, n_global: int) -> slice:
    """This rank's rows of a global batch of ``n_global`` pairs (it must
    divide by the ranks), as the input pipelines take them."""
    n, rank, _ = _rank_slice(n_global, mesh.group)
    return slice(rank * n, (rank + 1) * n)


@torch.no_grad()
def replicate(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Broadcast ``module``'s parameters and buffers from the group's rank 0
    (the model is about 5M parameters, so every rank holds all of them)."""
    src = dist.get_global_rank(mesh.group, 0) if mesh.group is not None else 0
    for t in module.state_dict().values():
        dist.broadcast(t, src=src, group=mesh.group)
    return module


def init_from_env(device: str | None, backend: str | None = None, timeout_s: float = 600.0) -> str:
    """Join the process group that ``torch.distributed.run`` describes in
    its environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``), with collectives that fail after
    ``timeout_s``. Returns the device of this rank: ``device`` when it names
    one (``cpu``, or ``cuda:0`` for ranks that share a card), else
    ``cuda:LOCAL_RANK``. ``backend``: NCCL on CUDA, gloo on the CPU unless
    given. NCCL takes one rank a card; ranks that share one use gloo, which
    also reduces CUDA tensors."""
    if device in (None, "cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: ecm_torch runs on the GPU; pass --device cpu to run on the CPU")
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, timeout=datetime.timedelta(seconds=timeout_s))
    if dist.get_rank() == 0:
        print(f"multihost: {dist.get_world_size()} ranks, backend {backend}, rank 0 on {device}", flush=True)
    return device


def is_main_process() -> bool:
    """Rank 0 of the default group, or a process with no group: the one that
    prints and writes files."""
    return not dist.is_initialized() or dist.get_rank() == 0
