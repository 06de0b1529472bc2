"""The ``("data", "disp")`` mesh of ``ecm_tpu/parallel/sharding.py`` over
``torch.distributed``.

``ecm_tpu`` shards the batch over ``"data"`` and the cost volume's disparity
axis over ``"disp"`` and lets GSPMD insert the collectives. Here one process
runs on one card (or on the CPU), the processes of a group form a
``data`` x ``disp`` grid, and the collectives are explicit:

- :class:`Mesh` names the process group, its two axes and this rank's row
  (its disp group) and column (its data group);
- :func:`batch_sharding` is this rank's rows of a global batch (the ranks
  of one disp group share them);
- :func:`replicate` broadcasts a module's parameters and buffers from rank 0;
- under :func:`use_mesh`, BatchNorm in training takes the global batch's
  statistics and the loss and metrics the global batch's masked means
  (``ecm_torch.models.layers``, ``ecm_torch.train``), through
  :meth:`Mesh.sum`: over the data axis, or for the 3D BatchNorms of a disp
  mesh over the whole grid; ``train.steps.make_train_step`` reduces the
  gradients;
- with ``disp > 1`` each rank of a disp group holds its own range of the
  disparities at every level of the 3D stack, forward and backward
  (``ecm_torch.parallel.halo``).

Intended difference: ``ecm_tpu`` may build its mesh over a subset of its
devices; here every rank of the group is in the grid, so ``data * disp`` is
the group's size.
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

_state = threading.local()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``("data", "disp")`` mesh over a process group (None: the default
    group): ``data`` x ``disp`` ranks laid out row-major, rank = data index
    * disp + disp index (``ecm_tpu`` reshapes its devices so), this one
    ``rank``. With ``disp > 1``: ``data_group`` is this rank's column, the
    ranks that split the batch, over which :meth:`sum` reduces;
    ``disp_group`` its row, the ranks that share its batch rows and split
    the disparities, whose global ranks are ``disp_ranks`` in order. With
    ``disp`` 1 both are None: the data axis is ``group`` itself."""

    group: dist.ProcessGroup | None
    data: int
    rank: int
    disp: int = 1
    data_group: dist.ProcessGroup | None = None
    disp_group: dist.ProcessGroup | None = None
    disp_ranks: tuple[int, ...] = ()

    @property
    def data_index(self) -> int:
        return self.rank // self.disp

    @property
    def disp_index(self) -> int:
        return self.rank % self.disp

    def disp_range(self, n: int) -> tuple[int, int]:
        """``(start, length)`` of this rank's planes of a disparity extent
        ``n``: equal slabs in the order of the disp group."""
        if n % self.disp:
            raise ValueError(f"a disparity extent of {n} planes does not split into {self.disp} equal slabs")
        length = n // self.disp
        return self.disp_index * length, length

    def sum(self, t: torch.Tensor, grid: bool = False) -> torch.Tensor:
        """The sum of ``t`` over the data axis (this rank's column), on every
        rank: the ranks of a disp group hold the same batch rows, so a sum
        over them would count each row ``disp`` times. ``grid``: over the
        whole grid, for values that each rank of a disp group holds a part
        of (a 3D BatchNorm's sums over its slab of the disparities).
        Autograd-aware: the gradient of each rank's ``t`` is the sum of the
        ranks' gradients of the result, so a step through it is the step of
        one process on the concatenated batch."""
        group = self.group if grid or self.disp == 1 else self.data_group
        if not t.requires_grad:
            t = t.clone()
            dist.all_reduce(t, group=group)
            return t
        return dist_fn.all_reduce(t, group=group)

    def barrier(self) -> None:
        dist.barrier(group=self.group)


def make_mesh(data: int | None = None, disp: int = 1, group: dist.ProcessGroup | None = None) -> Mesh:
    """The ``data`` x ``disp`` mesh of ``group`` (default: the initialised
    default group). ``data=None`` is the group's size over ``disp``; a grid
    that is not the whole group raises ``ValueError``. With ``disp > 1``
    every rank creates every row's and every column's subgroup, in the same
    order (``dist.new_group`` needs all ranks, in one order, or gloo hangs)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed process group")
    world = dist.get_world_size(group)
    data = grid_shape(world, data, disp)
    rank = dist.get_rank(group)
    if disp == 1:
        return Mesh(group=group, data=world, rank=rank)
    ranks = [i if group is None else dist.get_global_rank(group, i) for i in range(world)]
    rows = [ranks[r * disp:(r + 1) * disp] for r in range(data)]
    cols = [ranks[c::disp] for c in range(disp)]
    row_groups = [dist.new_group(row) for row in rows]
    col_groups = [dist.new_group(col) for col in cols]
    return Mesh(group=group, data=data, rank=rank, disp=disp, data_group=col_groups[rank % disp],
                disp_group=row_groups[rank // disp], disp_ranks=tuple(rows[rank // disp]))


def grid_shape(world: int, data: int | None, disp: int) -> int:
    """The data axis of a ``data`` x ``disp`` grid over ``world`` ranks
    (``data=None``: ``world / disp``); raises ``ValueError`` for a grid that
    is not the whole group."""
    if disp < 1 or world % disp:
        raise ValueError(f"mesh disp={disp} with {world} ranks: the disp axis must divide the group")
    if data is None:
        data = world // disp
    if data * disp != world:
        raise ValueError(
            f"mesh data={data} x disp={disp} with {world} ranks: every rank of the group is in the grid, "
            "so data * disp is the group's size (ecm_tpu may take a subset of its devices; the port does not)"
        )
    return data


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


def reduction_mesh(grid: bool = False) -> Mesh | None:
    """The active mesh when its data axis (``grid``: its whole grid) spans
    more than one rank, else None: one rank's sums are already the global
    batch's."""
    mesh = active_mesh()
    if mesh is None:
        return None
    return mesh if (mesh.data * mesh.disp if grid else mesh.data) > 1 else None


def disp_mesh() -> Mesh | None:
    """The active mesh when it splits the disparities (``disp > 1``), else
    None."""
    mesh = active_mesh()
    return mesh if mesh is not None and mesh.disp > 1 else None


def constrain_volume(vol: torch.Tensor) -> torch.Tensor:
    """Identity. In ``ecm_tpu`` it is the GSPMD hint that shards a cost
    volume's disparity axis over ``disp``; here each rank builds only its
    own range of disparities (``cost_volume(..., d_start=...)``), so the
    volume is sharded from the start and there is nothing to constrain."""
    return vol


def constrain_features(x: torch.Tensor) -> torch.Tensor:
    """Identity. In ``ecm_tpu`` it width-shards the 2D feature maps over
    ``disp`` for speed, which changes nothing that is computed; here every
    rank of a disp group computes the whole feature extractor (an intended
    difference; width-sharded features are a later performance item)."""
    return x


def batch_sharding(mesh: Mesh, n_global: int) -> slice:
    """This rank's rows of a global batch of ``n_global`` pairs (it must
    divide by the data axis), as the input pipelines take them; the ranks
    of one disp group take the same rows."""
    if n_global % mesh.data:
        raise ValueError(f"global batch {n_global} not divisible by {mesh.data} ranks")
    n = n_global // mesh.data
    return slice(mesh.data_index * n, (mesh.data_index + 1) * n)


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
