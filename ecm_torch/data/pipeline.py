"""Input pipelines (port of ``ecm_tpu/data/pipeline.py``): grain's sharded
map dataset becomes a ``torch.utils.data.DataLoader`` over the specs.

Every pipeline yields dicts of numpy arrays: ``left``/``right``
``[B, H, W, 3]`` float32 (ImageNet-normalised) and ``disparity [B, H, W]``,
which is what ``train_loop``'s ``to_device`` takes. DataLoader workers read
files with numpy and Pillow and never touch CUDA, so they start the
platform's default way (``fork`` on Linux), from a parent that holds a CUDA
context too. ``spawn`` (and ``forkserver``, here) imports the parent's main
module again in every worker: with ``spawn`` the first batch of a 4-worker
pipeline came after 9.7 s on the H100 machine (NVIDIA H100 80GB HBM3, 700 W;
``PERF.md``).

One intended difference from the JAX package: the shuffle order is
torch's (``DistributedSampler``), not grain's. What a sample is, given its
spec and its place in the stream, is the same: the i-th sample a data rank
draws is ``load_fn(spec, crop=cfg.crop, rng=np.random.default_rng((cfg.seed,
rank, i)))``.

The rows are split by the data axis of a ``mesh``
(``ecm_torch.parallel.Mesh``), as ``parallel.batch_sharding`` splits them:
``rank`` above is the mesh's data index, so the ranks of one disp group,
which split the disparities of the same pairs, draw the same pairs and the
same crops. Without a mesh, by the default process group when one is
initialised (every rank is then on the data axis).
"""

from __future__ import annotations

import dataclasses
import itertools
from collections.abc import Iterator

import numpy as np
import torch
from torch.utils.data import BatchSampler, DataLoader, Dataset, DistributedSampler, Sampler

from ecm_torch.data.preprocess import pad_to_multiple
from ecm_torch.data.synthetic import make_batch


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    batch_size: int  # GLOBAL batch size (split across ranks)
    crop: tuple[int, int] | None = (256, 512)  # (H, W); None = eval/full
    shuffle: bool = True
    seed: int = 0
    num_epochs: int | None = None  # None = repeat forever
    num_workers: int = 0  # DataLoader worker processes (0 = in-process)


def _rank_slice(n_global: int, mesh=None) -> tuple[int, int, int]:
    """(rank batch, data index, data ranks) of this process: ``mesh``'s
    data axis; without one, its rank in the default group when
    ``torch.distributed`` is initialised, else rank 0 of 1."""
    dist = torch.distributed
    if mesh is not None:
        world, rank = mesh.data, mesh.data_index
    elif dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    if n_global % world:
        raise ValueError(f"global batch {n_global} not divisible by {world} ranks")
    return n_global // world, rank, world


def collate(samples: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
    """Stack a list of sample dicts into one batch dict (numpy)."""
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class _Samples(Dataset):
    """``dataset[(i, j)]``: spec ``j`` loaded as this rank's i-th draw."""

    def __init__(self, specs: list, load_fn, crop, seed: int, rank: int):
        self.specs, self.load_fn, self.crop, self.seed, self.rank = specs, load_fn, crop, seed, rank

    def __len__(self) -> int:
        return len(self.specs)

    def __getitem__(self, ij: tuple[int, int]) -> dict[str, np.ndarray]:
        i, j = ij
        rng = np.random.default_rng((self.seed, self.rank, i))
        return self.load_fn(self.specs[j], crop=self.crop, rng=rng)


class _Draws(Sampler):
    """This rank's spec indices over ``num_epochs`` passes (forever for
    None), ``set_epoch`` before each pass, each with its draw number."""

    def __init__(self, per_epoch: DistributedSampler, num_epochs: int | None):
        self.per_epoch, self.num_epochs = per_epoch, num_epochs

    def __iter__(self):
        epochs = itertools.count() if self.num_epochs is None else range(self.num_epochs)
        draws = itertools.count()
        for epoch in epochs:
            self.per_epoch.set_epoch(epoch)
            for j in self.per_epoch:
                yield next(draws), j


def make_train_pipeline(
    specs: list,
    load_fn,
    cfg: PipelineConfig,
    mesh=None,
) -> Iterator[dict[str, np.ndarray]]:
    """Training iterator: shuffled, split across ranks, random-cropped,
    batched with the last short batch dropped (batches run on across
    epochs, as grain's do after ``repeat``).

    Args:
      specs: SampleSpec path triples.
      load_fn: ``(spec, crop, rng) -> dict`` (``sceneflow.load_sample``,
        ``kitti.load_sample``, ...).
      cfg: pipeline config (``cfg.batch_size`` is GLOBAL).
      mesh: the rows are split over its data axis (see the module's
        docstring).
    """
    rank_bs, rank, world = _rank_slice(cfg.batch_size, mesh)
    per_epoch = DistributedSampler(
        specs, num_replicas=world, rank=rank, shuffle=cfg.shuffle, seed=cfg.seed, drop_last=True
    )
    loader = DataLoader(
        _Samples(specs, load_fn, cfg.crop, cfg.seed, rank),
        batch_sampler=BatchSampler(_Draws(per_epoch, cfg.num_epochs), rank_bs, drop_last=True),
        num_workers=cfg.num_workers,
        collate_fn=collate,
    )
    return iter(loader)


def make_eval_iterator(
    specs: list, load_fn, batch_size: int = 1, pad_multiple: int = 16
) -> Iterator[dict[str, np.ndarray]]:
    """Sequential eval iterator over full images, no shuffle, every rank
    reads everything.

    Each image is padded (top/right, zeros) to a multiple of
    ``pad_multiple``, the flagship model's stride-16 contract (SceneFlow's
    540x960 frames would otherwise break the hourglass's skip adds). The
    padded disparity is 0, which every metric masks out; ``pads`` lets a
    caller unpad a prediction.
    """
    batch: list[dict] = []
    for spec in specs:
        sample = dict(load_fn(spec, crop=None))
        if pad_multiple > 1:
            pads = (0, 0)
            for key in ("left", "right", "disparity"):
                if key in sample:
                    sample[key], pads = pad_to_multiple(sample[key], pad_multiple)
            sample["pads"] = np.asarray(pads, dtype=np.int32)
        batch.append(sample)
        if len(batch) == batch_size:
            yield collate(batch)
            batch = []
    if batch:
        yield collate(batch)


def make_synthetic_pipeline(
    cfg: PipelineConfig,
    h: int = 256,
    w: int = 512,
    max_disp: float = 40.0,
    distinct: int | None = None,
    mesh=None,
) -> Iterator[dict[str, np.ndarray]]:
    """Synthetic stream with the same interface (the overfit gate).

    ``distinct`` bounds the number of distinct batches: the stream cycles
    through that many fixed batches (``None``: a fresh batch every step).
    Batch ``s`` of data rank ``r`` (``mesh``'s data index, see the module's
    docstring) comes from the seed ``(cfg.seed, r, s).__hash__() &
    0x7FFFFFFF``; a tuple of ints hashes the same in every process, so the
    batches equal the JAX package's."""
    rank_bs, rank, _ = _rank_slice(cfg.batch_size, mesh)
    step = 0
    while True:
        s = step if distinct is None else step % distinct
        yield make_batch(
            (cfg.seed, rank, s).__hash__() & 0x7FFFFFFF, rank_bs, h, w, max_disp
        )
        step += 1
