"""Serving as one captured program per input signature: the port's
counterpart of the ``jax.jit`` around ``make_eval_step`` and
``make_infer_fn`` in ``ecm_tpu/train/steps.py``.

``jax.jit`` traces a function once per input signature into one compiled
program, dispatched once a call, with its constants folded in. PyTorch runs
eagerly: a grouped ``kitti_infer`` forward is about 1100 device operations,
each dispatched from Python, and at batch 1 the card waits on the host.
:class:`GraphedForward` captures the forward once per signature into a
``torch.cuda.CUDAGraph`` and replays it:

- **Signature** (:func:`signature`): the inputs' shapes, dtypes and device,
  the model's resolved aggregation layout, the active mesh, the TF32 flags,
  and the stamp, ``(data_ptr, _version)``, of every parameter and buffer.
  The packed weights and folded BatchNorms are made in Python caches
  (``cuda_gband.cached_pack``, ``layers.fold_bn``,
  ``cuda_fused_agg.pair_operands``) that run only at capture, so a graph
  captured before an in-place update (an optimizer step, BatchNorm's running
  statistics, ``load_state_dict``) would replay stale packs and folds.
  When the stamp moves, every graph captured under the old one is dropped
  before anything can replay it.
- **What a graph reads stays alive**: a graph reads by address the packs
  and folds those caches handed out during its capture, and a cache may
  replace its entry later without a stamp moving (an eager forward in
  another grad mode folds and packs again). Everything the caches hand out
  during a capture (``cuda_gband.holding``), and every parameter and
  buffer, is held by the graph, so no address a graph reads is freed or
  reused while it lives.
- **Capture on the second sighting**: the first call of a signature runs
  eagerly. A capture costs a warm-up, a sync and a pool of its own, which a
  shape served once (Middlebury's scenes, each its own size; ``test_img``)
  never earns back; ``jax.jit`` compiles on the first call instead.
  The second call warms up with one eager call on a side stream (nvcc
  builds, cuDNN's and cuBLAS's workspaces, the plan and pack caches and the
  resize matrices of ``ops/upsample.py``, none of which a capture may do),
  whose outputs are that call's result, and captures; later calls replay.
- **Static buffers**: each call copies its inputs into the buffers the graph
  reads and returns clones of the graph's outputs, which the next replay
  overwrites (JAX returns a fresh array each call). A graph is only ever
  replayed on its own buffers, whose addresses its private pool keeps fixed;
  the fused pair's TMA tensor map, built on the host at capture with x's
  address (``csrc/fused_conv3d_pair.cu``), is frozen into the graph and is
  right for that reason alone.
- **Memory**: each signature captures into a pool of its own; at most
  ``MAX_GRAPHS`` signatures are kept, the least recently used dropped first.
  The eval CLIs serve batch 1 padded to a multiple of 32, so KITTI's image
  sizes and SceneFlow's each repeat one signature and Middlebury's none;
  two leave room for one more, as a validation split's short last batch.
- **Launch counts**: what the kernel wrappers count during a capture
  (``ops/launches.py``) is the graph's launches per replay. A replay runs no
  Python, so no wrapper counts it; each replay adds those launches to
  ``launches.read_replayed()``.
- A failed capture raises, naming the function and its signature. Nothing
  falls back to the eager forward.

The forward stays eager, by explicit branches in ``__call__``, on CPU
tensors (the device the caller chose, as the tests do) and under a mesh of
more than one rank: there the halo exchanges and gathers
(``parallel/halo.py``) and the metrics' sums run collectives through gloo's
pinned host buffers, which a graph cannot hold.
"""

from __future__ import annotations

import collections
import dataclasses
import time
import warnings

import torch
from torch import nn

from ecm_torch.ops import launches
from ecm_torch.ops.cuda_gband import holding
from ecm_torch.parallel.sharding import Mesh, active_mesh

MAX_GRAPHS = 2
MAX_SEEN = 64  # signatures served once and not captured, remembered


def signature(model: nn.Module, args: tuple[torch.Tensor, ...], mesh: Mesh | None) -> tuple:
    """The key of a captured graph: what the capture read besides the
    inputs' values (see the module's docstring)."""
    device = args[0].device
    layout = model.resolve_layout(device) if hasattr(model, "resolve_layout") else None
    return (
        tuple((tuple(a.shape), a.dtype, a.device) for a in args),
        layout,
        None if mesh is None else (mesh.data, mesh.disp),
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32),
        weights_stamp(model),
    )


def weights_stamp(model: nn.Module) -> tuple:
    """The stamp of every parameter and buffer of ``model``, as
    ``cuda_gband._stamp`` takes it, read from the modules' own dicts
    (:func:`_weights`): this runs on every call, and ``model.parameters()``
    and ``buffers()``, which build every name on the way, take three times
    as long."""
    return tuple((t.data_ptr(), None if t.is_inference() else t._version) for t in _weights(model))


def _weights(model: nn.Module) -> list[torch.Tensor]:
    out, stack = [], [model]
    while stack:
        mod = stack.pop()
        for tensors in (mod._parameters, mod._buffers):
            out.extend(t for t in tensors.values() if t is not None)
        stack.extend(mod._modules.values())
    return out


def _map(f, tree):
    """``f`` on each tensor of a tensor, a tuple or list, or a dict of them."""
    if isinstance(tree, torch.Tensor):
        return f(tree)
    if isinstance(tree, dict):
        return {k: _map(f, v) for k, v in tree.items()}
    return type(tree)(_map(f, v) for v in tree)


def _leaves(tree) -> list[torch.Tensor]:
    out = []
    _map(out.append, tree)
    return out


@dataclasses.dataclass
class Captured:
    """One signature's graph: the buffers it reads and writes, and what its
    capture counted."""

    graph: torch.cuda.CUDAGraph
    inputs: tuple[torch.Tensor, ...]
    outputs: object
    launches: dict[str, int]  # kernel launches per replay
    capture_ms: float  # warm-up excluded
    pool_bytes: int  # device memory the capture reserved
    held: list  # the weights and cached packs and folds that the graph reads
    replays: int = 0


class GraphedForward:
    """``fn(*args)`` (tensors in; a tensor, tuple or dict of tensors out)
    captured the second time a :func:`signature` of ``model`` and the inputs
    is seen, and replayed; eager on CPU tensors and under a mesh of more
    than one rank."""

    def __init__(self, fn, model: nn.Module):
        self.fn = fn
        self.model = model
        self.graphs: collections.OrderedDict[tuple, Captured] = collections.OrderedDict()
        self.seen: collections.OrderedDict[tuple, None] = collections.OrderedDict()

    def __call__(self, *args: torch.Tensor):
        if args[0].device.type != "cuda":
            return self.fn(*args)  # the caller chose the CPU: eager, no graph
        mesh = active_mesh()
        if mesh is not None and mesh.data * mesh.disp > 1:
            # collectives through gloo's host buffers: no graph can hold them
            return self.fn(*args)
        key = signature(self.model, args, mesh)
        captured = self.graphs.get(key)
        if captured is None:
            return self._miss(key, args)
        self.graphs.move_to_end(key)
        for buf, a in zip(captured.inputs, args):
            buf.copy_(a)
        captured.graph.replay()
        captured.replays += 1
        launches.add_replayed(captured.launches)
        return _map(torch.clone, captured.outputs)

    def _miss(self, key: tuple, args: tuple[torch.Tensor, ...]):
        """A signature with no graph: forget those of other weights, then
        run eagerly the first time ``key`` is seen and capture the second."""
        for old in [k for k in (*self.graphs, *self.seen) if k[-1] != key[-1]]:
            self.graphs.pop(old, None)
            self.seen.pop(old, None)
        if key in self.seen:
            del self.seen[key]
            return self._capture(key, args)
        self.seen[key] = None
        while len(self.seen) > MAX_SEEN:
            self.seen.popitem(last=False)
        return self.fn(*args)

    def _capture(self, key: tuple, args: tuple[torch.Tensor, ...]):
        """Warm up and capture ``key``; returns the warm-up's outputs."""
        while len(self.graphs) >= MAX_GRAPHS:
            self.graphs.popitem(last=False)
        current = torch.cuda.current_stream(args[0].device)
        side = torch.cuda.Stream(args[0].device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self.fn(*args)
        current.wait_stream(side)
        for t in _leaves(out):
            t.record_stream(current)
        inputs = tuple(a.clone() for a in args)
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(args[0].device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(args[0].device)
        before = launches.read_counts()
        t0 = time.perf_counter()
        try:
            with holding() as held, torch.cuda.graph(graph, stream=side):
                outputs = self.fn(*inputs)
        except RuntimeError as e:
            # a failed capture's end raises inside torch.cuda.graph's exit,
            # before it restores the caller's stream and before it ends the
            # CUDA generators' capture (the next random draw would raise):
            # an empty capture ends that
            torch.cuda.set_stream(current)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # "the CUDA graph is empty"
                with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=side):
                    pass
            # where the body failed, the capture's end fails too: name both
            what = f"{e.__context__}; then {e}" if e.__context__ is not None else str(e)
            raise RuntimeError(
                f"CUDA graph capture of {getattr(self.fn, '__name__', self.fn)} failed for inputs "
                f"{key[0]} (layout {key[1]}, mesh {key[2]}): {what}"
            ) from e
        after = launches.read_counts()
        self.graphs[key] = Captured(
            graph, inputs, outputs,
            launches={k: after[k] - before[k] for k in after},
            capture_ms=(time.perf_counter() - t0) * 1e3,
            pool_bytes=torch.cuda.memory_reserved(args[0].device) - reserved,
            held=held + _weights(self.model),
        )
        return out
