"""One captured program per input signature: the port's counterpart of the
``jax.jit`` around ``make_eval_step`` and ``make_infer_fn``, and of the
donated ``jax.jit`` of ``make_train_step``, in ``ecm_tpu/train/steps.py``.

``jax.jit`` traces a function once per input signature into one compiled
program, dispatched once a call, with its constants folded in. PyTorch runs
eagerly: a grouped ``kitti_infer`` forward is about 1100 device operations
and a ``sceneflow_single`` train step about 4760, each dispatched from
Python, and the card waits on the host. :class:`GraphedForward` (eval and
serving) and :class:`GraphedTrainStep` (a train step: forward, loss,
backward, clipping, Adam, the BatchNorm statistics and the metrics) capture
the function once per signature into a ``torch.cuda.CUDAGraph`` and replay
it:

- **Signature** of a forward (:func:`signature`): the inputs' shapes,
  dtypes and device, the model's resolved aggregation layout, the active
  mesh, the TF32 flags, and the stamp, ``(data_ptr, _version)``, of every
  parameter and buffer. The packed weights and folded BatchNorms are made in
  Python caches (``cuda_gband.cached_pack``, ``layers.fold_bn``,
  ``cuda_fused_agg.pair_operands``) that run only at capture, so a graph
  captured before an in-place update (an optimizer step, BatchNorm's running
  statistics, ``load_state_dict``) would replay stale packs and folds.
  When the stamp moves, every graph captured under the old one is dropped
  before anything can replay it.
- **Signature** of a train step (:func:`train_signature`): the batch's
  shapes, dtypes and device, the layout, ``remat``, the TF32 flags,
  ``clip_norm``, and the *addresses* of every parameter, buffer, Adam
  moment and step count and of the learning-rate tensor
  (``train/state.py``). No version: every step moves them all. The step's
  graph updates those tensors in place (what JAX's donation does), and
  packs inside the graph (``cuda_gband.uncached``), so it stays right as
  the weights change, and after ``model.load_state_dict``, which copies in
  place; restoring Adam's state (``train/checkpoint.py``) makes new tensors,
  and the step is captured again.
- **A replay moves no version**: it writes the weights, the statistics and
  Adam's state on the card, unseen by autograd's version counters, which
  the caches above, the stamps and so every eval graph read to learn that
  weights changed. After each replay of a train step, every tensor it
  writes has its version incremented (no kernel), so an eval step after
  replayed train steps (``finetune``'s validation) drops its graph and packs
  and folds again.
- **What a graph reads stays alive**: a graph reads by address the packs
  and folds those caches handed out during its capture, and a cache may
  replace its entry later without a stamp moving (an eager forward in
  another grad mode folds and packs again). Everything the caches hand out
  during a capture (``cuda_gband.holding``), and every tensor its signature
  names, is held by the graph, so no address a graph reads is freed or
  reused while it lives.
- **Capture on the second sighting**: the first call of a signature runs
  eagerly. A capture costs a warm-up, a sync and a pool of its own, which a
  shape served once (Middlebury's scenes, each its own size; ``test_img``)
  never earns back; ``jax.jit`` compiles on the first call instead.
  The second call warms up with one eager call on a side stream (nvcc
  builds, cuDNN's and cuBLAS's workspaces, the plan and pack caches and the
  resize matrices of ``ops/upsample.py``, none of which a capture may do),
  whose outputs are that call's result, and captures; later calls replay.
  A capture runs the function's Python but none of its kernels, so a train
  step's host bookkeeping (``TrainState.step``, ``Optimizer.count``, the
  learning rate's write) lives outside the graph, in ``train/steps.py``, and
  runs once a call: the warm-up is that call's step, the capture none.
- **Static buffers**: each call copies its tensor inputs into the buffers
  the graph reads (other arguments, a train state, pass as they are: the
  signature names their tensors) and returns clones of the graph's outputs,
  which the next replay overwrites (JAX returns a fresh array each call). A
  graph is only ever replayed on its own buffers, whose addresses its
  private pool keeps fixed; the fused pair's TMA tensor map, built on the
  host at capture with x's address (``csrc/fused_conv3d_pair.cu``), is
  frozen into the graph and is right for that reason alone.
- **Memory**: each signature captures into a pool of its own; at most
  ``MAX_GRAPHS`` signatures are kept, the least recently used dropped first.
  The eval CLIs serve batch 1 padded to a multiple of 32, so KITTI's image
  sizes and SceneFlow's each repeat one signature and Middlebury's none;
  two leave room for one more, as a validation split's short last batch.
  The train CLIs draw one crop size, so a run keeps one train graph.
- **Launch counts**: what the kernel wrappers count during a capture
  (``ops/launches.py``) is the graph's launches per replay; the capture
  launches nothing, so the wrappers' counts are set back after it. A replay
  runs no Python, so no wrapper counts it; each replay adds those launches
  to ``launches.read_replayed()``. ``read_counts()`` plus
  ``read_replayed()`` are the launches that ran.
- **Spans** (``utils/profiling.span``; nothing while no profiler records):
  each call is an ``ecm.graph.call``, holding ``ecm.graph.signature`` (the
  key) and then either ``ecm.graph.eager``, ``ecm.graph.capture`` (warm-up
  and capture), or a replay's ``ecm.graph.copy_in``, ``ecm.graph.replay``
  (the graph's launch), ``ecm.graph.bump`` (the versions) and
  ``ecm.graph.copy_out`` (the clones). None of them synchronises with the card.
- A failed capture raises, naming the function and its signature. Nothing
  falls back to the eager call. (A train step's warm-up has then been
  applied and its host bookkeeping has not.)

Calls stay eager, by explicit branches in the classes' ``key``, on CPU
tensors (the device the caller chose, as the tests do); a forward under a
mesh of more than one rank, where the halo exchanges and gathers
(``parallel/halo.py``) and the metrics' sums run collectives through gloo's
pinned host buffers, which a graph cannot hold; and a train step in
``torch.autograd``'s anomaly mode (``--debug-nans``), which reads values on
the host. ``make_train_step`` builds no graph at all under a mesh
(``train/steps.py``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
import warnings

import torch
from torch import nn

from ecm_torch.ops import launches
from ecm_torch.ops.cuda_gband import holding, uncached
from ecm_torch.parallel.sharding import Mesh, active_mesh
from ecm_torch.utils.profiling import span

MAX_GRAPHS = 2
MAX_SEEN = 64  # signatures served once and not captured, remembered


def signature(model: nn.Module, args: tuple[torch.Tensor, ...], mesh: Mesh | None) -> tuple:
    """The key of a captured forward: what the capture read besides the
    inputs' values (see the module's docstring)."""
    return (
        _shapes(args),
        _layout(model, args[0].device),
        None if mesh is None else (mesh.data, mesh.disp),
        _tf32(),
        weights_stamp(model),
    )


def train_signature(model: nn.Module, optimizer, batch: tuple[torch.Tensor, ...]) -> tuple:
    """The key of a captured train step: what the capture read besides the
    batch's values, the tensors it reads and writes by their addresses
    alone (see the module's docstring). ``optimizer``: the state's
    ``train.state.Optimizer``."""
    return (
        _shapes(batch),
        _layout(model, batch[0].device),
        getattr(model, "remat", None),
        _tf32(),
        optimizer.clip_norm,
        tuple(t.data_ptr() for t in _weights(model) + optimizer.tensors()),
    )


def _shapes(args) -> tuple:
    return tuple((tuple(a.shape), a.dtype, a.device) for a in args)


def _layout(model: nn.Module, device: torch.device) -> str | None:
    return model.resolve_layout(device) if hasattr(model, "resolve_layout") else None


def _tf32() -> tuple[bool, bool]:
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


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
    inputs: tuple  # the static buffers of the tensor arguments; other arguments as they were
    outputs: object
    launches: dict[str, int]  # kernel launches per replay
    capture_ms: float  # warm-up excluded
    pool_bytes: int  # device memory the capture reserved
    held: list  # the tensors and cached packs and folds that the graph reads
    writes: list = dataclasses.field(default_factory=list)  # tensors whose version a replay moves
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

    def key(self, args: tuple) -> tuple | None:
        """The signature of a call; None where it runs eagerly."""
        if not _on_card(args[0]):
            return None  # the caller chose the CPU: eager, no graph
        mesh = active_mesh()
        if mesh is not None and mesh.data * mesh.disp > 1:
            return None  # collectives through gloo's host buffers: no graph can hold them
        return signature(self.model, args, mesh)

    def describe(self, key: tuple) -> str:
        return f"inputs {key[0]} (layout {key[1]}, mesh {key[2]})"

    def _reads(self, args: tuple) -> list[torch.Tensor]:
        """The tensors besides the inputs that a capture reads by address."""
        return _weights(self.model)

    def _writes(self, args: tuple) -> list[torch.Tensor]:
        """The tensors besides the outputs that a replay writes."""
        return []

    def _capturing(self):
        """The context of a capture (a train step's packs inside the graph)."""
        return contextlib.nullcontext()

    def __call__(self, *args):
        with span("ecm.graph.call"):
            with span("ecm.graph.signature"):
                key = self.key(args)
            if key is None:
                with span("ecm.graph.eager"):
                    return self.fn(*args)
            captured = self.graphs.get(key)
            if captured is None:
                return self._miss(key, args)
            self.graphs.move_to_end(key)
            with span("ecm.graph.copy_in"):
                for buf, a in zip(captured.inputs, args):
                    if isinstance(buf, torch.Tensor):
                        buf.copy_(a)
            with span("ecm.graph.replay"):
                captured.graph.replay()
                captured.replays += 1
                launches.add_replayed(captured.launches)
            if captured.writes:
                with span("ecm.graph.bump"):
                    torch.autograd.graph.increment_version(captured.writes)
            with span("ecm.graph.copy_out"):
                return _map(torch.clone, captured.outputs)

    def _miss(self, key: tuple, args: tuple):
        """A signature with no graph: forget those of other weights, then
        run eagerly the first time ``key`` is seen and capture the second."""
        for old in [k for k in (*self.graphs, *self.seen) if k[-1] != key[-1]]:
            self.graphs.pop(old, None)
            self.seen.pop(old, None)
        if key in self.seen:
            del self.seen[key]
            with span("ecm.graph.capture"):
                return self._capture(key, args)
        self.seen[key] = None
        while len(self.seen) > MAX_SEEN:
            self.seen.popitem(last=False)
        with span("ecm.graph.eager"):
            return self.fn(*args)

    def _capture(self, key: tuple, args: tuple):
        """Warm up and capture ``key``; returns the warm-up's outputs."""
        while len(self.graphs) >= MAX_GRAPHS:
            self.graphs.popitem(last=False)
        device = next(a for a in args if isinstance(a, torch.Tensor)).device
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self.fn(*args)
        current.wait_stream(side)
        for t in _leaves(out):
            t.record_stream(current)
        inputs = tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        before = launches.read_counts()
        t0 = time.perf_counter()
        try:
            with holding() as held, self._capturing(), torch.cuda.graph(graph, stream=side):
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
                f"CUDA graph capture of {getattr(self.fn, '__name__', self.fn)} failed for "
                f"{self.describe(key)}: {what}"
            ) from e
        finally:
            after = launches.read_counts()
            launches.set_counts(before)  # a capture launches nothing; its replays count
        self.graphs[key] = Captured(
            graph, inputs, outputs,
            launches={k: after[k] - before[k] for k in after},
            capture_ms=(time.perf_counter() - t0) * 1e3,
            pool_bytes=torch.cuda.memory_reserved(device) - reserved,
            held=held + self._reads(args),
            writes=self._writes(args),
        )
        return out


class GraphedTrainStep(GraphedForward):
    """``fn(state, left, right, gt) -> metrics`` (``train/steps.py``'s device
    work of one train step on ``model``: it reads and updates ``state``'s
    model and optimizer in place) captured the second time a
    :func:`train_signature` is seen, and replayed; eager on CPU tensors and
    in ``torch.autograd``'s anomaly mode."""

    def key(self, args: tuple) -> tuple | None:
        state, *batch = args
        if not _on_card(batch[0]):
            return None  # the caller chose the CPU: eager, no graph
        if torch.is_anomaly_enabled():
            return None  # it checks each backward's values on the host
        return train_signature(self.model, state.optimizer, batch)

    def describe(self, key: tuple) -> str:
        return f"batch {key[0]} (layout {key[1]}, remat {key[2]}, clip_norm {key[4]})"

    def _reads(self, args: tuple) -> list[torch.Tensor]:
        return _weights(self.model) + args[0].optimizer.tensors()

    def _writes(self, args: tuple) -> list[torch.Tensor]:
        return self._reads(args)

    def _capturing(self):
        return uncached()
