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

- **Signature** of a forward: the key read before the launch
  (:func:`signature`: the inputs' shapes, dtypes and device, the model's
  resolved aggregation layout, the active mesh, the TF32 flags), and the
  weights stamp (:func:`weights_stamp`: the address of every parameter and
  buffer). The wrapper keeps one stamp, the one its graphs and sightings
  were taken under, and keys them by the key alone; a new stamp forgets
  them all.
- **Weights by address**: a graph reads the model's parameters and buffers
  where they live, and makes every derived form of them (the kernels'
  packed weights, the folded BatchNorms, the casts) inside itself, so each
  replay derives them from the weights as they are then; nothing caches a
  derived weight. An update in place (an optimizer step, a replayed train
  step, BatchNorm's running statistics, ``load_state_dict``) is replayed
  as it is; only a replaced tensor, which has a new address, moves the
  stamp. A graph holds every tensor its stamp names (``Captured.held``),
  so no address it reads is freed or reused while it lives.
- **The stamp after the launch**: the stamp walks every module, the key
  takes microseconds. A forward's graph writes nothing but its pool and
  outputs: it is launched on the key alone, and the stamp is read while
  the card runs it. Under the graph's stamp its outputs are cloned and
  returned; under another, the replay is thrown away (never returned nor
  cloned; its stream is synchronised first, so nothing it reads is freed
  under it), the graphs and sightings are forgotten, and the call goes on
  as a miss. No user code runs between the call's start and that read, so
  a call returns a replay's result only under the stamp it was captured
  with, as when the stamp was read first; a stamp's change costs one
  wasted replay. A train step, which writes state in place, is launched
  only after its whole key is checked. ``late_checks`` and ``discards``
  count the replays checked after their launch and those thrown away.
- **Signature** of a train step (:func:`train_signature`): the batch's
  shapes, dtypes and device, the layout, ``remat``, the TF32 flags,
  ``clip_norm``, and the addresses of every parameter, buffer, Adam moment
  and step count and of the learning-rate tensor (``train/state.py``). The
  step's graph updates those tensors in place (what JAX's donation does);
  restoring Adam's state (``train/checkpoint.py``) makes new tensors, and
  the step is captured again.
- **Capture on the second sighting**: the first call of a signature runs
  eagerly. A capture costs a warm-up, a sync and a pool of its own, which a
  shape served once (Middlebury's scenes, each its own size; ``test_img``)
  never earns back; ``jax.jit`` compiles on the first call instead.
  The second call warms up with one eager call on a side stream (nvcc
  builds, cuDNN's and cuBLAS's workspaces, the kernels' plans and the
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
  key read before the launch: a train step's whole key) and then either
  ``ecm.graph.stamp`` (a forward's weights stamp) and ``ecm.graph.eager``
  or ``ecm.graph.capture`` (warm-up and capture), or a replay's
  ``ecm.graph.copy_in``, ``ecm.graph.replay`` (the graph's launch), then
  ``ecm.graph.stamp`` for a forward, and ``ecm.graph.copy_out`` (the
  clones). None of them synchronises with the card (a discarded replay is
  waited for between its ``ecm.graph.stamp`` and the eager call).
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
import dataclasses
import time
import warnings

import torch
from torch import nn

from ecm_torch.ops import launches
from ecm_torch.parallel.sharding import Mesh, active_mesh
from ecm_torch.utils.profiling import span

MAX_GRAPHS = 2
MAX_SEEN = 64  # signatures served once and not captured, remembered


def signature(model: nn.Module, args: tuple[torch.Tensor, ...], mesh: Mesh | None) -> tuple:
    """The key of a captured forward, read before its launch: what the
    capture read besides the inputs' values and the weights, whose
    :func:`weights_stamp` is read after it (see the module's docstring)."""
    return (
        _shapes(args),
        _layout(model, args[0].device),
        None if mesh is None else (mesh.data, mesh.disp),
        _tf32(),
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
    """The address of every parameter and buffer of ``model``, read from the
    modules' own dicts (:func:`_weights`): this runs on every call, and
    ``model.parameters()`` and ``buffers()``, which build every name on the
    way, take three times as long."""
    return tuple(t.data_ptr() for t in _weights(model))


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
    held: list  # the tensors its stamp names, which it reads by address
    replays: int = 0


class GraphedForward:
    """``fn(*args)`` (tensors in; a tensor, tuple or dict of tensors out)
    captured the second time a :func:`signature` of ``model`` and the inputs
    is seen, and replayed; eager on CPU tensors and under a mesh of more
    than one rank."""

    # a forward writes only its pool and outputs: launched on the key alone,
    # its stamp read while the card runs it
    stamp_after_launch = True

    def __init__(self, fn, model: nn.Module):
        self.fn = fn
        self.model = model
        self.graphs: collections.OrderedDict[tuple, Captured] = collections.OrderedDict()
        self.seen: collections.OrderedDict[tuple, None] = collections.OrderedDict()
        self.stamp: tuple | None = None  # the one every graph and sighting was taken under
        self.late_checks = 0  # replays whose stamp was read after their launch
        self.discards = 0  # of those, the replays thrown away for a moved stamp

    def key(self, args: tuple) -> tuple | None:
        """The part of a call's signature read before the launch; None where
        it runs eagerly."""
        if not _on_card(args[0]):
            return None  # the caller chose the CPU: eager, no graph
        mesh = active_mesh()
        if mesh is not None and mesh.data * mesh.disp > 1:
            return None  # collectives through gloo's host buffers: no graph can hold them
        return signature(self.model, args, mesh)

    def describe(self, key: tuple) -> str:
        return f"inputs {key[0]} (layout {key[1]}, mesh {key[2]})"

    def _stamp(self, key: tuple) -> tuple:
        """The rest of the signature: what moves when the weights change."""
        with span("ecm.graph.stamp"):
            return weights_stamp(self.model)

    def _reads(self, args: tuple) -> list[torch.Tensor]:
        """The tensors besides the inputs that a capture reads by address."""
        return _weights(self.model)

    def __call__(self, *args):
        with span("ecm.graph.call"):
            with span("ecm.graph.signature"):
                key = self.key(args)
            if key is None:
                with span("ecm.graph.eager"):
                    return self.fn(*args)
            captured = self.graphs.get(key)
            late = captured is not None and self.stamp_after_launch
            if not late:
                stamp = self._stamp(key)
                if captured is None or stamp != self.stamp:
                    return self._miss(key, stamp, args)
            self.graphs.move_to_end(key)
            with span("ecm.graph.copy_in"):
                for buf, a in zip(captured.inputs, args):
                    if isinstance(buf, torch.Tensor):
                        buf.copy_(a)
            with span("ecm.graph.replay"):
                captured.graph.replay()
                captured.replays += 1
                launches.add_replayed(captured.launches)
            if late:
                self.late_checks += 1
                stamp = self._stamp(key)
                if stamp != self.stamp:
                    self.discards += 1
                    if args[0].is_cuda:
                        # the replay ends before its graph, and what the
                        # graph holds, are forgotten below
                        torch.cuda.current_stream(args[0].device).synchronize()
                    return self._miss(key, stamp, args)
            with span("ecm.graph.copy_out"):
                return _map(torch.clone, captured.outputs)

    def _miss(self, key: tuple, stamp: tuple, args: tuple):
        """A signature with no graph under ``stamp``: forget the graphs and
        sightings of another stamp, then run eagerly the first time ``key``
        is seen and capture the second."""
        if stamp != self.stamp:
            self.graphs.clear()
            self.seen.clear()
            self.stamp = stamp
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
            with torch.cuda.graph(graph, stream=side):
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
            held=self._reads(args),
        )
        return out


class GraphedTrainStep(GraphedForward):
    """``fn(state, left, right, gt) -> metrics`` (``train/steps.py``'s device
    work of one train step on ``model``: it reads and updates ``state``'s
    model and optimizer in place) captured the second time a
    :func:`train_signature` is seen, and replayed; eager on CPU tensors and
    in ``torch.autograd``'s anomaly mode."""

    stamp_after_launch = False  # it writes state in place: launched under its whole key only

    def key(self, args: tuple) -> tuple | None:
        state, *batch = args
        if not _on_card(batch[0]):
            return None  # the caller chose the CPU: eager, no graph
        if torch.is_anomaly_enabled():
            return None  # it checks each backward's values on the host
        return train_signature(self.model, state.optimizer, batch)

    def describe(self, key: tuple) -> str:
        return f"batch {key[0]} (layout {key[1]}, remat {key[2]}, clip_norm {key[4]})"

    def _stamp(self, key: tuple) -> tuple:
        return key[-1]  # the addresses, read with the key

    def _reads(self, args: tuple) -> list[torch.Tensor]:
        return _weights(self.model) + args[0].optimizer.tensors()
