"""The port's disparity axis (``ecm_torch.parallel.halo``, slice 10) on the
CPU: four gloo ranks, started once by ``ecm_torch.parallel.dryrun.launch``
(one torch thread a rank, a free localhost port, 240 s for the run and 60 s
for each collective), against ``ecm_tpu`` on conftest's fake CPU devices
and against the port in one process.

- The four primitives on ``make_mesh(data=1, disp=4)``: ``halo_exchange_d``
  (halos 1 and 2), ``conv3d_d_sharded`` and ``softargmin_d_sharded`` against
  ``ecm_tpu.parallel.halo`` and against the unsharded ops, ``gather_d``
  against ``jax.lax.all_gather`` and the unsharded volume, at
  ``tests/test_halo.py``'s shapes and tolerances.
- Each 3D conv form of the eval forward on its slab, at batch 2 (a D-slice
  is then not contiguous), against the unsharded form (the kernels' plain
  versions and the cuDNN modules' torch ops), on every rank: the first, two
  interior ones and the last.
- The cost-volume builders over a range of disparities against the whole
  volume's planes, bit for bit, and their closed-form VJPs.
- The eval forward of ``ECMStereo`` (max-disp 64, width 8, 32x64, f32) on
  the standard chain, the standard fused pairs and the grouped dispatch,
  ``ECMBasic``, and ``cost_mode="correlation"``, each on ``(1, 4)`` and
  ``(2, 2)`` meshes, against ``ecm_tpu``'s eval under the same mesh with the
  same weights (``weights.load_flax``) and against the port unsharded:
  disparity within 1e-3 px (``tests/test_parallel.py:128-130``). The
  correlation path runs in f64 on both sides: in f32 the two packages'
  unsharded disparities already differ by 0.88e-3 px on these pairs (its
  volume's mean over C in another order, through a random-init
  soft-argmin), which leaves no room for the sharding at 1e-3.
- The ``evaluate`` CLI under ``torch.distributed.run --nproc_per_node 4``
  with ``--multihost --mesh-disp 4 --device cpu`` on a tiny Middlebury
  tree, against one process.
- What raises: an indivisible ``max_disp`` (at eval and in training), a
  grid that is not the group.
"""

import concurrent.futures
import contextlib
import dataclasses
import io
import json
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as PS

from ecm_tpu.models import build_model as jax_build_model
from ecm_tpu.ops.softargmin import softargmin_jnp
from ecm_tpu.parallel.halo import conv3d_d_sharded as jax_conv3d_d_sharded
from ecm_tpu.parallel.halo import halo_exchange_d as jax_halo_exchange_d
from ecm_tpu.parallel.halo import softargmin_d_sharded as jax_softargmin_d_sharded
from ecm_tpu.parallel.sharding import batch_sharding as jax_batch_sharding
from ecm_tpu.parallel.sharding import make_mesh as jax_make_mesh
from ecm_tpu.parallel.sharding import replicate as jax_replicate
from ecm_tpu.parallel.sharding import use_mesh as jax_use_mesh
from ecm_torch.cli import common as cli_common
from ecm_torch.cli import evaluate as cli_evaluate
from ecm_torch.configs import CONFIGS
from ecm_torch.configs.base import SLICE2_OVERRIDES, SLICE_OVERRIDES
from ecm_torch.models.aggregation import ClassifHead
from ecm_torch.models.layers import ConvBN, ConvTransposeBN
from ecm_torch.ops import cuda_cost_volume as cvk
from ecm_torch.ops.cuda_fused_agg import fused_conv3d_pair
from ecm_torch.ops.cuda_gband import conv3d_bn_down, conv3d_bn_s1
from ecm_torch.ops.cuda_gdeconv import deconv3d_bn
from ecm_torch.parallel import dryrun
from ecm_torch.parallel.sharding import Mesh, use_mesh
from ecm_torch.weights import load_flax
from test_torch_port_parallel import _run_group
from test_torch_port_util import assert_close_rel, flax_variables, to_torch_kernel, torch_threads
from test_torch_port_util import write_middlebury_tree

RANKS = 4
TIMEOUT = 240  # seconds, the ranks' launch and the CLI run
GROUP_TIMEOUT = 60  # seconds, each collective
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
SMALL = dict(max_disp=64, feature_channels=8)
PLAIN = dict(agg_layout="standard", agg_fused="off", use_pallas=False, regress_mode="fullres")
# the port's eval paths: (model name, overrides); the JAX reference of each
# is its plain standard path with the same cost mode (its layouts share one
# parameter tree and compute one function)
PATHS = {
    "stereo_chain": ("stackhourglass", PLAIN),
    "stereo_fused_pairs": ("stackhourglass", SLICE_OVERRIDES),
    "stereo_grouped": ("stackhourglass", SLICE2_OVERRIDES),
    "basic": ("basic", dict(use_pallas=False, regress_mode="fullres")),
    "stereo_correlation": ("stackhourglass", dict(PLAIN, cost_mode="correlation")),
}
# in f64 on both sides (see the module's docstring)
DOUBLE = {"stereo_correlation"}
EVAL_B, EVAL_H, EVAL_W = 2, 32, 64


def jax_kind(path: str) -> tuple[str, str]:
    name, kw = PATHS[path]
    return name, kw.get("cost_mode", "concat")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    with torch_threads(1):
        yield


# --- the primitives --------------------------------------------------------

def halo_inputs() -> dict:
    """``tests/test_halo.py``'s shapes: a [2, 16, 8, 8, 4] volume with a
    3x3x3 4->6 kernel; a [2, 24, 8, 8] cost (x5) and a one-hot [1, 32, 4, 4]
    cost at plane 21."""
    rng = np.random.default_rng(0)
    vol = rng.normal(size=(2, 16, 8, 8, 4)).astype(np.float32)
    k = rng.normal(size=(3, 3, 3, 4, 6)).astype(np.float32)
    soft = (rng.normal(size=(2, 24, 8, 8)) * 5).astype(np.float32)
    one_hot = np.zeros((1, 32, 4, 4), np.float32)
    one_hot[:, 21] = -1000.0
    return dict(vol=vol, k=k, costs=dict(soft=soft, one_hot=one_hot))


def halo_case(inputs: dict) -> dict:
    return dict(name="halo", kind="halo", mesh=MESHES["1x4"], vol=torch.from_numpy(inputs["vol"]),
                weight=to_torch_kernel(inputs["k"]), costs={k: torch.from_numpy(v) for k, v in inputs["costs"].items()})


def jax_halo_refs(inputs: dict) -> dict:
    """``ecm_tpu.parallel.halo`` on ``make_mesh(data=1, disp=4)`` and the
    unsharded ops. The shard_map outputs are the ranks' results
    concatenated along D."""
    mesh = jax_make_mesh(data=1, disp=4)
    vol = jnp.asarray(inputs["vol"])

    def sharded(fn):
        return shard_map(fn, mesh=mesh, in_specs=PS(None, "disp"), out_specs=PS(None, "disp"))

    refs = {f"halo{h}": np.asarray(sharded(lambda v, h=h: jax_halo_exchange_d(v, "disp", h))(vol)) for h in (1, 2)}
    # each shard's gathered volume, the shards concatenated along D
    refs["gather"] = np.asarray(sharded(lambda v: jax.lax.all_gather(v, "disp", axis=1, tiled=True))(vol))
    refs["conv"] = np.asarray(jax_conv3d_d_sharded(vol, jnp.asarray(inputs["k"]), mesh))
    refs["conv_unsharded"] = np.asarray(jax.lax.conv_general_dilated(
        vol, jnp.asarray(inputs["k"]), (1, 1, 1), ((1, 1),) * 3, dimension_numbers=("NDHWC", "DHWIO", "NDHWC")))
    for name, c in inputs["costs"].items():
        refs[name] = np.asarray(jax_softargmin_d_sharded(jnp.asarray(c), mesh))
        refs[f"{name}_unsharded"] = np.asarray(softargmin_jnp(jnp.asarray(c)))
    return refs


# --- the conv forms ---------------------------------------------------------

FORM_B, FORM_D, FORM_H, FORM_W, C = 2, 16, 6, 10, 8


def _rnd(rng, *shape, scale=1.0) -> torch.Tensor:
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))


def _module_state(module: torch.nn.Module, rng) -> dict:
    """``module``'s state with every tensor drawn: weights fan-in scaled,
    BatchNorm statistics away from the identity."""
    state = {}
    for k, v in module.state_dict().items():
        if k.endswith("num_batches_tracked"):
            state[k] = v
        elif k.endswith(("running_var", ".weight")) and v.ndim == 1:
            state[k] = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
        elif v.ndim > 1:
            state[k] = _rnd(rng, *v.shape, scale=1.0 / math.sqrt(v[0].numel()))
        else:
            state[k] = _rnd(rng, *v.shape, scale=0.3)
    return state


def form_cases() -> list[dict]:
    """Every 3D conv form the eval forward runs on a slab: the cuDNN
    modules (``ConvBN`` stride 1 and 2, ``ConvTransposeBN``,
    ``ClassifHead``), ``conv3d_bn_s1`` with a context map and with a
    residual, ``conv3d_bn_down``, ``deconv3d_bn`` with its ``cost0`` add, and
    ``fused_conv3d_pair`` in its three forms. Each case's planes: 16 (four
    a rank) at stride 1 and 2, 8 into a transposed conv."""
    rng = np.random.default_rng(5)
    x8, x16 = (_rnd(rng, FORM_B, FORM_D, FORM_H, FORM_W, c) for c in (C, 2 * C))
    up16 = _rnd(rng, FORM_B, FORM_D // 2, FORM_H, FORM_W, 2 * C)
    cases = []
    for name, cls, args, x in (
        ("module_convbn_s1", ConvBN, (C, C, 3, 1, 1, True, 3), x8),
        ("module_convbn_s2", ConvBN, (C, 2 * C, 3, 2, 1, True, 3), x8),
        ("module_deconv", ConvTransposeBN, (2 * C, C), up16),
        ("module_classif_head", ClassifHead, (C,), x8),
    ):
        cases.append(dict(name=name, module=cls.__name__, module_args=args, x=x,
                          state_dict=_module_state(cls(*args), rng)))

    def affine(c):
        return [_rnd(rng, c, scale=0.3) + 1.0, _rnd(rng, c, scale=0.1)]

    def k(cout, cin):
        return _rnd(rng, cout, cin, 3, 3, 3, scale=(27 * cin) ** -0.5)

    cases += [
        dict(name="conv3d_bn_s1_ctx", kernel="conv3d_bn_s1", x=x16, args=[k(C, 2 * C), *affine(C)],
             add=_rnd(rng, FORM_B, 1, FORM_H, FORM_W, C)),
        dict(name="conv3d_bn_s1_residual", kernel="conv3d_bn_s1", x=x8, args=[k(C, C), *affine(C)],
             add=_rnd(rng, FORM_B, FORM_D, FORM_H, FORM_W, C), kwargs=dict(relu=False)),
        dict(name="conv3d_bn_down", kernel="conv3d_bn_down", x=x8, args=[k(2 * C, C), *affine(2 * C)]),
        dict(name="deconv3d_bn_add", kernel="deconv3d_bn", x=up16,
             args=[_rnd(rng, 2 * C, C, 3, 3, 3, scale=(27 * 2 * C) ** -0.5), *affine(C)],
             add=_rnd(rng, FORM_B, FORM_D, 2 * FORM_H, 2 * FORM_W, C)),
        dict(name="pair_ctx", kernel="fused_conv3d_pair", x=x16,
             args=[k(C, 2 * C), *affine(C), k(C, C), *affine(C)], add=_rnd(rng, FORM_B, 1, FORM_H, FORM_W, C)),
        dict(name="pair_residual", kernel="fused_conv3d_pair", x=x8,
             args=[k(C, C), *affine(C), k(C, C), *affine(C)], kwargs=dict(relu2=False, residual=True)),
        dict(name="pair_classif", kernel="fused_conv3d_pair", x=x8,
             args=[k(C, C), *affine(C), k(1, C), torch.ones(1), _rnd(rng, 1, scale=0.1)],
             kwargs=dict(relu2=False)),
    ]
    for c in cases:
        c.update(kind="slab", mesh=MESHES["1x4"])
    return cases


def form_reference(case: dict) -> torch.Tensor:
    """The form on the whole volume in one process."""
    x = case["x"]
    if "module" in case:
        module = {"ConvBN": ConvBN, "ConvTransposeBN": ConvTransposeBN,
                  "ClassifHead": ClassifHead}[case["module"]](*case["module_args"]).eval()
        module.load_state_dict(case["state_dict"])
        with torch.no_grad():
            return module(x)
    args, kw, add = case["args"], case.get("kwargs", {}), case.get("add")
    fn = {"conv3d_bn_s1": conv3d_bn_s1, "deconv3d_bn": deconv3d_bn}.get(case["kernel"])
    if fn is not None:
        return fn(x, *args, add, **kw)
    if case["kernel"] == "conv3d_bn_down":
        return conv3d_bn_down(x, *args, **kw)
    return fused_conv3d_pair(x, *args, None if add is None else add[:, 0], **kw)


def output_scale(case: dict) -> float:
    """Output planes per input plane of the form."""
    if case.get("kernel") == "deconv3d_bn" or case.get("module") == "ConvTransposeBN":
        return 2.0
    if case.get("kernel") == "conv3d_bn_down" or case.get("module_args", (0,) * 4)[3:4] == (2,):
        return 0.5
    return 1.0


# --- the eval forward ------------------------------------------------------

def eval_batch() -> dict:
    rng = np.random.default_rng(11)
    return {k: rng.normal(size=(EVAL_B, EVAL_H, EVAL_W, 3)).astype(np.float32) for k in ("left", "right")}


def port_dtype(path: str) -> torch.dtype:
    return torch.float64 if path in DOUBLE else torch.float32


def port_model(path: str, variables=None) -> torch.nn.Module:
    name, kw = PATHS[path]
    cfg = dataclasses.replace(CONFIGS["middlebury_disp_sharded"].model, name=name, bf16=False)
    model = cfg.build(device="cpu", **SMALL, **kw, dtype=port_dtype(path))
    if variables is not None:
        load_flax(model, variables)
    return model.double() if path in DOUBLE else model


def port_batch(path: str, batch: dict) -> dict:
    return {k: torch.from_numpy(v).to(port_dtype(path)) for k, v in batch.items()}


def is_double(kind: tuple[str, str]) -> bool:
    return any(jax_kind(p) == kind for p in DOUBLE)


def _x64(kind: tuple[str, str]):
    return jax.enable_x64(True) if is_double(kind) else contextlib.nullcontext()


def jax_models() -> dict:
    """One JAX model per (model name, cost mode), with its variables (f64
    for the paths of ``DOUBLE``)."""
    batch = eval_batch()
    out = {}
    for i, kind in enumerate(sorted({jax_kind(p) for p in PATHS})):
        name, cost_mode = kind
        kw = dict(regress_mode="fullres", use_pallas=False, cost_mode=cost_mode, **SMALL)
        if name == "stackhourglass":
            kw.update(agg_layout="standard", agg_fused="off", remat=False)
        double = is_double(kind)
        with _x64(kind):
            jm = jax_build_model(name, **kw, **(dict(dtype=jnp.float64) if double else {}))
            variables = flax_variables(jm, jnp.asarray(batch["left"]), jnp.asarray(batch["right"]), seed=20 + i)
            out[kind] = (jm, jax.tree.map(lambda a: np.asarray(a, np.float64 if double else np.float32), variables))
    return out


def jax_sharded_eval(models: dict, batch: dict) -> dict:
    """Each JAX model's eval disparity under each mesh (batch over data,
    the volume's disparities over disp), and unsharded."""
    out = {}
    for kind, (jm, variables) in models.items():
        with _x64(kind):
            fwd = jax.jit(lambda v, left, right, jm=jm: jm.apply(v, left, right, train=False)[-1])
            dtype = jax.tree.leaves(variables)[0].dtype
            jb = {k: jnp.asarray(v.astype(dtype)) for k, v in batch.items()}
            out[kind, None] = np.asarray(fwd(variables, jb["left"], jb["right"]))
            for mesh_name, (data, disp) in MESHES.items():
                mesh = jax_make_mesh(data=data, disp=disp)
                with jax_use_mesh(mesh):
                    sb = jax.device_put(jb, jax_batch_sharding(mesh))
                    out[kind, mesh_name] = np.asarray(fwd(jax.device_put(variables, jax_replicate(mesh)),
                                                          sb["left"], sb["right"]))
    return out


def eval_cases(models: dict, batch: dict) -> list[dict]:
    cases = []
    for path, (name, kw) in PATHS.items():
        sd = port_model(path, models[jax_kind(path)][1]).state_dict()
        for mesh_name, shape in MESHES.items():
            cases.append(dict(
                name=f"{path}_{mesh_name}", kind="disp_eval", mesh=shape, config="middlebury_disp_sharded",
                model=name, overrides=dict(SMALL, **kw, dtype=port_dtype(path)), double=path in DOUBLE,
                state_dict=sd, batch=port_batch(path, batch),
            ))
    return cases


# --- the evaluate CLI --------------------------------------------------------

CLI_ARGS = ["--config", "middlebury_disp_sharded", "--maxdisp", "64", "--no-bf16", "--dataset", "middlebury",
            "--device", "cpu"]


def run_evaluate_cli(tmp: Path, tree: str):
    """``torch.distributed.run --nproc_per_node 4`` of the evaluate CLI on
    the disparity axis (gloo on the CPU)."""
    return _run_group([
        sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(RANKS), "--nnodes", "1",
        "--master_addr", "localhost", "--master_port", str(dryrun.free_port()), "-m", "ecm_torch.cli.evaluate",
        *CLI_ARGS, "--datapath", tree, "--multihost", "--mesh-disp", "4", "--dist-timeout", str(GROUP_TIMEOUT),
    ], tmp)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Every case on four ranks, the CLI under torch.distributed.run, and
    the JAX references computed while they run."""
    tmp = tmp_path_factory.mktemp("disp")
    inputs = halo_inputs()
    models = jax_models()
    batch = eval_batch()
    grids = [dict(name=f"grid_{d}x{p}", kind="grid", shape=(d, p)) for d, p in ((1, 4), (2, 2), (3, 2), (1, 3))]
    cases = [*grids, halo_case(inputs), *form_cases(), *eval_cases(models, batch)]
    torch.save(cases, tmp / "cases.pt")
    tree = write_middlebury_tree(tmp / "middlebury", h=40, w=70)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ranks = pool.submit(dryrun.launch, ["--cases", str(tmp / "cases.pt"), "--out", str(tmp),
                                            "--timeout", str(GROUP_TIMEOUT)], RANKS, TIMEOUT)
        cli = pool.submit(run_evaluate_cli, tmp, tree)
        halo_refs = jax_halo_refs(inputs)
        jax_evals = jax_sharded_eval(models, batch)
        ranks.result()
        cli = cli.result()
    results = [torch.load(tmp / f"rank{r}.pt", weights_only=True) for r in range(RANKS)]
    return dict(inputs=inputs, halo_refs=halo_refs, models=models, batch=batch, jax=jax_evals, ranks=results,
                cli=cli, tree=tree)


def test_halo_exchange_matches_ecm_tpu(group):
    """Each rank's slab with 1 and 2 halo planes equals its shard of
    ``ecm_tpu``'s ``halo_exchange_d`` under ``shard_map``, bit for bit (zero
    planes at the ends of the range)."""
    for h in (1, 2):
        ref = group["halo_refs"][f"halo{h}"]
        per = ref.shape[1] // RANKS
        for r, res in enumerate(group["ranks"]):
            np.testing.assert_array_equal(res["halo"][f"halo{h}"].numpy(), ref[:, r * per:(r + 1) * per])


def test_conv3d_d_sharded_matches_ecm_tpu_and_unsharded(group):
    """The ranks' slabs of the sharded conv, concatenated, against
    ``ecm_tpu``'s sharded conv and the unsharded SAME conv at 1e-4
    (``tests/test_halo.py``)."""
    out = np.concatenate([res["halo"]["conv"].numpy() for res in group["ranks"]], 1)
    np.testing.assert_allclose(out, group["halo_refs"]["conv"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out, group["halo_refs"]["conv_unsharded"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cost", ["soft", "one_hot"])
def test_softargmin_d_sharded_matches_ecm_tpu_and_unsharded(group, cost):
    """Every rank's disparity against ``ecm_tpu``'s two-pass soft-argmin and
    the unsharded one at 1e-5; the one-hot cost at plane 21 regresses to 21
    within 1e-4."""
    refs = group["halo_refs"]
    for res in group["ranks"]:
        got = res["halo"][cost].numpy()
        np.testing.assert_allclose(got, refs[cost], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, refs[f"{cost}_unsharded"], rtol=1e-5, atol=1e-5)
        if cost == "one_hot":
            np.testing.assert_allclose(got, 21.0, atol=1e-4)


def test_gather_d_is_the_whole_volume(group):
    """``gather_d`` returns, on every rank, the slabs in rank order: the
    unsharded volume and ``jax.lax.all_gather``'s, bit for bit."""
    d = group["inputs"]["vol"].shape[1]
    for r, res in enumerate(group["ranks"]):
        np.testing.assert_array_equal(res["halo"]["gather"].numpy(), group["inputs"]["vol"])
        np.testing.assert_array_equal(res["halo"]["gather"].numpy(), group["halo_refs"]["gather"][:, r * d:(r + 1) * d])


@pytest.mark.parametrize("name", [c["name"] for c in form_cases()])
def test_conv_form_on_each_rank_matches_unsharded(group, name):
    """Each rank's output slab of the form (first, interior, last) against
    the same planes of the form on the whole volume, f32, max|diff| <=
    1e-5 max|ref| of the rank's planes."""
    case = next(c for c in form_cases() if c["name"] == name)
    ref = form_reference(case)
    scale = output_scale(case)
    planes = case["x"].shape[1] // RANKS
    n = round(planes * scale)
    for r, res in enumerate(group["ranks"]):
        got = res[name]["out"]
        assert got.shape == (*ref.shape[:1], n, *ref.shape[2:]), (r, got.shape)
        assert_close_rel(got.numpy(), ref[:, r * n:(r + 1) * n].numpy(), 1e-5)


@pytest.mark.parametrize("mode", ["concat", "correlation"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_builders_over_a_range_equal_the_whole_volume(mode, dtype):
    """A volume of planes ``d_start .. d_start + D`` equals those planes of
    the whole volume bit for bit (each rank's range of 4, an interior range
    past the image's width), for the plain builder and the wrapper; its
    closed-form VJP equals the whole volume's with the other planes' upstream
    gradient 0, in f64."""
    rng = np.random.default_rng(3)
    fl, fr = (torch.from_numpy(rng.normal(size=(2, 5, 13, 6)).astype(np.float32)).to(dtype) for _ in range(2))
    plain = cvk.cost_volume_concat_torch if mode == "concat" else cvk.cost_volume_correlation_torch
    wrapper = cvk.cost_volume_concat if mode == "concat" else cvk.cost_volume_correlation
    whole = plain(fl, fr, 16)
    for d_start, planes in ((0, 4), (4, 4), (8, 4), (12, 4), (3, 7), (11, 5)):
        for fn in (plain, wrapper):
            assert torch.equal(fn(fl, fr, planes, d_start), whole[:, d_start:d_start + planes]), (d_start, planes)
    fl64, fr64 = (torch.from_numpy(rng.normal(size=(2, 5, 13, 6))) for _ in range(2))
    for d_start, planes in ((0, 4), (8, 4), (11, 5)):
        a, b = fl64.clone().requires_grad_(True), fr64.clone().requires_grad_(True)
        g = torch.from_numpy(rng.normal(size=(2, planes, 5, 13, 12 if mode == "concat" else 1)))
        plain(a, b, planes, d_start).backward(g)
        a2, b2 = fl64.clone().requires_grad_(True), fr64.clone().requires_grad_(True)
        g_whole = torch.zeros(2, 16, *g.shape[2:], dtype=g.dtype)
        g_whole[:, d_start:d_start + planes] = g
        plain(a2, b2, 16).backward(g_whole)
        np.testing.assert_allclose(a.grad, a2.grad, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(b.grad, b2.grad, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("path", list(PATHS))
def test_sharded_eval_matches_ecm_tpu_and_unsharded(group, path, mesh_name):
    """Each rank's disparity (its data row's pairs) within 1e-3 px of
    ``ecm_tpu``'s eval under the same mesh and of the port in one process;
    its gathered cost map within 1e-4 of the one process's (max|diff| /
    max|ref|); the ranks of one disp group agree bit for bit."""
    data, disp = MESHES[mesh_name]
    batch = group["batch"]
    model = port_model(path, group["models"][jax_kind(path)][1])
    with torch.inference_mode():
        left, right = port_batch(path, batch).values()
        (one_cost,) = model.cost_maps(left, right)
        one_disp = model(left, right)[-1].numpy()
    jax_disp = group["jax"][jax_kind(path), mesh_name]
    np.testing.assert_allclose(group["jax"][jax_kind(path), None], jax_disp, rtol=0, atol=1e-3)
    per = EVAL_B // data
    for r, res in enumerate(group["ranks"]):
        got = res[f"{path}_{mesh_name}"]
        rows = slice((r // disp) * per, (r // disp + 1) * per)
        np.testing.assert_allclose(got["disp"].numpy(), jax_disp[rows], rtol=0, atol=1e-3)
        np.testing.assert_allclose(got["disp"].numpy(), one_disp[rows], rtol=0, atol=1e-3)
        assert_close_rel(got["cost"].numpy(), one_cost[rows].numpy(), 1e-4)
        first = group["ranks"][(r // disp) * disp][f"{path}_{mesh_name}"]
        assert torch.equal(got["disp"], first["disp"])


def test_sharded_eval_traffic(group):
    """The grouped path on ``(1, 4)``: a forward's halo messages a rank are
    the four dres convs' (2 on an interior rank, 1 at an end), each
    hourglass's conv1 and conv3 (1 from below, none on the first rank),
    conv2 and conv4 (as the dres convs), conv5 and conv6 (1 from above, none
    on the last rank) and the classif pair's (as a conv, 2 planes each): 34
    on an interior rank, 17 at either end; the gather brings the other 3
    ranks' slabs of the cost map."""
    for r, res in enumerate(group["ranks"]):
        t = res["stereo_grouped_1x4"]["traffic"]
        assert t["halo_messages"] == (17 if r in (0, RANKS - 1) else 34), (r, t)
        assert t["gather_messages"] == RANKS - 1
        assert t["gather_bytes"] == (RANKS - 1) * EVAL_B * (64 // 4 // RANKS) * (EVAL_H // 4) * (EVAL_W // 4) * 4


def test_evaluate_cli_on_four_ranks_equals_one_process(group, capsys):
    """``evaluate --multihost --mesh-disp 4`` on four CPU ranks: rank 0
    alone prints the mesh and the metrics; EPE and every other metric
    within 1e-3 of ``evaluate`` in one process (``--mesh-disp 1``)."""
    r = group["cli"]
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-4000:])
    assert r.stdout.count("disp-sharded eval mesh: data 1, disp 4") == 1, r.stdout
    sharded = json.loads(r.stdout.strip().splitlines()[-1])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli_evaluate.main([*CLI_ARGS, "--datapath", group["tree"], "--mesh-disp", "1"])
    one = json.loads(out.getvalue().strip().splitlines()[-1])
    assert sharded["num_pairs"] == one["num_pairs"] == 1
    assert np.isfinite(one["epe"])
    for k, v in one.items():
        assert abs(sharded[k] - v) <= 1e-3, (k, sharded[k], v)


def test_indivisible_max_disp_raises():
    """``ECMStereo`` needs (max_disp / 16) % disp == 0, ``ECMBasic``
    (max_disp / 4) % disp == 0: the check runs before any collective."""
    mesh = Mesh(group=None, data=1, rank=0, disp=4)
    left = torch.zeros(1, 32, 64, 3)
    for name, max_disp, rule in (("stackhourglass", 48, "max_disp / 16"), ("basic", 40, "max_disp / 4")):
        model = dataclasses.replace(CONFIGS["middlebury_disp_sharded"].model, name=name, bf16=False).build(
            device="cpu", max_disp=max_disp, feature_channels=8)
        with use_mesh(mesh), pytest.raises(ValueError, match=rule):
            model(left, left)


def test_eval_mesh_and_the_grid_are_checked():
    """Without a process group ``eval_mesh`` of the preset raises
    ``ValueError`` (4 ranks needed, 1 present), as ``make_mesh`` does for a
    grid that is not the group, and so does the training mesh
    (``make_mesh_from``) of a disp axis of 4 over one rank; training under a
    disp mesh checks ``max_disp`` before any collective
    (``test_torch_port_disp_train.py`` trains on four ranks)."""
    cfg = CONFIGS["middlebury_disp_sharded"]
    assert cfg.train.mesh_disp == 4
    with pytest.raises(ValueError, match="needs --multihost with 4 ranks, have 1"):
        cli_common.eval_mesh(cfg)
    assert cli_common.eval_mesh(dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, mesh_disp=1))) is None
    with pytest.raises(ValueError, match="mesh disp=4 with 1 ranks: the disp axis must divide the group"):
        cli_common.make_mesh_from(cfg)
    model = dataclasses.replace(cfg.model, bf16=False).build(device="cpu", max_disp=48, feature_channels=8)
    model.train()
    with use_mesh(Mesh(group=None, data=1, rank=0, disp=4)), pytest.raises(ValueError, match="max_disp / 16"):
        model(torch.zeros(1, 32, 64, 3), torch.zeros(1, 32, 64, 3))


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_make_mesh_grid_on_four_ranks(group, shape):
    """``make_mesh(data, disp)`` over four ranks, row-major (rank = data
    index * disp + disp index): each rank's place, its disp group's global
    ranks, its range of 16 planes, and ``Mesh.sum`` over the data axis only
    (the ranks of a disp group hold the same batch rows)."""
    data, disp = shape
    for r, res in enumerate(group["ranks"]):
        got = res[f"grid_{data}x{disp}"]
        i, j = divmod(r, disp)
        assert (got["data"], got["disp"], got["data_index"], got["disp_index"]) == (data, disp, i, j)
        assert got["disp_ranks"] == [i * disp + k for k in range(disp)]
        assert tuple(got["disp_range"]) == (j * 16 // disp, 16 // disp)
        assert got["data_sum"] == sum(k * disp + j for k in range(data))


@pytest.mark.parametrize("shape", [(3, 2), (1, 3)])
def test_make_mesh_rejects_a_grid_that_is_not_the_group(group, shape):
    """A grid of other than four ranks raises ``ValueError`` on every rank,
    before any subgroup is made."""
    for res in group["ranks"]:
        assert "error" in res[f"grid_{shape[0]}x{shape[1]}"]
