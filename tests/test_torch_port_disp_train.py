"""Training on the port's disparity axis (``ecm_torch.parallel.halo``'s
backward, BatchNorm over data x disp, gradients summed over disp) on the
CPU: four gloo ranks, started once by ``ecm_torch.parallel.dryrun.launch``
(one torch thread a rank, a free localhost port, 240 s for the run and 60 s
for each collective), against ``ecm_tpu``'s train step and against the
port's modules in one process.

- One train step of ``sceneflow_dp`` cut to the CPU (``ECMStereo``,
  max-disp 64, width 8, 32x64, ``remat`` on, a global batch of 2) in f64 on
  both sides, against one compile of ``ecm_tpu``'s ``make_train_step``
  under ``make_mesh(data=2, disp=2)`` + ``use_mesh`` (conftest's fake CPU
  devices), from the same weights (``weights.from_flax``): the port on a
  ``(2, 2)`` grid in the standard layout, the same with
  ``agg_layout="grouped"`` (``gband_conv_s1``'s plain version and its VJP
  on halo-padded slabs), and on a ``(1, 4)`` grid, whose interior ranks take
  halos from both sides and return their gradients both ways. The function
  is the same under every grid, so one reference serves the three. The
  second pair's ground truth is mostly beyond max-disp, so the data rows'
  valid-pixel counts differ. Compared, at the tolerances of the data axis's
  f64 cases (``test_torch_port_parallel.py``; in f32 flax's ``E[x^2] -
  E[x]^2`` variance at the few values an SPP channel holds moves the SPP
  gradients by O(1)): the logged loss and metrics, each rank's three
  predictions, every parameter gradient directly (max|diff| / max|ref| a
  tensor, not a cosine, which is blind to a gradient's scale), the running
  statistics and the parameters after Adam; the four ranks end with the same
  gradients and state bit for bit.
- Each 3D module form of the training forward (``ConvBN`` stride 1 on
  cuDNN's op and on ``gband_conv_s1``, stride 2, ``ConvTransposeBN``,
  ``ClassifHead``) in training on every rank position of ``(1, 4)``
  against the module on the whole volume in one process: the output and
  input-gradient slabs, the parameter gradients summed over the ranks, the
  running statistics on every rank (BatchNorm on the owned planes, its
  statistics over the grid), and the backward's halo traffic.
- ``gather_d``'s backward: each rank's own slice of the gradient, not a sum.
- The rows: under ``(2, 2)`` the train pipelines give the ranks of one disp
  group the same pairs and crops, and the two data rows different ones.
- ``train --multihost --device cpu --mesh-disp 2`` under
  ``torch.distributed.run`` (two ranks, a ``(1, 2)`` grid).
"""

import concurrent.futures
import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecm_tpu.data.synthetic import make_batch
from ecm_tpu.models import build_model as jax_build_model
from ecm_tpu.parallel.sharding import batch_sharding as jax_batch_sharding
from ecm_tpu.parallel.sharding import make_mesh as jax_make_mesh
from ecm_tpu.parallel.sharding import replicate as jax_replicate
from ecm_tpu.parallel.sharding import use_mesh as jax_use_mesh
from ecm_tpu.train.state import TrainState as JaxTrainState
from ecm_tpu.train.state import make_optimizer as jax_make_optimizer
from ecm_tpu.train.steps import make_train_step as jax_make_train_step
from ecm_torch.configs import CONFIGS
from ecm_torch.models.aggregation import ClassifHead
from ecm_torch.models.layers import ConvBN, ConvTransposeBN
from ecm_torch.parallel import dryrun
from ecm_torch.train import checkpoint as ckpt_lib
from ecm_torch.train.state import create_train_state
from ecm_torch.weights import from_flax
from test_torch_port_disp import _module_state
from test_torch_port_parallel import _run_group, heads_bias
from test_torch_port_util import assert_close_rel, flax_variables, torch_threads, write_sceneflow_tree

ROOT = Path(__file__).resolve().parents[1]
RANKS = 4
TIMEOUT = 240  # seconds, the ranks' launch and the CLI run
GROUP_TIMEOUT = 60  # seconds, each collective
LR = 1e-3
PLAIN = dict(use_pallas=False, regress_mode="fullres")
KW = dict(max_disp=64, feature_channels=8, agg_layout="standard", remat=True)
GLOBAL, H, W = 2, 32, 64
# step case -> (mesh, port overrides over KW)
STEPS = {
    "standard_2x2": ((2, 2), {}),
    "grouped_2x2": ((2, 2), dict(agg_layout="grouped")),
    "standard_1x4": ((1, 4), {}),
}
C, FORM_B, FORM_D, FORM_H, FORM_W = 8, 2, 16, 6, 10
# module form -> (module, constructor args, forward keywords, input [B, D, H, W, C])
FORMS = {
    "convbn_s1": (ConvBN, (C, C, 3, 1, 1, True, 3), {}, (FORM_B, FORM_D, FORM_H, FORM_W, C)),
    "convbn_s1_gband": (ConvBN, (2 * C, C, 3, 1, 1, True, 3), dict(gband=True), (FORM_B, FORM_D, FORM_H, FORM_W, 2 * C)),
    "convbn_s2": (ConvBN, (C, 2 * C, 3, 2, 1, True, 3), {}, (FORM_B, FORM_D, FORM_H, FORM_W, C)),
    "deconv": (ConvTransposeBN, (2 * C, C), {}, (FORM_B, FORM_D // 2, FORM_H, FORM_W, 2 * C)),
    "classif_head": (ClassifHead, (C,), {}, (FORM_B, FORM_D, FORM_H, FORM_W, C)),
}
ROWS_PIPELINE = dict(batch_size=4, crop=(16, 32), seed=5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    with torch_threads(1):
        yield


def port_overrides(extra: dict) -> dict:
    return dict(PLAIN, **dict(KW, **extra), dtype=torch.float64)


def port_model(extra: dict | None = None):
    return CONFIGS["sceneflow_dp"].model.build(device="cpu", **port_overrides(extra or {})).double()


def global_batch(seed: int = 9) -> dict:
    """``GLOBAL`` 32x64 pairs; the second pair's ground truth is mostly
    beyond max-disp."""
    batch = make_batch(seed, GLOBAL, h=H, w=W, max_disp=40.0)
    gt = batch["disparity"][1:]
    gt[np.random.default_rng(seed).uniform(size=gt.shape) < 0.7] = 100.0
    return batch


def jax_reference(variables: dict, batch: dict) -> dict:
    """``ecm_tpu``'s train step and training forward on the global batch
    under ``make_mesh(data=2, disp=2)``, in f64: the new state, its metrics,
    the gradients (Adam's first moment after one step is 0.1 times the
    gradient) and the predictions."""
    model = jax_build_model("stackhourglass", **PLAIN, **KW, dtype=jnp.float64)
    mesh = jax_make_mesh(data=2, disp=2)
    forward = jax.jit(lambda v, b: model.apply(v, b["left"], b["right"], train=True, mutable=["batch_stats"])[0])
    state = JaxTrainState.create(apply_fn=model.apply, params=variables["params"],
                                 batch_stats=variables["batch_stats"], tx=jax_make_optimizer(LR))
    with jax_use_mesh(mesh):
        sharded = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()}, jax_batch_sharding(mesh))
        preds = forward(jax.device_put(dict(variables), jax_replicate(mesh)), sharded)
        state, metrics = jax_make_train_step(model, KW["max_disp"])(jax.device_put(state, jax_replicate(mesh)),
                                                                    sharded)
    return dict(
        metrics={k: float(v) for k, v in metrics.items()}, preds=[np.asarray(p) for p in preds],
        grads=jax.tree.map(lambda m: np.asarray(m) / 0.1, state.opt_state[0].mu),
        params=jax.tree.map(np.asarray, state.params), stats=jax.tree.map(np.asarray, state.batch_stats),
    )


def form_cases() -> list[dict]:
    rng = np.random.default_rng(13)
    cases = []
    for name, (cls, args, kwargs, shape) in FORMS.items():
        module = cls(*args)
        x = torch.from_numpy(rng.normal(size=shape))
        with torch.no_grad():
            out_shape = module.double().eval()(x, **kwargs).shape
        cases.append(dict(name=name, kind="slab_train", mesh=(1, RANKS), module=cls.__name__, module_args=args,
                          kwargs=kwargs, state_dict={k: v.double() if v.is_floating_point() else v
                                                     for k, v in _module_state(cls(*args), rng).items()},
                          x=x, dy=torch.from_numpy(rng.normal(size=out_shape))))
    return cases


def gather_case() -> dict:
    rng = np.random.default_rng(17)
    return dict(name="gather_grad", kind="gather_grad", mesh=(1, RANKS),
                x=torch.from_numpy(rng.normal(size=(2, 8, 3, 5))), dy=torch.from_numpy(rng.normal(size=(2, 8, 3, 5))))


# the train preset's crop cut to the tiny tree's 40x64 frames
SHIM = """
import dataclasses, sys
from ecm_torch.configs import CONFIGS
cfg = CONFIGS["sceneflow_single"]
CONFIGS["sceneflow_single"] = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, crop=(32, 64), workers=0))
from ecm_torch.cli import train
train.main(sys.argv[1:])
"""


def run_train_cli(tmp: Path, tree: str):
    """``torch.distributed.run --nproc_per_node 2`` of the train CLI with
    ``--multihost --mesh-disp 2 --device cpu`` (gloo): 2 steps of a global
    batch of 2 at max-disp 32."""
    shim = tmp / "train_shim.py"
    shim.write_text(SHIM)
    return _run_group([
        sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2", "--nnodes", "1",
        "--master_addr", "localhost", "--master_port", str(dryrun.free_port()), str(shim),
        "--multihost", "--mesh-disp", "2", "--device", "cpu", "--dist-timeout", str(GROUP_TIMEOUT),
        "--datapath", tree, "--batch", "2", "--steps", "2", "--savemodel", str(tmp / "ck"), "--maxdisp", "32",
        "--no-bf16",
    ], ROOT)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Every case on four ranks and the CLI on two, while JAX compiles its
    reference."""
    tmp = tmp_path_factory.mktemp("disp_train")
    batch = global_batch()
    sd = port_model().state_dict()
    with jax.enable_x64(True):
        jm = jax_build_model("stackhourglass", **PLAIN, **KW, dtype=jnp.float64)
        variables = flax_variables(jm, jnp.asarray(batch["left"]), jnp.asarray(batch["right"]), seed=9)
        variables = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
    start = from_flax(variables, sd)
    tree = write_sceneflow_tree(tmp / "sf")
    steps = [dict(name=name, kind="step", mesh=mesh, config="sceneflow_dp", overrides=port_overrides(extra),
                  double=True, lr=LR, state_dict=start, batch={k: torch.from_numpy(v) for k, v in batch.items()})
             for name, (mesh, extra) in STEPS.items()]
    rows = dict(name="rows", kind="rows", mesh=(2, 2), tree=tree, pipeline=ROWS_PIPELINE, batches=2)
    cases = [*steps, *form_cases(), gather_case(), rows]
    torch.save(cases, tmp / "cases.pt")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ranks = pool.submit(dryrun.launch, ["--cases", str(tmp / "cases.pt"), "--out", str(tmp),
                                            "--timeout", str(GROUP_TIMEOUT)], RANKS, TIMEOUT)
        cli = pool.submit(run_train_cli, tmp, tree)
        with jax.enable_x64(True):
            ref = jax_reference(variables, batch)
        ranks.result()
        cli = cli.result()
    results = [torch.load(tmp / f"rank{r}.pt", weights_only=True) for r in range(RANKS)]
    return dict(ref=ref, batch=batch, expected=sd, ranks=results, cli=cli, tmp=tmp)


@pytest.mark.parametrize("name", list(STEPS))
def test_disp_ranks_are_replicas(group, name):
    """After the step the four ranks hold the same gradients, parameters,
    statistics and logged metrics, bit for bit: one all-reduce of the
    gradients over the grid and BatchNorm sums over the grid."""
    first, *rest = (r[name] for r in group["ranks"])
    for other in rest:
        assert other["metrics"] == first["metrics"]
        for k, v in first["grads"].items():
            assert torch.equal(other["grads"][k], v), k
        for k, v in first["state"].items():
            assert torch.equal(other["state"][k], v), k


@pytest.mark.parametrize("name", list(STEPS))
def test_disp_step_loss_metrics_and_predictions_match_jax(group, name):
    """The logged loss (the global batch's) and the other metrics at rel
    1e-6, each rank's three predictions (its data row's pairs) at 1e-3 px;
    the halo exchanges of the forward and of the backward ran."""
    ref = group["ref"]
    (data, disp), _ = STEPS[name]
    got = group["ranks"][0][name]
    assert set(got["metrics"]) == set(ref["metrics"])
    for k, v in ref["metrics"].items():
        assert got["metrics"][k] == pytest.approx(v, rel=1e-6, abs=1e-9), k
    counts = [((g > 0) & (g < KW["max_disp"])).sum() for g in group["batch"]["disparity"]]
    assert counts[0] > 2 * counts[1] > 0 and ref["metrics"]["valid_px"] == sum(counts), counts
    per = GLOBAL // data
    for r, res in enumerate(group["ranks"]):
        rows = slice((r // disp) * per, (r // disp + 1) * per)
        preds = res[name]["preds"]
        assert len(preds) == 3
        for p, jp in zip(preds, ref["preds"]):
            np.testing.assert_allclose(p.numpy(), jp[rows], rtol=0, atol=1e-3)
        traffic = res[name]["traffic"]
        assert traffic["halo_messages"] > 0 and traffic["halo_grad_messages"] > 0, traffic
        assert traffic["gather_messages"] == 3 * (disp - 1), traffic


@pytest.mark.parametrize("name", list(STEPS))
def test_disp_step_gradients_match_jax(group, name):
    """Every gradient after the reduction over the grid at max|diff| /
    max|ref| <= 1e-5 a tensor (the data axis's f64 tolerance); the heads'
    conv2 biases below 1e-4 of the largest gradient on both sides. A
    missing sum over disp scales every gradient by 1/disp; a mean over the
    four ranks by 1/2 on ``(2, 2)``."""
    ref, got = group["ref"], group["ranks"][0][name]
    mapped = from_flax({"params": ref["grads"], "batch_stats": ref["stats"]}, group["expected"])
    top = max(g.abs().max().item() for k, g in mapped.items() if k in got["grads"])
    assert set(got["grads"]) == {k for k, _ in port_model().named_parameters()}
    for k, g in got["grads"].items():
        if heads_bias(k):
            assert max(g.abs().max().item(), mapped[k].abs().max().item()) <= 1e-4 * top, k
            continue
        try:
            assert_close_rel(g.numpy(), mapped[k].numpy(), 1e-5)
        except AssertionError as e:
            raise AssertionError(f"{k}: {e}") from None


@pytest.mark.parametrize("name", list(STEPS))
def test_disp_step_batch_stats_and_adam_match_jax(group, name):
    """The running statistics after the step at rel 1e-9 (each 3D
    BatchNorm took the global batch's mean and biased variance over every
    slab once), and the parameters after Adam within lr / 1000 wherever
    JAX's |g| is 1e-6 or more and within 2 lr elsewhere (as the data axis's
    f64 case: below 1e-6 the f32 loss's rounding of g moves a step by a part
    of lr)."""
    ref, got = group["ref"], group["ranks"][0][name]
    mapped = from_flax({"params": ref["params"], "batch_stats": ref["stats"]}, group["expected"])
    stats = [k for k in mapped if k.endswith(("running_mean", "running_var"))]
    assert len(stats) > 20
    for k in stats:
        assert_close_rel(got["state"][k].numpy(), mapped[k].numpy(), 1e-9)
    grads = from_flax({"params": ref["grads"], "batch_stats": ref["stats"]}, group["expected"])
    large = total = 0
    for k, p in got["state"].items():
        if k in stats or k.endswith("num_batches_tracked"):
            continue
        diff, big = (p - mapped[k]).abs().numpy(), grads[k].abs().numpy() >= 1e-6
        assert diff.max() <= 2 * LR, k
        assert diff[big].max(initial=0.0) <= LR / 1000, (k, diff[big].max())
        large, total = large + big.sum(), total + big.size
    assert large > 0.98 * total, (large, total)


def form_reference(case: dict) -> dict:
    """The module in training on the whole volume in one process."""
    cls = {"ConvBN": ConvBN, "ConvTransposeBN": ConvTransposeBN, "ClassifHead": ClassifHead}[case["module"]]
    module = cls(*case["module_args"]).double()
    module.load_state_dict(case["state_dict"])
    module.train()
    x = case["x"].clone().requires_grad_(True)
    y = module(x, **case["kwargs"])
    y.backward(case["dy"])
    return dict(out=y.detach(), dx=x.grad, grads={n: p.grad for n, p in module.named_parameters()},
                state=module.state_dict())


@pytest.mark.parametrize("name", list(FORMS))
def test_module_form_in_training_on_each_rank_matches_unsharded(group, name):
    """Each rank's output and input-gradient slabs (first, two interior and
    last rank) against the same planes of the module on the whole volume,
    the parameter gradients summed over the ranks against the module's, and
    the running statistics on every rank against the module's, all at
    max|diff| / max|ref| <= 1e-12 in f64: BatchNorm normalises the planes
    this rank owns with statistics over the grid, and the halo backward
    returns each received plane's gradient to its owner."""
    case = next(c for c in form_cases() if c["name"] == name)
    ref = form_reference(case)
    d_in, d_out = case["x"].shape[1] // RANKS, ref["out"].shape[1] // RANKS
    ranks = [res[name] for res in group["ranks"]]
    for r, got in enumerate(ranks):
        assert_close_rel(got["out"].numpy(), ref["out"][:, r * d_out:(r + 1) * d_out].numpy(), 1e-12)
        assert_close_rel(got["dx"].numpy(), ref["dx"][:, r * d_in:(r + 1) * d_in].numpy(), 1e-12)
        for k, v in ref["state"].items():
            if k.endswith(("running_mean", "running_var")):
                assert_close_rel(got["state"][k].numpy(), v.numpy(), 1e-12)
    for k, g in ref["grads"].items():
        assert_close_rel(sum(got["grads"][k] for got in ranks).numpy(), g.numpy(), 1e-12)


def test_halo_backward_traffic(group):
    """The backward returns a gradient for every plane a rank sent: on
    ``(1, 4)`` a stride-1 conv's interior ranks receive 2 gradient messages
    and the end ranks 1, as in the forward, with the same bytes; over the
    ranks the backward's messages and bytes equal the forward's for every
    form."""
    s1 = [res["convbn_s1"]["traffic"] for res in group["ranks"]]
    for r, t in enumerate(s1):
        assert t["halo_messages"] == t["halo_grad_messages"] == (1 if r in (0, RANKS - 1) else 2), (r, t)
        assert t["halo_bytes"] == t["halo_grad_bytes"], (r, t)
    for name in FORMS:
        ts = [res[name]["traffic"] for res in group["ranks"]]
        for kind in ("messages", "bytes"):
            assert sum(t[f"halo_{kind}"] for t in ts) == sum(t[f"halo_grad_{kind}"] for t in ts) > 0, (name, ts)


def test_gather_d_backward_keeps_this_ranks_slice(group):
    """``gather_d`` gives every rank the whole tensor, and its backward
    each rank its own slice of the incoming gradient, bit for bit: every
    rank computes the loss from the whole map, so a sum over the group
    would count it ``disp`` times."""
    case = gather_case()
    per = case["x"].shape[1] // RANKS
    for r, res in enumerate(group["ranks"]):
        got = res["gather_grad"]
        assert torch.equal(got["out"], case["x"])
        assert torch.equal(got["dx"], case["dy"][:, r * per:(r + 1) * per])


def test_train_pipelines_give_a_disp_group_the_same_rows(group):
    """Under ``(2, 2)`` the SceneFlow and synthetic pipelines give ranks 0
    and 1 (one disp group) the same pairs and crops, ranks 2 and 3 theirs,
    and the two data rows different ones."""
    ranks = [res["rows"] for res in group["ranks"]]
    for kind in ("sceneflow", "synthetic"):
        for i, batch in enumerate(ranks[0][kind]):
            assert batch["left"].shape[0] == ROWS_PIPELINE["batch_size"] // 2
            for a, b in ((0, 1), (2, 3)):
                for k, v in ranks[a][kind][i].items():
                    assert torch.equal(v, ranks[b][kind][i][k]), (kind, i, a, b, k)
            assert not torch.equal(batch["left"], ranks[2][kind][i]["left"]), (kind, i)


def test_train_cli_on_the_disparity_axis(group):
    """``train --multihost --mesh-disp 2`` on two CPU ranks: rank 0 alone
    prints the ``(1, 2)`` mesh and writes the JSONL and the checkpoint, the
    loss is finite, and the checkpoint restores into one process."""
    r, ck = group["cli"], group["tmp"] / "ck"
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-4000:])
    assert r.stdout.count("training mesh: data 1, disp 2") == 1, r.stdout
    assert r.stdout.count("done at step 2") == 1, r.stdout
    manager = ckpt_lib.make_manager(str(ck))
    assert manager.all_steps() == [2]
    (line,) = (ck / "metrics.jsonl").read_text().splitlines()
    assert json.loads(line)["step"] == 2 and np.isfinite(json.loads(line)["loss"])
    model = dataclasses.replace(CONFIGS["sceneflow_single"].model, max_disp=32, bf16=False).build(device="cpu")
    state, step = ckpt_lib.restore_latest(manager, create_train_state(model))
    assert step == 2 and state.optimizer.count == 2
