"""The port's data axis (``ecm_torch.parallel``) on the CPU: ranks over gloo,
started as subprocesses by ``ecm_torch.parallel.dryrun.launch`` (or
``torch.distributed.run`` for the CLI), one torch thread a rank, a free
localhost port, 240 s for each run and 60 s for each process group's
collectives.

- One train step of the ranks against ``ecm_tpu``'s train step on the
  global batch of 4 pairs under ``make_mesh(data=2)`` + ``use_mesh``
  (conftest's fake CPU devices), from the same weights
  (``weights.from_flax``), ``remat`` on: (a) 2 ranks of 2 pairs, (b) 4
  ranks of 1 pair, where each SPP branch's BatchNorm holds one value a
  channel on a rank and four in the global batch; the last rank's
  valid-pixel count is under half the first's. One global shape lets one
  JAX compile (about 40 s here) serve both. Compared: the logged loss and
  metrics, each rank's predictions, every gradient, the BatchNorm running
  statistics and the parameters after Adam. Both sides run in f64: in f32
  flax's ``E[x^2] - E[x]^2`` variance over the two to four values an SPP
  channel holds at 32x32 moves the branch gradients by O(1) (one process
  at batch 2: 1.3 max|diff|/max|ref|), so f32 says nothing about the
  collectives. With per-rank loss means or per-rank BatchNorm these cases
  fail.
- Synced BatchNorm alone against one process on the concatenated input,
  forward and backward, including a local count of 1.
- ``train_loop`` over the two ranks: pairs/s counts both ranks' pairs, rank
  0 alone writes the JSONL and the checkpoints, and a two-rank checkpoint
  restored into one process steps to the two ranks' next state.
- The train CLI under ``torch.distributed.run`` with ``--multihost --device
  cpu``, and the dry run (``dryrun_multichip``'s counterpart).
"""

import concurrent.futures
import dataclasses
import itertools
import json
import os
import signal
import subprocess
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
from ecm_torch.models.layers import BatchNorm2d, BatchNorm3d
from ecm_torch.parallel import dryrun, make_mesh
from ecm_torch.train import checkpoint as ckpt_lib
from ecm_torch.train.loop import train_loop
from ecm_torch.train.state import create_train_state, make_optimizer
from ecm_torch.train.steps import make_train_step
from ecm_torch.weights import from_flax
from test_torch_port_util import assert_close_rel, flax_variables, torch_threads, write_sceneflow_tree

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 240  # seconds, each launch of ranks and the CLI run
GROUP_TIMEOUT = 60  # seconds, each rank's process group (each collective)
LR = 1e-3
PLAIN = dict(use_pallas=False, regress_mode="fullres")
KW = dict(max_disp=16, feature_channels=8, agg_layout="standard", remat=True)
# the port's side: the sceneflow_dp preset cut to the CPU size, in f64
OVERRIDES = dict(PLAIN, **KW, dtype=torch.float64)
# case -> (ranks, pairs a rank, seed); one global batch of 4 32x32 pairs,
# so that one JAX compile serves both
CASES = {"a_two_pairs_a_rank": (2, 2, 7), "b_one_pair_a_rank": (4, 1, 8)}
GLOBAL = 4
# train_loop's synthetic batches: 2 pairs a rank
LOOP_PIPELINE = dict(batch_size=4, crop=None, seed=3, h=32, w=32, max_disp=12.0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    with torch_threads(1):
        yield


def run_ranks(tmp: Path, ranks: int, cases: list[dict]) -> list[dict]:
    """Every case on each of ``ranks`` ranks; their results, rank by rank."""
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save(cases, tmp / "cases.pt")
    dryrun.launch(["--cases", str(tmp / "cases.pt"), "--out", str(tmp), "--timeout", str(GROUP_TIMEOUT)], ranks,
                  TIMEOUT)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=True) for r in range(ranks)]


def global_batch(per_rank: int, seed: int) -> dict:
    """``GLOBAL`` 32x32 pairs; the last rank's ground truth is mostly beyond
    max-disp, so the ranks' valid-pixel counts differ."""
    batch = make_batch(seed, GLOBAL, h=32, w=32, max_disp=12.0)
    rng = np.random.default_rng(seed)
    gt = batch["disparity"][-per_rank:]
    gt[rng.uniform(size=gt.shape) < 0.7] = 20.0
    return batch


def port_model():
    return CONFIGS["sceneflow_dp"].model.build(device="cpu", **OVERRIDES).double()


class JaxStep:
    """``ecm_tpu``'s train step on the global batch under ``make_mesh(data=2)``
    and ``use_mesh``, compiled once for every case: the new state, its
    metrics, the gradients (Adam's first moment after one step is 0.1 times
    the gradient) and the predictions of the training forward."""

    def __init__(self):
        self.model = jax_build_model("stackhourglass", **PLAIN, **KW, dtype=jnp.float64)
        self.mesh = jax_make_mesh(data=2, disp=1)
        self.step = jax_make_train_step(self.model, KW["max_disp"])
        self.forward = jax.jit(
            lambda v, b: self.model.apply(v, b["left"], b["right"], train=True, mutable=["batch_stats"])[0]
        )

    def __call__(self, variables: dict, batch: dict) -> dict:
        state = JaxTrainState.create(apply_fn=self.model.apply, params=variables["params"],
                                     batch_stats=variables["batch_stats"], tx=jax_make_optimizer(LR))
        with jax_use_mesh(self.mesh):
            sharded = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()}, jax_batch_sharding(self.mesh))
            preds = self.forward(jax.device_put(dict(variables), jax_replicate(self.mesh)), sharded)
            state, metrics = self.step(jax.device_put(state, jax_replicate(self.mesh)), sharded)
        return dict(
            metrics={k: float(v) for k, v in metrics.items()}, preds=[np.asarray(p) for p in preds],
            grads=jax.tree.map(lambda m: np.asarray(m) / 0.1, state.opt_state[0].mu),
            params=jax.tree.map(np.asarray, state.params), stats=jax.tree.map(np.asarray, state.batch_stats),
        )


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Both cases through both packages; the BatchNorm, train_loop and dry-run
    cases on the two ranks. The ranks run while JAX compiles."""
    tmp = tmp_path_factory.mktemp("parallel")
    sd = port_model().state_dict()
    setups = {}
    with jax.enable_x64(True):
        jm = jax_build_model("stackhourglass", **PLAIN, **KW, dtype=jnp.float64)
        for name, (_, per_rank, seed) in CASES.items():
            batch = global_batch(per_rank, seed)
            variables = flax_variables(jm, jnp.asarray(batch["left"]), jnp.asarray(batch["right"]), seed=seed)
            variables = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
            setups[name] = dict(batch=batch, variables=variables, start=from_flax(variables, sd), expected=sd)
    launches = {ranks: [] for ranks, _, _ in CASES.values()}
    for name, (ranks, _, _) in CASES.items():
        launches[ranks].append(dict(
            name=name, kind="step", config="sceneflow_dp", overrides=OVERRIDES, double=True, lr=LR,
            state_dict=setups[name]["start"], batch={k: torch.from_numpy(v) for k, v in setups[name]["batch"].items()},
        ))
    loop = dict(name="loop", kind="loop", config="sceneflow_dp", overrides=OVERRIDES, double=True,
                pipeline=LOOP_PIPELINE, steps=[2, 3], ckpt_every=2, ckpt_dir=str(tmp / "ck"),
                metrics_path=str(tmp / "metrics.jsonl"))
    launches[2] += [*bn_cases(), loop, dict(name="dryrun", kind="dryrun")]
    with concurrent.futures.ThreadPoolExecutor(len(launches) + 1) as pool:
        running = {r: pool.submit(run_ranks, tmp / f"ranks{r}", r, cases) for r, cases in launches.items()}
        cli = pool.submit(run_train_cli, tmp / "cli")
        with jax.enable_x64(True):
            jax_step = JaxStep()
            refs = {name: dict(setup, **jax_step(setup["variables"], setup["batch"])) for name, setup in setups.items()}
        results = {r: f.result() for r, f in running.items()}
        cli = cli.result()
    return dict(refs=refs, ranks={name: results[r] for name, (r, _, _) in CASES.items()}, two=results[2], tmp=tmp,
                cli=cli)


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_are_replicas(group, name):
    """After the step every rank holds the same parameters, statistics and
    logged metrics, bit for bit: the gradients and statistics they used are
    the same reductions."""
    first, *rest = (r[name] for r in group["ranks"][name])
    for other in rest:
        assert other["metrics"] == first["metrics"]
        for k, v in first["state"].items():
            assert torch.equal(other["state"][k], v), k


@pytest.mark.parametrize("name", list(CASES))
def test_step_loss_metrics_and_predictions_match_jax(group, name):
    """The logged loss (the global batch's) at rel 1e-6, the other metrics
    at rel 1e-6, each rank's three predictions at 1e-3 px."""
    ref, ranks = group["refs"][name], group["ranks"][name]
    got = ranks[0][name]
    assert abs(got["metrics"]["loss"] - ref["metrics"]["loss"]) <= 1e-6 * abs(ref["metrics"]["loss"])
    assert set(got["metrics"]) == set(ref["metrics"])
    for k, v in ref["metrics"].items():
        assert got["metrics"][k] == pytest.approx(v, rel=1e-6, abs=1e-9), k
    n_ranks, per_rank, _ = CASES[name]
    counts = [((g > 0) & (g < KW["max_disp"])).sum() for g in np.split(ref["batch"]["disparity"], n_ranks)]
    assert counts[0] > 2 * counts[-1] > 0 and ref["metrics"]["valid_px"] == sum(counts), counts
    for r in range(n_ranks):
        rows = slice(r * per_rank, (r + 1) * per_rank)
        preds = ranks[r][name]["preds"]
        assert len(preds) == 3
        for p, jp in zip(preds, ref["preds"]):
            np.testing.assert_allclose(p.numpy(), jp[rows], rtol=0, atol=1e-3)


def heads_bias(k: str) -> bool:
    """The heads' conv2 biases shift a cost map uniformly over D, which the
    soft-argmin ignores: their exact gradient is 0."""
    return "classif" in k and k.endswith("conv2.bias")


@pytest.mark.parametrize("name", list(CASES))
def test_step_gradients_match_jax(group, name):
    """Every gradient after DDP's reduction at max|diff|/max|ref| <= 1e-5
    per tensor (the f64 case of ``test_torch_port_train_loop.py``); the heads'
    conv2 biases below 1e-4 of the largest gradient on both sides."""
    ref, got = group["refs"][name], group["ranks"][name][0][name]
    mapped = from_flax({"params": ref["grads"], "batch_stats": ref["stats"]}, ref["expected"])
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


@pytest.mark.parametrize("name", list(CASES))
def test_step_batch_stats_and_adam_match_jax(group, name):
    """The running statistics after the step at rel 1e-9 (every BatchNorm
    took the global batch's mean and biased variance once), and the
    parameters after Adam: the first step moves a parameter by
    lr g / (|g| + 1e-8), about lr where JAX's |g| is 1e-6 or more, and there
    the two packages agree within lr / 1000 (a wrong reduction flips about
    half the signs). Below 1e-6 the f32 loss's rounding of g moves the
    step by a part of lr, so those entries are held only to 2 lr."""
    ref, got = group["refs"][name], group["ranks"][name][0][name]
    mapped = from_flax({"params": ref["params"], "batch_stats": ref["stats"]}, ref["expected"])
    stats = [k for k in mapped if k.endswith(("running_mean", "running_var"))]
    assert len(stats) > 20
    for k in stats:
        assert_close_rel(got["state"][k].numpy(), mapped[k].numpy(), 1e-9)
    grads = from_flax({"params": ref["grads"], "batch_stats": ref["stats"]}, ref["expected"])
    large = total = 0
    for k, p in got["state"].items():
        if k in stats or k.endswith("num_batches_tracked"):
            continue
        diff, big = (p - mapped[k]).abs().numpy(), grads[k].abs().numpy() >= 1e-6
        assert diff.max() <= 2 * LR, k
        assert diff[big].max(initial=0.0) <= LR / 1000, (k, diff[big].max())
        large, total = large + big.sum(), total + big.size
    assert large > 0.98 * total, (large, total)  # 99.2 % here


# the BatchNorm cases on two ranks: (name, ndim, global input shape); the
# first holds one value a channel on each rank, two in the global batch
BN_CASES = [("bn2d_one_value_a_rank", 2, (2, 5, 1, 1)), ("bn2d", 2, (4, 6, 3, 5)), ("bn3d", 3, (2, 4, 3, 2, 5))]


def bn_cases() -> list[dict]:
    rng = np.random.default_rng(4)
    cases = []
    for name, ndim, shape in BN_CASES:
        c = shape[1]
        sd = {"weight": rng.uniform(0.5, 1.5, c), "bias": rng.normal(0, 0.3, c),
              "running_mean": rng.normal(0, 0.3, c), "running_var": rng.uniform(0.5, 2.0, c)}
        sd = {k: torch.from_numpy(v) for k, v in sd.items()}
        sd["num_batches_tracked"] = torch.tensor(0)
        cases.append(dict(name=name, kind="bn", ndim=ndim, state_dict=sd,
                          x=torch.from_numpy(rng.normal(1.0, 2.0, shape)),
                          dy=torch.from_numpy(rng.normal(0, 1, shape))))
    return cases


@pytest.mark.parametrize("name", [c[0] for c in BN_CASES])
def test_synced_batchnorm_equals_one_process(group, name):
    """Each rank's output and input gradient equal one BatchNorm's over the
    concatenated batch at rel 1e-12 (abs 1e-14: f64 rounding of O(1) terms
    where a value is near 0), the ranks' weight and bias gradients sum to
    its, and the running statistics equal its on both ranks (flax's fold of
    the biased variance)."""
    ranks = group["two"]
    case = next(c for c in bn_cases() if c["name"] == name)
    bn = (BatchNorm2d if case["ndim"] == 2 else BatchNorm3d)(case["x"].shape[1]).double()
    bn.load_state_dict(case["state_dict"])
    bn.train()
    x = case["x"].clone().requires_grad_(True)
    y = bn(x)
    y.backward(case["dy"])
    n = x.shape[0] // 2
    close = dict(rtol=1e-12, atol=1e-14)
    for r in range(2):
        got = ranks[r][name]
        np.testing.assert_allclose(got["y"], y.detach()[r * n:(r + 1) * n], **close)
        np.testing.assert_allclose(got["dx"], x.grad[r * n:(r + 1) * n], **close)
        for k, v in bn.state_dict().items():
            np.testing.assert_allclose(got["state"][k], v, **close, err_msg=k)
    for g in ("weight", "bias"):
        total = sum(ranks[r][name][f"{g}_grad"] for r in range(2))
        np.testing.assert_allclose(total, getattr(bn, g).grad, **close, err_msg=g)


def test_train_loop_over_two_ranks_and_resume_in_one_process(group):
    """``train_loop`` over the two ranks, 2 steps with a checkpoint, then on
    to step 3: one JSONL line a step (rank 0 alone writes) whose pairs/s
    counts both ranks' pairs, checkpoints 2 and 3 with no ``module.``
    prefix, both ranks on the same state; checkpoint 2 restored into one
    process steps on the global batch of step 3 to checkpoint 3's
    parameters at 1e-7 of each tensor's largest value (the heads' conv2
    biases within 2 lr)."""
    pipe, ranks = LOOP_PIPELINE, group["two"]
    ck, jsonl = group["tmp"] / "ck", group["tmp"] / "metrics.jsonl"
    assert ranks[0]["loop"]["step"] == ranks[1]["loop"]["step"] == 3
    for k, v in ranks[0]["loop"]["state"].items():
        assert torch.equal(v, ranks[1]["loop"]["state"][k]), k
    lines = [json.loads(s) for s in jsonl.read_text().splitlines()]
    assert [m["step"] for m in lines] == [1, 2, 3]
    for m in lines:  # log_every 1: the window is one step of 2 ranks x 2 pairs
        assert m["pairs_per_s"] * m["step_time_ms"] / 1e3 == pytest.approx(4.0, rel=1e-9)
    manager = ckpt_lib.make_manager(str(ck))
    assert manager.all_steps() == [2, 3]
    blob = torch.load(manager.path(2), weights_only=True)
    assert not any(k.startswith("module.") for k in blob["model"])

    model = port_model()
    state = create_train_state(model, make_optimizer(LR))
    state, step0 = ckpt_lib.restore_latest(_only(manager, 2), state)
    assert step0 == 2 and state.step == 2 and state.optimizer.count == 2
    seeds = [(pipe["seed"], r, 2).__hash__() & 0x7FFFFFFF for r in range(2)]
    parts = [make_batch(s, pipe["batch_size"] // 2, pipe["h"], pipe["w"], pipe["max_disp"]) for s in seeds]
    batch = {k: torch.from_numpy(np.concatenate([p[k] for p in parts])) for k in parts[0]}
    state, _ = make_train_step(model, KW["max_disp"])(state, batch)
    assert state.step == 3
    want = torch.load(manager.path(3), weights_only=True)["model"]
    for k, p in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            assert p.item() == want[k].item(), k
        elif heads_bias(k):
            assert (p - want[k]).abs().max().item() <= 2 * LR, k
        else:
            assert_close_rel(p.numpy(), want[k].numpy(), 1e-7)


def test_from_flax_keeps_every_shape(group):
    """``weights.from_flax`` returns each tensor at its module tensor's
    shape: a BatchNorm's 0-d ``num_batches_tracked`` stays 0-d (it came
    back 1-d, which ``load_state_dict`` accepts only as a legacy case)."""
    ref = group["refs"]["a_two_pairs_a_rank"]
    for k, v in ref["start"].items():
        assert v.shape == ref["expected"][k].shape, k


class _only:
    """A checkpoint manager that sees only one of ``manager``'s steps."""

    def __init__(self, manager, step):
        self.manager, self.step = manager, step

    def latest_step(self):
        return self.step

    def path(self, step):
        return self.manager.path(step)


class _FakeMesh:
    def __init__(self, rank):
        self.data, self.rank, self.barriers = 2, rank, 0

    def barrier(self):
        self.barriers += 1


def _counting_step(state, batch):
    state.step += 1
    zero = torch.zeros(())
    return state, {"loss": zero, "epe": zero, "d1_all": zero}


@pytest.mark.parametrize("rank", [0, 1])
def test_train_loop_writes_on_rank_0_only(tmp_path, capsys, rank):
    """``train_loop`` with a mesh: rank 0 alone prints and writes the JSONL
    and the checkpoints (2 and the end, 3), and every rank passes one
    barrier a checkpoint."""
    mesh = _FakeMesh(rank)
    manager = ckpt_lib.make_manager(str(tmp_path / "ck"))
    batch = {k: np.zeros((1, 4, 4, 3) if k != "disparity" else (1, 4, 4), np.float32)
             for k in ("left", "right", "disparity")}
    train_loop(create_train_state(torch.nn.Linear(2, 2)), _counting_step, itertools.repeat(batch), 3, mesh=mesh,
               log_every=1, ckpt_manager=manager, ckpt_every=2, metrics_path=str(tmp_path / "m.jsonl"))
    assert mesh.barriers == 2
    assert manager.all_steps() == ([2, 3] if rank == 0 else [])
    assert (tmp_path / "m.jsonl").exists() == (rank == 0)
    assert ("step 3/3" in capsys.readouterr().out) == (rank == 0)


def _run_group(cmd: list[str], cwd: Path) -> subprocess.CompletedProcess:
    """``cmd`` in a session of its own, killed whole after ``TIMEOUT``."""
    p = subprocess.Popen(cmd, cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         start_new_session=True, env={**os.environ, "PYTHONPATH": str(ROOT)})
    try:
        out, err = p.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise
    return subprocess.CompletedProcess(cmd, p.returncode, out, err)


# the train preset's crop cut to the tiny tree's 40x64 frames, as
# test_torch_port_cli.py cuts it in-process
SHIM = """
import dataclasses, sys
from ecm_torch.configs import CONFIGS
cfg = CONFIGS["sceneflow_single"]
CONFIGS["sceneflow_single"] = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, crop=(32, 64), workers=0))
from ecm_torch.cli import train
train.main(sys.argv[1:])
"""


def run_train_cli(tmp: Path) -> dict:
    """``python -m torch.distributed.run --nproc_per_node 2`` of the train
    CLI with ``--multihost --device cpu`` (gloo): 2 steps of a global batch
    of 4 on the tiny SceneFlow tree."""
    tree = write_sceneflow_tree(tmp / "sf")
    shim = tmp / "train_shim.py"
    shim.write_text(SHIM)
    ck = tmp / "ck"
    run = _run_group([
        sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2", "--nnodes", "1",
        "--master_addr", "localhost", "--master_port", str(dryrun.free_port()), str(shim),
        "--multihost", "--device", "cpu", "--dist-timeout", str(GROUP_TIMEOUT), "--datapath", tree, "--batch", "4",
        "--steps", "2", "--savemodel", str(ck), "--maxdisp", "16", "--no-bf16",
    ], ROOT)
    return dict(run=run, ck=ck)


def test_train_cli_multihost_two_ranks(group):
    """The train CLI on two ranks (``run_train_cli``): rank 0 alone prints
    and writes, the pairs/s of its log line count both ranks' pairs, and the
    checkpoint restores into one process."""
    r, ck = group["cli"]["run"], group["cli"]["ck"]
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-4000:])
    assert r.stdout.count("multihost: 2 ranks, backend gloo, rank 0 on cpu") == 1, r.stdout
    assert r.stdout.count("done at step 2") == 1, r.stdout
    manager = ckpt_lib.make_manager(str(ck))
    assert manager.all_steps() == [2]
    (line,) = (ck / "metrics.jsonl").read_text().splitlines()
    m = json.loads(line)
    log_every = CONFIGS["sceneflow_single"].train.log_every
    assert m["step"] == 2 and np.isfinite(m["loss"])
    assert m["pairs_per_s"] * m["step_time_ms"] * log_every / 1e3 == pytest.approx(2 * 4, rel=1e-9)
    cfg = CONFIGS["sceneflow_single"]
    model = dataclasses.replace(cfg.model, max_disp=16, bf16=False).build(device="cpu")
    state, step = ckpt_lib.restore_latest(manager, create_train_state(model))
    assert step == 2 and state.optimizer.count == 2


def test_dryrun_two_ranks_matches_one_process(group):
    """``ecm_torch.parallel.dryrun``'s check on two CPU ranks: the group's
    loss and updated-parameter norm equal one process's step on the global
    batch (rank 0 asserts it at ``dryrun_multichip``'s tolerances)."""
    record = group["two"][0]["dryrun"]
    assert group["two"][1]["dryrun"] is None
    assert record["ranks"] == 2 and np.isfinite(record["loss"])
    assert abs(record["loss"] - record["loss_one_process"]) <= 1e-3 * max(1.0, abs(record["loss_one_process"]))


def test_make_mesh_needs_a_group_and_takes_every_rank():
    """Without a process group ``make_mesh`` raises, on either axis (the
    grids of four ranks, and a grid that is not the group, are held in
    ``test_torch_port_disp.py``)."""
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(disp=2)
