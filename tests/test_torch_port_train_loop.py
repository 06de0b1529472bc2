"""The rest of the port's training slice against ``ecm_tpu.train`` on the
CPU (split from ``test_torch_port_train.py``, whose whole-step cases at f32
stay there): one whole train step in f64 where the SPP branches pool to
several values and ReLUs sit at their kinks, ``remat`` against no
``remat``, the port's synthetic generator and ``normalize`` against the JAX
package's value for value, the loss and metrics, the optimizer against
optax, and the trainer end to end."""

import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ecm_tpu.data.preprocess import normalize as jax_normalize
from ecm_tpu.data.synthetic import make_batch
from ecm_tpu.models import build_model as jax_build_model
from ecm_tpu.train.loss import stereo_loss as jax_stereo_loss
from ecm_tpu.train.metrics import disparity_metrics as jax_disparity_metrics
from ecm_tpu.train.state import make_optimizer as jax_make_optimizer
from ecm_torch.data import make_batch as port_make_batch
from ecm_torch.data import normalize as port_normalize
from ecm_torch.models import build_model
from ecm_torch.ops.cuda_cost_volume import cost_volume_concat
from ecm_torch.ops.cuda_gband import conv3d_bn_s1, gband_conv_s1
from ecm_torch.ops.cuda_regression import fused_upsample_softargmin
from ecm_torch.train.loop import train_loop
from ecm_torch.train.loss import stereo_loss
from ecm_torch.train.metrics import disparity_metrics
from ecm_torch.train.state import Optimizer, create_train_state, make_optimizer
from ecm_torch.train.steps import make_eval_step, make_infer_fn, make_train_step
from ecm_torch.weights import from_flax, load_flax
from test_torch_port_util import (
    assert_close_rel,
    assert_grads_match,
    assert_stats_match,
    flax_variables,
    jax_train_grads,
    t,
    torch_threads,
    torch_train_grads,
)

PLAIN = dict(use_pallas=False, regress_mode="fullres")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six loaded test processes share the cores (``torch_threads``)."""
    with torch_threads(1):
        yield


def test_train_step_f64_spp_and_relu_match_jax():
    """The cases above in f64 on both sides (``jax.enable_x64``), standard
    layout at width 8, two 64x64 pairs and BatchNorm shifts around 0: every
    SPP branch pools to 2 or more values per channel and ReLUs sit at their
    kinks. Readings over seeds 7 and 8 and shifts around 0 and in [1, 2]:
    loss rel <= 3.1e-7, gradients max|diff|/max|ref| <= 4.6e-7 per tensor,
    running statistics rel <= 2e-12; the f32 regression and loss set that
    floor. Held at loss rel 1e-6, gradients 1e-5 and statistics 1e-9."""
    kw = dict(max_disp=16, feature_channels=8, agg_layout="standard", remat=False)
    batch = make_batch(7, 2, h=64, w=64, max_disp=12.0)
    with jax.enable_x64(True):
        jm = jax_build_model("stackhourglass", **PLAIN, **kw, dtype=jnp.float64)
        variables = flax_variables(jm, jnp.asarray(batch["left"]), jnp.asarray(batch["right"]))
        variables = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
        j_loss, _, j_grads, j_stats = jax_train_grads(
            jm, variables, {k: np.asarray(v, np.float64) for k, v in batch.items()}, 16
        )
    tm = build_model("stackhourglass", device="cpu", **PLAIN, **kw, dtype=torch.float64).double()
    load_flax(tm, variables)
    loss, _, grads, sd = torch_train_grads(tm, batch, 16)
    assert abs(loss - j_loss) <= 1e-6 * abs(j_loss), (loss, j_loss)
    mapped = from_flax({"params": j_grads, "batch_stats": j_stats}, sd)
    assert all(g.dtype == torch.float64 for g in grads.values())
    top = max(g.abs().max().item() for g in mapped.values() if g.is_floating_point())
    spp = [k for k in grads if ".branch" in k and k.endswith("conv.conv.weight")]
    assert len(spp) == 4
    for k in spp:  # a real gradient in every branch, not 0 == 0
        assert mapped[k].abs().max().item() > 1e-3 * top, k
    assert_grads_match(grads, mapped, 1e-5)
    assert_stats_match(sd, mapped, 1e-9)


@pytest.mark.parametrize("name", ["stackhourglass", "basic"])
def test_remat_equals_no_remat(name):
    """``remat=True`` (each hourglass or residual block checkpointed) gives
    the same loss, gradients and running statistics as ``remat=False``, and
    every BatchNorm counts one update: the recomputation updates nothing."""
    batch = make_batch(8, 1, h=32, w=64, max_disp=12.0)
    kw = dict(max_disp=64 if name == "stackhourglass" else 16, feature_channels=8, **PLAIN)
    if name == "stackhourglass":
        kw["agg_layout"] = "grouped"
    runs = {}
    for remat in (False, True):
        m = build_model(name, device="cpu", remat=remat, **kw)
        runs[remat] = torch_train_grads(m, batch, kw["max_disp"])
    (l0, _, g0, s0), (l1, _, g1, s1) = runs[False], runs[True]
    assert abs(l0 - l1) <= 1e-6 * abs(l0)
    for k in g0:
        assert_close_rel(g1[k].numpy(), g0[k].numpy(), 1e-5)
    for k in s0:
        if k.endswith("num_batches_tracked"):
            # the siamese feature extractor runs twice a step
            assert s1[k].item() == s0[k].item() == (2 if k.startswith("feature.") else 1), k
        else:
            assert_close_rel(s1[k].numpy(), s0[k].numpy(), 1e-6)


@pytest.mark.parametrize(
    "seed,n,h,w,max_disp",
    [(0, 1, 32, 64, 12.0), (3, 2, 24, 40, 40.0), (11, 3, 16, 96, 191.0), (5, 1, 17, 23, 7.5)],
)
def test_synthetic_batch_equals_jax_package(seed, n, h, w, max_disp):
    """``ecm_torch.data.make_batch`` equals ``ecm_tpu.data.synthetic.make_batch``
    seed for seed: the same keys, dtypes and values, bit for bit."""
    ours, ref = port_make_batch(seed, n, h=h, w=w, max_disp=max_disp), make_batch(seed, n, h=h, w=w, max_disp=max_disp)
    assert set(ours) == set(ref) == {"left", "right", "disparity"}
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and ours[k].shape == ref[k].shape, k
        assert np.array_equal(ours[k], ref[k]), k
    assert ours["left"].shape == (n, h, w, 3)


@pytest.mark.parametrize(
    "shape,dtype", [((5, 7, 3), np.uint8), ((5, 7), np.uint8), ((4, 6, 4), np.uint8), ((3, 8, 3), np.float32)]
)
def test_normalize_equals_jax_package(shape, dtype):
    """``ecm_torch.data.normalize`` equals ``ecm_tpu.data.preprocess.normalize``
    bit for bit on RGB, grey and RGBA uint8 and on [0, 255] float input."""
    img = np.random.default_rng(12).uniform(0, 255, shape).astype(dtype)
    ours, ref = port_normalize(img), jax_normalize(img)
    assert ours.dtype == ref.dtype == np.float32 and ours.shape == ref.shape == shape[:2] + (3,)
    assert np.array_equal(ours, ref)


@pytest.mark.parametrize("n_preds", [1, 3])
@pytest.mark.parametrize("valid", [True, False], ids=["valid", "no_valid_px"])
def test_loss_and_metrics_match_jax(n_preds, valid):
    """``stereo_loss`` and ``disparity_metrics`` against ``ecm_tpu.train``
    at rel 1e-6, including a batch with no valid pixel (gt 0 or >= max)."""
    rng = np.random.default_rng(9)
    gt = rng.uniform(0, 20, (2, 6, 7)).astype(np.float32)
    if not valid:
        gt[...] = np.where(gt < 10, 0.0, 16.0)
    preds = [(gt + rng.normal(0, 3, gt.shape)).astype(np.float32) for _ in range(n_preds)]
    j = float(jax_stereo_loss([jnp.asarray(p) for p in preds], jnp.asarray(gt), 16))
    loss = stereo_loss([t(p) for p in preds], t(gt), 16).item()
    assert abs(loss - j) <= 1e-6 * max(abs(j), 1e-6)
    jm = jax_disparity_metrics(jnp.asarray(preds[-1]), jnp.asarray(gt), 16)
    m = disparity_metrics(t(preds[-1]), t(gt), 16)
    assert set(m) == set(jm)
    for k in m:
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-6, atol=1e-7, err_msg=k)
    if not valid:
        assert loss == 0.0 and m["valid_px"].item() == 0.0


def test_optimizer_matches_optax():
    """Five steps of Adam with two LR boundaries and global-norm clipping
    against ``ecm_tpu.train.state.make_optimizer`` (optax) at rel 1e-5. The
    two drops compound, as optax's piecewise schedule does with scales
    ``new_lr / lr``: steps 0-5 run at 1e-3, 1e-3, 1e-4, 1e-4, 5e-5, 5e-5."""
    rng = np.random.default_rng(10)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    # gradient norms ~0.3 to ~30 against a clip of 2: some steps clip, some not
    grads = [
        {k: (rng.normal(size=s) * 10.0 ** rng.uniform(-1.5, 1)).astype(np.float32) for k, s in shapes.items()}
        for _ in range(5)
    ]
    drops = [(2, 1e-4), (4, 5e-4)]
    tx = jax_make_optimizer(1e-3, drops, clip_norm=2.0)
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(t(v)) for k, v in params.items()}
    opt = make_optimizer(1e-3, drops, clip_norm=2.0)(tp.values())
    assert isinstance(opt, Optimizer)
    assert [opt.lr_at(i) for i in range(6)] == pytest.approx([1e-3, 1e-3, 1e-4, 1e-4, 5e-5, 5e-5], rel=1e-12)
    clipped = 0
    for g in grads:
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = t(g[k])
        clipped += np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in g.values())) >= 2.0
        opt.step()
        for k, p in tp.items():
            assert_close_rel(p.detach().numpy(), np.asarray(jp[k]), 1e-5)
    assert 0 < clipped < 5


@pytest.mark.parametrize(
    "name,kw",
    [
        ("stackhourglass", dict(max_disp=64, agg_layout="grouped")),
        ("stackhourglass", dict(max_disp=16, agg_layout="standard")),
        ("basic", dict(max_disp=16)),
    ],
    ids=["grouped", "standard", "basic"],
)
def test_trainer_runs_on_cpu(tmp_path, capsys, name, kw):
    """``train_loop`` with ``make_train_step`` over synthetic batches: the
    JAX package's log line, one JSONL line per log step and per evaluation,
    finite metrics, the step count; then the eval step and the infer
    function. On the CPU no kernel counter moves."""
    model = build_model(name, device="cpu", feature_channels=8, **kw)
    state = create_train_state(model, make_optimizer(1e-3))
    path = tmp_path / "metrics.jsonl"
    batches = (make_batch(s, 1, h=32, w=64, max_disp=12.0) for s in itertools.count())
    counters = (gband_conv_s1, conv3d_bn_s1, cost_volume_concat, fused_upsample_softargmin)
    evals = []
    state = train_loop(
        state, make_train_step(model, kw["max_disp"]), batches, num_steps=3,
        log_every=2, metrics_path=str(path),
        eval_fn=lambda st, step: evals.append(step) or {"epe": 1.5}, eval_every=2,
    )
    assert state.step == 3 and state.optimizer.count == 3 and evals == [2]
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert [m["step"] for m in lines] == [2, 2, 3] and lines[1]["eval"] == {"epe": 1.5}
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["epe"]) for m in (lines[0], lines[2]))
    assert "step 2/3 loss=" in capsys.readouterr().out
    assert [f.launches for f in counters] == [0, 0, 0, 0]
    batch = {k: t(v) for k, v in make_batch(99, 1, h=32, w=64, max_disp=12.0).items()}
    disp, metrics = make_eval_step(model, kw["max_disp"])(state, batch)
    assert disp.shape == (1, 32, 64) and not model.training
    assert np.isfinite(metrics["epe"].item())
    assert torch.equal(make_infer_fn(model)(batch["left"], batch["right"]), disp)
