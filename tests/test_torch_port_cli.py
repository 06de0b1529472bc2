"""The port's command-line drivers (``ecm_torch.cli``) on the CPU: preset
resolution against ``ecm_tpu.cli.common``, and each CLI's ``main`` end to
end on small trees the tests write (train with auto-resume, finetune from
its checkpoint with the validation eval, evaluate on three datasets,
submission, test_img), at ``--device cpu --maxdisp 16 --no-bf16``.

Cut for the CPU, and only here: the train presets crop 32x64 (not 256x512)
with no DataLoader workers (``test_torch_port_data.py`` runs the workers),
``kitti_finetune`` evaluates every 2 steps, and the port's
``kitti.EVAL_SIZE`` is 48x80 (not 384x1248) for the 40x70 KITTI images."""

import contextlib
import dataclasses
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import ecm_tpu.cli.common as jax_common
from ecm_tpu.train.metrics import disparity_metrics as jax_disparity_metrics
from ecm_torch.cli import common, evaluate, finetune, submission, test_img, train
from ecm_torch.configs import CONFIGS
from ecm_torch.data import kitti
from ecm_torch.data.preprocess import unpad
from ecm_torch.train import checkpoint as ckpt_lib
from test_torch_port_util import torch_threads, write_kitti_tree, write_middlebury_tree, write_sceneflow_tree

SMALL = ["--device", "cpu", "--maxdisp", "16", "--no-bf16"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    with torch_threads(1):
        yield


def run(cli, argv: list[str]) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return out.getvalue()


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    with pytest.MonkeyPatch.context() as mp:
        for name, extra in (("sceneflow_single", {}), ("kitti_finetune", dict(eval_every=2))):
            cfg = CONFIGS[name]
            mp.setitem(CONFIGS, name, dataclasses.replace(
                cfg, data=dataclasses.replace(cfg.data, crop=(32, 64), workers=0),
                train=dataclasses.replace(cfg.train, **extra)))
        mp.setattr(kitti, "EVAL_SIZE", (48, 80))
        yield dict(
            root=root,
            sceneflow=write_sceneflow_tree(root / "sceneflow"),
            kitti=write_kitti_tree(root / "kitti"),
            middlebury=write_middlebury_tree(root / "middlebury"),
        )


@pytest.fixture(scope="module")
def trained(env):
    ck = str(env["root"] / "ck")
    args = ["--datapath", env["sceneflow"], "--batch", "2", "--savemodel", ck, *SMALL]
    first = run(train, ["--steps", "2", *args])
    second = run(train, ["--steps", "3", *args])
    return dict(ck=ck, first=first, second=second)


@pytest.fixture(scope="module")
def finetuned(env, trained):
    ck2 = str(env["root"] / "ck2")
    out = run(finetune, ["--datapath", env["kitti"], "--loadmodel", trained["ck"], "--steps", "2",
                         "--batch", "2", "--savemodel", ck2, *SMALL])
    return dict(ck=ck2, out=out)


ARGVS = [
    [],
    ["--config", "overfit_gate", "--maxdisp", "64", "--no-bf16", "--pallas", "--steps", "7", "--lr", "1e-4"],
    ["--epochs", "3", "--batch", "8", "--regress-mode", "fused", "--agg-layout", "grouped", "--agg-fused", "on",
     "--mesh-disp", "1", "--savemodel", "ck", "--datapath", "/data", "--seed", "5", "--model", "basic"],
]


@pytest.mark.parametrize("preset", ["sceneflow_single", "kitti_finetune", "kitti_infer"])
@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "overfit_gate", "flags"])
def test_resolve_config_matches_jax(preset, argv):
    port = common.resolve_config(common.base_parser("port").parse_args(argv), preset)
    ref = jax_common.resolve_config(jax_common.base_parser("jax").parse_args(argv), preset)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_steps_from_epochs():
    def cfg(dataset="sceneflow", epochs=None, batch=4):
        c = CONFIGS["sceneflow_single"]
        return dataclasses.replace(c, data=dataclasses.replace(c.data, dataset=dataset, global_batch=batch),
                                   train=dataclasses.replace(c.train, epochs=epochs))

    assert common.steps_from_epochs(cfg(epochs=3), 10) == 3 * (10 // 4)
    assert common.steps_from_epochs(cfg(), 10) == cfg().train.num_steps
    with pytest.raises(ValueError, match="finite dataset"):
        common.steps_from_epochs(cfg(dataset="synthetic", epochs=2), None)


def test_train_cli_auto_resumes(trained):
    assert "auto-resumed" not in trained["first"] and "done at step 2" in trained["first"]
    assert "auto-resumed from step 2" in trained["second"] and "done at step 3" in trained["second"]
    assert ckpt_lib.make_manager(trained["ck"]).all_steps() == [2, 3]
    logged = [json.loads(s) for s in open(os.path.join(trained["ck"], "metrics.jsonl"))]
    assert [m["step"] for m in logged] == [2, 3] and all(np.isfinite(m["loss"]) for m in logged)


def test_finetune_cli(finetuned):
    out = finetuned["out"]
    assert "loaded pretrained weights (step 3)" in out and "done at step 2" in out
    assert "eval @ 2: {'epe':" in out
    assert ckpt_lib.make_manager(finetuned["ck"]).all_steps() == [2]
    blob = torch.load(os.path.join(finetuned["ck"], "2.pt"), weights_only=True)
    assert blob["step"] == blob["count"] == 2  # a fresh optimizer and step, not the pretrained 3


@pytest.mark.parametrize("dataset", ["kitti2015", "sceneflow", "middlebury"])
def test_evaluate_cli_prints_jax_keys(env, finetuned, dataset):
    path = env["kitti" if dataset.startswith("kitti") else dataset]
    out = run(evaluate, ["--dataset", dataset, "--datapath", path, "--loadmodel", finetuned["ck"], *SMALL])
    lines = out.strip().splitlines()
    assert lines[0] == "loaded checkpoint step 2"
    metrics = json.loads(lines[-1])
    jax_keys = set(jax_disparity_metrics(jnp.zeros((1, 4, 4)), jnp.ones((1, 4, 4)), 16)) - {"valid_px"}
    assert set(metrics) == jax_keys | {"num_pairs"}
    assert metrics["num_pairs"] == {"kitti2015": 2, "sceneflow": 2, "middlebury": 1}[dataset]
    assert all(np.isfinite(v) for v in metrics.values())


def test_submission_cli_writes_pngs(env, finetuned):
    outdir = env["root"] / "disp_0"
    out = run(submission, ["--datapath", env["kitti"], "--loadmodel", finetuned["ck"], "--outdir", str(outdir),
                           *SMALL])
    assert len([s for s in out.splitlines() if s.endswith(" ms")]) == 2
    specs, _ = kitti.list_kitti(env["kitti"], split="testing")
    state, _ = common.restore(common.build_state(common.resolve_config(
        common.base_parser("").parse_args(SMALL), "kitti_infer"), "cpu", 0), finetuned["ck"])
    for spec in specs:
        png = np.asarray(Image.open(outdir / os.path.basename(spec.left)))
        assert png.dtype == np.uint16 and png.shape == (40, 70)
        sample = kitti.load_sample(spec, crop=None)
        with torch.inference_mode():
            state.model.eval()
            disp = state.model(*(torch.from_numpy(sample[k])[None] for k in ("left", "right")))[0][0].numpy()
        want = kitti.encode_disp_png(unpad(disp, tuple(sample["pads"])))
        assert np.abs(png.astype(np.int32) - want).max() <= 1


def test_test_img_cli(env, finetuned):
    out_png = str(env["root"] / "demo" / "d.png")
    os.makedirs(os.path.dirname(out_png))
    out = run(test_img, ["--synthetic", "--loadmodel", finetuned["ck"], "--out", out_png, *SMALL])
    assert "EPE vs synthetic GT" in out
    assert np.asarray(Image.open(out_png)).shape == (256, 512)
    assert np.asarray(Image.open(out_png.replace(".png", "_vis.png"))).shape == (256, 512, 3)
    left = os.path.join(env["kitti"], "testing", "image_2", "000000_10.png")
    right = left.replace("image_2", "image_3")
    run(test_img, ["--left", left, "--right", right, "--out", out_png, *SMALL])
    assert np.asarray(Image.open(out_png)).shape == (40, 70)
