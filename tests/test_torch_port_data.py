"""The port's data layer (``ecm_torch.data``) against ``ecm_tpu.data`` on
files the tests write: PFM across packages, the crop and pad geometry with
equal generator states, the three listers, ``load_sample`` of each reader
(the KITTI disparity PNG decoded exactly), the eval iterator, the synthetic
stream bit for bit, and the DataLoader train pipeline's seed rule."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import ecm_tpu.data.kitti as jax_kitti
import ecm_tpu.data.middlebury as jax_middlebury
import ecm_tpu.data.pipeline as jax_pipeline
import ecm_tpu.data.preprocess as jax_pre
import ecm_tpu.data.sceneflow as jax_sceneflow
from ecm_tpu.data.pfm import read_pfm as jax_read_pfm
from ecm_tpu.data.pfm import write_pfm as jax_write_pfm
from ecm_torch.data import kitti, middlebury, pipeline, preprocess, sceneflow
from ecm_torch.data.pfm import read_pfm, write_pfm
from test_torch_port_util import write_kitti_tree, write_middlebury_tree, write_sceneflow_tree

ROOT = Path(__file__).resolve().parents[1]
READERS = {
    "sceneflow": (sceneflow, jax_sceneflow, "list_sceneflow"),
    "kitti": (kitti, jax_kitti, "list_kitti"),
    "middlebury": (middlebury, jax_middlebury, "list_middlebury"),
}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    return {
        "sceneflow": write_sceneflow_tree(root / "sceneflow"),
        "kitti": write_kitti_tree(root / "kitti"),
        "middlebury": write_middlebury_tree(root / "middlebury"),
    }


def assert_samples_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def specs_of(lists) -> list:
    return [[dataclasses.astuple(s) for s in lst] for lst in lists]


@pytest.mark.parametrize("shape", [(37, 53), (8, 9, 3)], ids=["grey", "colour"])
def test_pfm_across_packages(tmp_path, shape):
    a = np.random.default_rng(0).uniform(0, 192, size=shape).astype(np.float32)
    write_pfm(str(tmp_path / "port.pfm"), a, scale=2.0)
    jax_write_pfm(str(tmp_path / "jax.pfm"), a, scale=2.0)
    assert (tmp_path / "port.pfm").read_bytes() == (tmp_path / "jax.pfm").read_bytes()
    for path in ("port.pfm", "jax.pfm"):
        (back, scale), (jback, jscale) = read_pfm(str(tmp_path / path)), jax_read_pfm(str(tmp_path / path))
        np.testing.assert_array_equal(back, a)
        np.testing.assert_array_equal(back, jback)
        assert scale == jscale == 2.0
    (tmp_path / "x.pfm").write_bytes(b"P5\n1 1\n255\n\x00")
    with pytest.raises(ValueError, match="not a PFM"):
        read_pfm(str(tmp_path / "x.pfm"))


def test_random_crop_equal_generator_states():
    rng = np.random.default_rng(0)
    arrays = [rng.uniform(size=(20, 30, 3)).astype(np.float32), rng.uniform(size=(20, 30)).astype(np.float32)]
    for seed in range(5):
        got = preprocess.random_crop(np.random.default_rng(seed), arrays, 8, 12)
        want = jax_pre.random_crop(np.random.default_rng(seed), arrays, 8, 12)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="crop"):
        preprocess.random_crop(np.random.default_rng(0), arrays, 21, 12)


@pytest.mark.parametrize("kw", [dict(multiple=16), dict(multiple=32), dict(target=(384, 1248))],
                         ids=["multiple16", "multiple32", "target"])
@pytest.mark.parametrize("shape", [(375, 1242), (40, 64, 3)], ids=["disp", "image"])
def test_pad_to_multiple_and_unpad(kw, shape):
    img = np.random.default_rng(0).uniform(size=shape).astype(np.float32)
    padded, pads = preprocess.pad_to_multiple(img, **kw)
    jpadded, jpads = jax_pre.pad_to_multiple(img, **kw)
    assert pads == jpads
    np.testing.assert_array_equal(padded, jpadded)
    if img.ndim == 2:
        np.testing.assert_array_equal(preprocess.unpad(padded, pads), img)
        np.testing.assert_array_equal(preprocess.unpad(padded, pads), jax_pre.unpad(jpadded, jpads))


def test_listers_match(trees):
    train, test = sceneflow.list_sceneflow(trees["sceneflow"])
    assert (len(train), len(test)) == (5, 2)
    assert specs_of((train, test)) == specs_of(jax_sceneflow.list_sceneflow(trees["sceneflow"]))
    for kw in (dict(year=2015), dict(year=2015, val_count=1), dict(year=2015, split="testing")):
        assert specs_of(kitti.list_kitti(trees["kitti"], **kw)) == specs_of(
            jax_kitti.list_kitti(trees["kitti"], **kw)), kw
    assert specs_of(middlebury.list_middlebury(trees["middlebury"])) == specs_of(
        jax_middlebury.list_middlebury(trees["middlebury"]))
    scene = f"{trees['middlebury']}/Adirondack"
    assert middlebury.read_ndisp(scene) == jax_middlebury.read_ndisp(scene) == 290


@pytest.mark.parametrize("crop", [None, (16, 32)], ids=["eval", "crop"])
@pytest.mark.parametrize("reader", list(READERS))
def test_load_sample_matches(trees, reader, crop):
    port, jax_mod, lister = READERS[reader]
    lists = getattr(port, lister)(trees[reader])
    specs = [s for lst in lists for s in lst if s.disp or reader != "sceneflow"]
    for spec in specs:
        got = port.load_sample(spec, crop=crop, rng=np.random.default_rng(3))
        want = jax_mod.load_sample(jax_sceneflow.SampleSpec(*dataclasses.astuple(spec)), crop=crop,
                                   rng=np.random.default_rng(3))
        assert_samples_equal(got, want)
    if reader == "kitti":
        png = specs[0].disp
        from PIL import Image

        raw = np.asarray(Image.open(png))
        assert raw.dtype == np.uint16
        np.testing.assert_array_equal(kitti.decode_disp_png(png), raw.astype(np.float32) / 256)
        np.testing.assert_array_equal(kitti.encode_disp_png(kitti.decode_disp_png(png)), raw)


def test_eval_iterator_matches(trees):
    for reader, split in (("kitti", 1), ("sceneflow", 1)):
        port, jax_mod, lister = READERS[reader]
        specs = getattr(port, lister)(trees[reader])[split]
        got = list(pipeline.make_eval_iterator(specs, port.load_sample, batch_size=1))
        want = list(jax_pipeline.make_eval_iterator(specs, jax_mod.load_sample, batch_size=1))
        assert len(got) == len(want) == len(specs)
        for g, w in zip(got, want):
            assert_samples_equal(g, w)  # "pads" included


@pytest.mark.parametrize("distinct", [None, 2])
def test_synthetic_pipeline_matches_jax(distinct):
    cfg = pipeline.PipelineConfig(batch_size=2, seed=5)
    jcfg = jax_pipeline.PipelineConfig(batch_size=2, seed=5)
    got = pipeline.make_synthetic_pipeline(cfg, h=16, w=32, max_disp=8.0, distinct=distinct)
    want = jax_pipeline.make_synthetic_pipeline(jcfg, h=16, w=32, max_disp=8.0, distinct=distinct)
    for _ in range(3):
        assert_samples_equal(next(got), next(want))


def _which_spec(sample: dict, specs: list, load_fn, crop, seed: int, i: int) -> int:
    """The spec that ``load_fn(spec, crop, default_rng((seed, 0, i)))``
    turns into ``sample``."""
    hits = [j for j, spec in enumerate(specs)
            if np.array_equal(load_fn(spec, crop=crop, rng=np.random.default_rng((seed, 0, i)))["left"],
                              sample["left"])]
    assert len(hits) == 1, f"draw {i} matches specs {hits}"
    return hits[0]


def _draws(batches) -> list[dict]:
    return [{k: b[k][r] for k in b} for b in batches for r in range(len(b["left"]))]


PIPELINE_SCRIPT = """
import sys
import numpy as np
from ecm_torch.data import pipeline, sceneflow
specs, _ = sceneflow.list_sceneflow(sys.argv[1])
num_epochs = None if sys.argv[3] == "None" else int(sys.argv[3])
it = pipeline.make_train_pipeline(specs, sceneflow.load_sample, pipeline.PipelineConfig(
    batch_size=2, crop=(16, 32), seed=7, num_epochs=num_epochs, num_workers=int(sys.argv[2])))
batches = [b for b, _ in zip(it, range(int(sys.argv[4])))]
np.savez(sys.argv[5], **{f"{i}_{k}": v for i, b in enumerate(batches) for k, v in b.items()})
"""


def train_batches(root: str, num_workers: int, num_epochs, n: int, tmp_path) -> list[dict]:
    """Up to ``n`` batches of the port's train pipeline over the SceneFlow
    tree at ``root`` (batch 2, crop 16x32, seed 7). With workers, in a
    process of its own: DataLoader workers fork, and this one runs JAX's
    threads, which a forked child must not inherit."""
    if not num_workers:
        specs, _ = sceneflow.list_sceneflow(root)
        it = pipeline.make_train_pipeline(specs, sceneflow.load_sample, pipeline.PipelineConfig(
            batch_size=2, crop=(16, 32), seed=7, num_epochs=num_epochs))
        return [b for b, _ in zip(it, range(n))]
    out = tmp_path / f"batches_{num_epochs}.npz"
    subprocess.run([sys.executable, "-c", PIPELINE_SCRIPT, root, str(num_workers), str(num_epochs), str(n),
                    str(out)], check=True, timeout=120, cwd=ROOT)
    with np.load(out) as f:
        count = len({k.split("_")[0] for k in f})
        return [{k: f[f"{i}_{k}"] for k in ("left", "right", "disparity")} for i in range(count)]


@pytest.mark.parametrize("num_workers", [0, 2])
def test_train_pipeline_seed_rule(trees, num_workers, tmp_path):
    """Each draw i is ``load_fn(spec, crop, default_rng((seed, 0, i)))`` of
    its spec; one epoch draws each spec once, the last short batch dropped;
    repeating forever, batches run on across epochs. The JAX package's grain
    pipeline follows the same rule (in another shuffle order)."""
    specs, _ = sceneflow.list_sceneflow(trees["sceneflow"])  # 5 specs
    crop, seed = (16, 32), 7
    batches = train_batches(trees["sceneflow"], num_workers, 1, 10, tmp_path)
    assert len(batches) == 2 and batches[0]["left"].shape == (2, 16, 32, 3)
    assert batches[0]["disparity"].shape == (2, 16, 32) and batches[0]["left"].dtype == np.float32
    drawn = [_which_spec(s, specs, sceneflow.load_sample, crop, seed, i) for i, s in enumerate(_draws(batches))]
    assert len(set(drawn)) == 4

    draws = _draws(train_batches(trees["sceneflow"], num_workers, None, 5, tmp_path))
    drawn = [_which_spec(s, specs, sceneflow.load_sample, crop, seed, i) for i, s in enumerate(draws)]
    assert sorted(drawn[:5]) == sorted(drawn[5:]) == list(range(5))
    if num_workers == 0:
        jspecs = [jax_sceneflow.SampleSpec(*dataclasses.astuple(s)) for s in specs]
        jit = jax_pipeline.make_train_pipeline(jspecs, jax_sceneflow.load_sample, jax_pipeline.PipelineConfig(
            batch_size=2, crop=crop, seed=seed, worker_count=0))
        jdraws = _draws([next(jit) for _ in range(5)])
        jdrawn = [_which_spec(s, jspecs, jax_sceneflow.load_sample, crop, seed, i) for i, s in enumerate(jdraws)]
        assert sorted(jdrawn[:5]) == sorted(jdrawn[5:]) == list(range(5))
