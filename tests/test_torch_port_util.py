"""Shared helpers of the port's parity tests (no tests here): seeded numpy
variables for a flax module (weights, BN statistics) and conversions
between the packages."""

from __future__ import annotations

import contextlib
import math

import jax
import numpy as np
import torch


def flax_variables(model, *args, seed: int = 0, bn_bias: tuple[float, float] | None = None, **kwargs) -> dict:
    """Variables for ``model.init(..., train=True)`` drawn from numpy:
    fan-in-scaled kernels, random biases, BN affine and running statistics
    away from the identity, so every fold and layout rule is exercised.
    ``bn_bias``: draw the BatchNorm shifts uniform in this range instead."""
    shapes = jax.eval_shape(
        lambda: model.init({"params": jax.random.PRNGKey(0)}, *args, train=True, **kwargs)
    )
    rng = np.random.default_rng(seed)

    def draw(path, s):
        names = [getattr(p, "key", str(p)) for p in path]
        leaf, shape = names[-1], s.shape
        if leaf == "kernel":
            std = 1.0 / math.sqrt(math.prod(shape[:-1]))
            return rng.normal(0, std, shape).astype(np.float32)
        if leaf == "scale":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if leaf == "var":
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        if leaf == "mean":
            return rng.normal(0, 0.3, shape).astype(np.float32)
        if bn_bias is not None and names[-2:] == ["bn", "bias"]:
            return rng.uniform(*bn_bias, shape).astype(np.float32)
        return rng.normal(0, 0.1, shape).astype(np.float32)  # biases

    tree = jax.tree_util.tree_map_with_path(draw, dict(shapes))
    return {"params": tree["params"], "batch_stats": tree.get("batch_stats", {})}


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32)))


def to_torch_kernel(k) -> torch.Tensor:
    """flax conv kernel [*k, I, O] -> torch [O, I, *k]."""
    k = np.asarray(k)
    nd = k.ndim - 2
    return t(np.transpose(k, (nd + 1, nd, *range(nd))))


def assert_close_rel(a, b, rel: float) -> None:
    """max |a - b| <= rel * max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err, scale = np.abs(a - b).max(), max(np.abs(b).max(), 1e-12)
    assert err <= rel * scale, f"max|diff| {err} > {rel} * max|ref| {scale}"


def assert_grads_match(grads: dict, mapped: dict, rel: float) -> None:
    """Each port gradient against the mapped JAX one at max|diff|/max|ref|
    <= ``rel``. The heads' conv2 biases shift a cost map uniformly over D,
    which the soft-argmin ignores: their exact gradient is 0, and both
    packages must hold them below 1e-4 of the model's largest gradient."""
    assert set(grads) <= set(mapped)
    top = max(g.abs().max().item() for g in mapped.values() if g.is_floating_point())
    for k, g in grads.items():
        if "classif" in k and k.endswith("conv2.bias"):
            assert max(g.abs().max().item(), mapped[k].abs().max().item()) <= 1e-4 * top, k
            continue
        try:
            assert_close_rel(g.numpy(), mapped[k].numpy(), rel)
        except AssertionError as e:
            raise AssertionError(f"{k}: {e}") from None


def assert_stats_match(sd: dict, mapped: dict, rel: float) -> None:
    """Every BatchNorm running mean and variance at rel ``rel``."""
    stats = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(stats) > 20
    for k in stats:
        try:
            assert_close_rel(sd[k].numpy(), mapped[k].numpy(), rel)
        except AssertionError as e:
            raise AssertionError(f"{k}: {e}") from None


def jax_train_grads(model, variables: dict, batch: dict, max_disp: int):
    """One training forward and backward of a flax model, as
    ``ecm_tpu.train.steps.make_train_step`` takes it before the optimizer:
    (loss, predictions, parameter gradients, new batch statistics), numpy."""
    from ecm_tpu.train.loss import stereo_loss

    def loss_fn(params):
        preds, mutated = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jax.numpy.asarray(batch["left"]), jax.numpy.asarray(batch["right"]),
            train=True, mutable=["batch_stats"],
        )
        return stereo_loss(preds, jax.numpy.asarray(batch["disparity"]), max_disp), (preds, mutated["batch_stats"])

    (loss, (preds, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    return float(loss), [np.asarray(p) for p in preds], jax.tree.map(np.asarray, grads), jax.tree.map(np.asarray, stats)


def torch_train_grads(model: torch.nn.Module, batch: dict, max_disp: int):
    """The same for a port model (left in training mode): (loss,
    predictions, ``{name: grad}``, state_dict after the step)."""
    from ecm_torch.train.loss import stereo_loss

    model.train()
    model.zero_grad(set_to_none=True)
    preds = model(t(batch["left"]), t(batch["right"]))
    loss = stereo_loss(preds, t(batch["disparity"]), max_disp)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return loss.item(), [p.detach().numpy() for p in preds], grads, model.state_dict()


def write_png(path, array) -> None:
    """Write a uint8 RGB or uint16 grey array as a PNG with Pillow."""
    import os

    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(array).save(path)


def write_sceneflow_tree(root, splits=(("TRAIN", 5), ("TEST", 2)), h=40, w=64, seed=0) -> str:
    """A FlyingThings3D-style tree: ``frames_finalpass/<split>/A/0001/
    {left,right}/NNNN.png`` and ``disparity/<split>/A/0001/left/NNNN.pfm``,
    random images and disparities in [1, 30)."""
    import os

    from ecm_torch.data.pfm import write_pfm

    rng = np.random.default_rng(seed)
    for split, n in splits:
        base = os.path.join(root, "frames_finalpass", split, "A", "0001")
        dbase = os.path.join(root, "disparity", split, "A", "0001", "left")
        os.makedirs(dbase, exist_ok=True)
        for i in range(n):
            for side in ("left", "right"):
                write_png(os.path.join(base, side, f"{i:04d}.png"), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            write_pfm(os.path.join(dbase, f"{i:04d}.pfm"), rng.uniform(1, 30, (h, w)).astype(np.float32))
    return str(root)


def write_kitti_tree(root, n_train=4, n_test=2, h=40, w=70, seed=0) -> str:
    """A KITTI 2015 tree: ``training/{image_2,image_3,disp_occ_0}`` (uint16
    disparities in [0, 12) px, about a third invalid) and ``testing/
    {image_2,image_3}``."""
    import os

    rng = np.random.default_rng(seed)
    for split, n in (("training", n_train), ("testing", n_test)):
        for i in range(n):
            name = f"{i:06d}_10.png"
            for side in ("image_2", "image_3"):
                write_png(os.path.join(root, split, side, name), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            if split == "training":
                d = rng.uniform(0, 12, (h, w)) * (rng.uniform(size=(h, w)) > 0.3)
                write_png(os.path.join(root, split, "disp_occ_0", name), np.round(d * 256).astype(np.uint16))
    return str(root)


def write_middlebury_tree(root, h=50, w=70, seed=0) -> str:
    """Two Middlebury scenes, one with ``disp0GT.pfm`` (one ``inf`` pixel)
    and ``calib.txt``, one without."""
    import os

    from ecm_torch.data.pfm import write_pfm

    rng = np.random.default_rng(seed)
    for scene, with_gt in (("Adirondack", True), ("Bicycle", False)):
        base = os.path.join(root, scene)
        for name in ("im0.png", "im1.png"):
            write_png(os.path.join(base, name), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        if with_gt:
            d = rng.uniform(1, 60, (h, w)).astype(np.float32)
            d[0, 0] = np.inf
            write_pfm(os.path.join(base, "disp0GT.pfm"), d)
            with open(os.path.join(base, "calib.txt"), "w") as f:
                f.write("cam0=...\nndisp=290\n")
    return str(root)


@contextlib.contextmanager
def torch_threads(n: int):
    """torch's intra-op threads set to ``n`` inside, restored after. The
    tier-1 run puts six test processes on the machine's cores; a train step
    of small convolutions, each a parallel region whose threads must all be
    scheduled, runs many times slower there with torch's default of one
    thread a core than with one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)
