"""Shared helpers of the port's parity tests (no tests here): seeded numpy
variables for a flax module (weights, BN statistics) and conversions
between the packages."""

from __future__ import annotations

import math

import jax
import numpy as np
import torch


def flax_variables(model, *args, seed: int = 0, **kwargs) -> dict:
    """Variables for ``model.init(..., train=True)`` drawn from numpy:
    fan-in-scaled kernels, random biases, BN affine and running statistics
    away from the identity, so every fold and layout rule is exercised."""
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
