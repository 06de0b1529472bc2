"""The training path's ops against the JAX package on the CPU, f32, on the
same numpy inputs: ``gband_conv_s1`` (value and VJP) against JAX's
``gband_conv_s1`` with its Pallas kernel in interpret mode, the two cost
volumes' ``Function`` backward against ``jax.vjp`` of
``cost_volume_pallas``, and the port's BatchNorm in training against
``flax.linen.BatchNorm``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from ecm_tpu.ops.grouped3d import from_grouped, to_grouped
from ecm_tpu.ops.pallas_cost_volume import cost_volume_pallas
from ecm_tpu.ops.pallas_gband import gband_conv_s1 as jax_gband_conv_s1
from ecm_torch.models.layers import BatchNorm2d, BatchNorm3d, frozen_batch_stats
from ecm_torch.ops.cost_volume import cost_volume
from ecm_torch.ops.cuda_cost_volume import (
    cost_volume_concat,
    cost_volume_correlation,
    cost_volume_correlation_torch,
)
from ecm_torch.ops.cuda_gband import conv3d_bn_s1, gband_conv_s1, gband_conv_s1_torch
from test_torch_port_util import assert_close_rel, t, to_torch_kernel


@pytest.mark.parametrize("cin,cout", [(6, 4), (4, 7)])
def test_gband_conv_s1_matches_jax_vjp(cin, cout):
    """Forward, input gradient and weight gradient against JAX's
    ``gband_conv_s1`` (g=4, interpret mode) through to_grouped/from_grouped,
    Cin != Cout both ways; f32 at 1e-4 (as the JAX package's own
    ``test_gband_conv_s1_vjp_matches_autodiff``)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 8, 5, 8, cin)).astype(np.float32)
    k = (rng.normal(size=(3, 3, 3, cin, cout)) * 0.2).astype(np.float32)
    dy = rng.normal(size=(1, 8, 5, 8, cout)).astype(np.float32)
    out_j, pull = jax.vjp(lambda a, b: jax_gband_conv_s1(a, b, 4), to_grouped(jnp.asarray(x)), jnp.asarray(k))
    dxg, dk = pull(to_grouped(jnp.asarray(dy)))

    xt, wt = t(x).requires_grad_(), to_torch_kernel(k).requires_grad_()
    out = gband_conv_s1(xt, wt)
    out.backward(t(dy))
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(from_grouped(out_j)), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(from_grouped(dxg)), **tol)
    np.testing.assert_allclose(wt.grad.numpy(), to_torch_kernel(dk).numpy(), rtol=1e-4, atol=2e-3)


def test_gband_conv_s1_on_cpu_launches_nothing():
    """A CPU tensor takes the plain version forward and backward (the input
    gradient is the plain conv of dy with the flipped, transposed kernel);
    no counter moves, the eval kernel's included."""
    rng = np.random.default_rng(1)
    before = (gband_conv_s1.launches, gband_conv_s1.backward_launches, conv3d_bn_s1.launches)
    x = t(rng.normal(size=(1, 3, 4, 5, 3))).requires_grad_()
    w = t(rng.normal(size=(2, 3, 3, 3, 3))).requires_grad_()
    dy = t(rng.normal(size=(1, 3, 4, 5, 2)))
    out = gband_conv_s1(x, w)
    assert torch.equal(out, gband_conv_s1_torch(x, w))
    out.backward(dy)
    np.testing.assert_allclose(
        x.grad.numpy(), gband_conv_s1_torch(dy, w.detach().flip(2, 3, 4).transpose(0, 1)).numpy(),
        rtol=1e-5, atol=1e-5,
    )
    after = (gband_conv_s1.launches, gband_conv_s1.backward_launches, conv3d_bn_s1.launches)
    assert after == before == (0, 0, 0)
    with pytest.raises(ValueError, match="weight"):
        gband_conv_s1(x, torch.zeros(2, 4, 3, 3, 3))


def test_correlation_plain_builder_matches_pallas():
    """The plain correlation builder against ``cost_volume_pallas``
    (correlation, interpret mode) at rel 1e-6; a bf16 input is accumulated
    in f32 and rounded once, as the Pallas kernel does."""
    rng = np.random.default_rng(2)
    fl, fr = (rng.normal(size=(2, 3, 10, 5)).astype(np.float32) for _ in range(2))
    ref = np.asarray(cost_volume_pallas(jnp.asarray(fl), jnp.asarray(fr), 6, mode="correlation"))
    out = cost_volume_correlation_torch(t(fl), t(fr), 6)
    assert out.shape == (2, 6, 3, 10, 1)
    assert_close_rel(out.numpy(), ref, 1e-6)
    bf = cost_volume_correlation_torch(t(fl).bfloat16(), t(fr).bfloat16(), 6)
    exact = cost_volume_correlation_torch(t(fl).bfloat16().float(), t(fr).bfloat16().float(), 6)
    assert torch.equal(bf, exact.bfloat16())


@pytest.mark.parametrize("mode", ["concat", "correlation"])
def test_cost_volume_function_matches_pallas_vjp(mode):
    """``use_pallas=True`` (the Function; the plain builder on the CPU):
    value and both feature gradients against ``jax.vjp`` of
    ``cost_volume_pallas``, whose VJP is the jnp builder's; f32 at 1e-5."""
    rng = np.random.default_rng(3)
    fl, fr = (rng.normal(size=(2, 3, 10, 4)).astype(np.float32) for _ in range(2))
    d = 6
    out_j, pull = jax.vjp(lambda a, b: cost_volume_pallas(a, b, d, mode=mode), jnp.asarray(fl), jnp.asarray(fr))
    g = rng.normal(size=out_j.shape).astype(np.float32)
    dfl, dfr = pull(jnp.asarray(g))

    a, b = t(fl).requires_grad_(), t(fr).requires_grad_()
    out = cost_volume(a, b, d, mode=mode, use_pallas=True)
    assert out.grad_fn is not None
    out.backward(t(g))
    assert_close_rel(out.detach().numpy(), np.asarray(out_j), 1e-5)
    assert_close_rel(a.grad.numpy(), np.asarray(dfl), 1e-5)
    assert_close_rel(b.grad.numpy(), np.asarray(dfr), 1e-5)
    launches = cost_volume_concat.launches, cost_volume_correlation.launches
    assert launches == (0, 0)
    assert not copy_slices(out.grad_fn)


def copy_slices(fn) -> list[str]:
    """The ``CopySlices`` nodes of the autograd graph below ``fn``."""
    seen, stack, found = set(), [fn], []
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if "CopySlices" in node.name():
            found.append(node.name())
        stack.extend(f for f, _ in node.next_functions)
    return found


@pytest.mark.parametrize("mode", ["concat", "correlation"])
@pytest.mark.parametrize("w,d", [(10, 6), (5, 8)], ids=["w10_d6", "w5_d8"])
def test_plain_builder_vjp_is_closed_form(mode, w, d):
    """The plain builder (``use_pallas=False``, training's default): a
    graph with no ``CopySlices`` node (autograd copies no gradient volume),
    its forward bit-identical to ``cost_volume_pallas`` (concat) or at rel
    1e-6 (correlation, f32 sums in another order), and both feature
    gradients equal to ``jax.vjp``'s at rel 1e-5 in f32, also where D > W;
    in bf16, gradients summed in f32 and rounded once: the f32 result
    rounded."""
    rng = np.random.default_rng(5)
    fl, fr = (rng.normal(size=(2, 3, w, 4)).astype(np.float32) for _ in range(2))
    out_j, pull = jax.vjp(lambda a, b: cost_volume_pallas(a, b, d, mode=mode), jnp.asarray(fl), jnp.asarray(fr))
    g = rng.normal(size=out_j.shape).astype(np.float32)
    dfl, dfr = pull(jnp.asarray(g))

    a, b = t(fl).requires_grad_(), t(fr).requires_grad_()
    out = cost_volume(a, b, d, mode=mode)
    assert out.grad_fn is not None and not copy_slices(out.grad_fn)
    out.backward(t(g))
    if mode == "concat":
        assert torch.equal(out.detach(), torch.from_numpy(np.array(out_j)))
    assert_close_rel(out.detach().numpy(), np.asarray(out_j), 1e-6)
    assert_close_rel(a.grad.numpy(), np.asarray(dfl), 1e-5)
    assert_close_rel(b.grad.numpy(), np.asarray(dfr), 1e-5)

    ab, bb = t(fl).bfloat16().requires_grad_(), t(fr).bfloat16().requires_grad_()
    cost_volume(ab, bb, d, mode=mode).backward(t(g).bfloat16())
    af, bf = t(fl).bfloat16().float().requires_grad_(), t(fr).bfloat16().float().requires_grad_()
    cost_volume(af, bf, d, mode=mode).backward(t(g).bfloat16().float())
    assert torch.equal(ab.grad, af.grad.bfloat16()) and torch.equal(bb.grad, bf.grad.bfloat16())


def _flax_bn(x: np.ndarray, scale, bias, mean, var, dy):
    """flax's BatchNorm in training: output, new running statistics and the
    gradients of the output's inner product with dy."""
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    stats = {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}

    def f(xx, params):
        y, mut = bn.apply({"params": params, "batch_stats": stats}, xx, mutable=["batch_stats"])
        return y, mut["batch_stats"]

    (y, new), pull = jax.vjp(f, jnp.asarray(x), {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)})
    dx, dp = pull((jnp.asarray(dy), jax.tree.map(jnp.zeros_like, new)))
    return np.asarray(y), new, np.asarray(dx), dp


@pytest.mark.parametrize("shape", [(2, 3, 4, 5, 6), (2, 5, 6, 4), (1, 1, 1, 3)], ids=["3d", "2d", "n1"])
def test_batchnorm_train_matches_flax(shape):
    """The port's BatchNorm in training against ``flax.linen.BatchNorm``
    (momentum 0.9) at n = 120, 60 and 1 values per channel: output, the
    running statistics (biased variance) and the gradients at rel 1e-5."""
    rng = np.random.default_rng(4)
    c = shape[-1]
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, c).astype(np.float32), rng.normal(size=c).astype(np.float32)
    mean, var = rng.normal(size=c).astype(np.float32), rng.uniform(0.5, 2, c).astype(np.float32)
    y_j, new_j, dx_j, dp_j = _flax_bn(x, scale, bias, mean, var, dy)

    bn = (BatchNorm3d if len(shape) == 5 else BatchNorm2d)(c, eps=1e-5, momentum=0.1)
    with torch.no_grad():
        bn.weight.copy_(t(scale))
        bn.bias.copy_(t(bias))
        bn.running_mean.copy_(t(mean))
        bn.running_var.copy_(t(var))
    bn.train()
    xt = t(x).requires_grad_()
    y = bn(xt.movedim(-1, 1)).movedim(1, -1)
    y.backward(t(dy))
    assert_close_rel(y.detach().numpy(), y_j, 1e-5)
    assert_close_rel(bn.running_mean.numpy(), np.asarray(new_j["mean"]), 1e-5)
    assert_close_rel(bn.running_var.numpy(), np.asarray(new_j["var"]), 1e-5)
    assert_close_rel(xt.grad.numpy(), dx_j, 1e-5)
    assert_close_rel(bn.weight.grad.numpy(), np.asarray(dp_j["scale"]), 1e-5)
    assert_close_rel(bn.bias.grad.numpy(), np.asarray(dp_j["bias"]), 1e-5)
    assert bn.num_batches_tracked.item() == 1

    # a recomputation under remat normalises the same way and updates nothing
    stats = (bn.running_mean.clone(), bn.running_var.clone())
    with frozen_batch_stats(), torch.no_grad():
        again = bn(t(x).movedim(-1, 1)).movedim(1, -1)
    assert torch.equal(again, y.detach())
    assert torch.equal(bn.running_mean, stats[0]) and torch.equal(bn.running_var, stats[1])
    assert bn.num_batches_tracked.item() == 1
