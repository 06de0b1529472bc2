"""Each CUDA kernel against its plain version on the card, at small shapes.

Marked ``cuda``: skipped without a GPU. The machine with the card has no
JAX, so run these there without the JAX test setup:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py``.
"""

import pytest
import torch

from ecm_torch.ops.cuda_cost_volume import cost_volume_concat, cost_volume_concat_torch
from ecm_torch.ops.cuda_fused_agg import fused_conv3d_pair, fused_conv3d_pair_torch
from ecm_torch.ops.cuda_regression import (
    fused_upsample_softargmin,
    fused_upsample_softargmin_torch,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,c", [(torch.bfloat16, 32), (torch.float32, 3), (torch.bfloat16, 5)])
def test_cost_volume_kernel(dev, dtype, c):
    g = torch.Generator().manual_seed(0)
    fl, fr = (torch.randn(2, 5, 40, c, generator=g).to(dev, dtype) for _ in range(2))
    n = cost_volume_concat.launches
    out = cost_volume_concat(fl, fr, 12)
    torch.cuda.synchronize()
    assert cost_volume_concat.launches == n + 1
    assert torch.equal(out, cost_volume_concat_torch(fl, fr, 12))


@pytest.mark.parametrize("form", ["ctx", "residual", "classif", "odd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_pair_kernel(dev, form, dtype):
    g = torch.Generator().manual_seed(1)
    cin, cm, cout = {"ctx": (16, 8, 8), "residual": (8, 8, 8), "classif": (8, 8, 1), "odd": (6, 5, 3)}[form]
    x = torch.randn(2, 6, 10, 19, cin, generator=g).to(dev, dtype)
    k1 = torch.randn(cm, cin, 3, 3, 3, generator=g) * 0.2
    k2 = torch.randn(cout, cm, 3, 3, 3, generator=g) * 0.2
    s1, b1 = torch.rand(cm, generator=g) + 0.5, torch.randn(cm, generator=g)
    s2, b2 = torch.rand(cout, generator=g) + 0.5, torch.randn(cout, generator=g)
    ctx = torch.randn(2, 10, 19, cout, generator=g).to(dev, dtype) if form == "ctx" else None
    opts = {"residual": {"relu2": False, "residual": True}, "classif": {"relu2": False}}.get(form, {})
    args = [v.to(dev) for v in (x, k1, s1, b1, k2, s2, b2)]
    out = fused_conv3d_pair(*args, ctx, **opts)
    torch.cuda.synchronize()
    ref = fused_conv3d_pair_torch(*args, ctx, **opts)
    err = (out.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert err <= (2e-2 if dtype == torch.bfloat16 else 1e-5), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_regression_kernel(dev, dtype):
    g = torch.Generator().manual_seed(2)
    c4 = torch.randn(2, 12, 7, 9, generator=g).to(dev, dtype)
    out = fused_upsample_softargmin(c4, 48)
    torch.cuda.synchronize()
    ref = fused_upsample_softargmin_torch(c4, 48)
    assert (out - ref).abs().max() <= 1e-3
