"""Concat and correlation cost volumes: the plain builders and the wrappers
of their CUDA kernels (``ecm_torch/csrc/cost_volume.cu``; replace
``cost_volume_pallas`` concat and correlation).

- concat: ``[B, H, W, C]`` x2 -> ``[B, D, H, W, 2C]``: column ``w`` pairs the
  left feature at ``w`` with the right feature at ``w - d``; columns ``w < d``
  are zero in both halves.
- correlation: ``[B, H, W, C]`` x2 -> ``[B, D, H, W, G]``: for each of
  ``groups`` G groups of C / G neighbouring channels, the mean over the
  group of ``fl[w] * fr[w - d]``, in f32, zero for ``w < d``. ECM's volume
  is G = 1; IGEV-Stereo's group-wise volume is G = 8 (no TPU kernel has
  it), which needs no backward: its VJP raises.

Every builder takes ``d_start``: plane ``i`` of a volume of ``max_disp``
planes holds disparity ``d = d_start + i``, so a rank of a disparity-sharded
forward builds only its own range (``ecm_torch.parallel.halo``). The default
0 is the whole volume.

The plain builders and both wrappers are differentiable through one
closed-form VJP in plain torch per volume (``_concat_vjp``,
``_correlation_vjp``), the counterpart of the jnp builder's VJP that
``_cv_bwd_rule``/``_corr_bwd_rule`` take in JAX: sums over d of masked and
shifted gradient planes in f32, rounded once. Autograd never sees the
slice assignments, so it copies no gradient volume.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from ecm_torch.kernels.build import check, library
from ecm_torch.ops.cuda_gband import SMEM_PER_BLOCK


def _concat_volume(fl: torch.Tensor, fr: torch.Tensor, max_disp: int, d_start: int = 0) -> torch.Tensor:
    b, h, w, c = fl.shape
    out = fl.new_zeros(b, max_disp, h, w, 2 * c)
    for i in range(max(0, min(max_disp, w - d_start))):
        d = d_start + i
        out[:, i, :, d:, :c] = fl[:, :, d:]
        out[:, i, :, d:, c:] = fr[:, :, : w - d]
    return out


def _correlation_volume(fl: torch.Tensor, fr: torch.Tensor, max_disp: int, d_start: int = 0,
                        groups: int = 1) -> torch.Tensor:
    b, h, w, c = fl.shape
    out = fl.new_zeros(b, max_disp, h, w, groups)
    for i in range(max(0, min(max_disp, w - d_start))):
        d = d_start + i
        prod = fl[:, :, d:].float() * fr[:, :, : w - d].float()
        out[:, i, :, d:] = prod.view(b, h, w - d, groups, c // groups).mean(-1).to(fl.dtype)
    return out


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32, or the input's type where it is wider (f64)."""
    return torch.promote_types(dtype, torch.float32)


def _column_mask(max_disp: int, w: int, device, d_start: int = 0) -> torch.Tensor:
    """[D, W]: True where column w holds a value at plane i, disparity
    d = d_start + i (w >= d)."""
    return torch.arange(w, device=device) >= torch.arange(d_start, d_start + max_disp, device=device)[:, None]


def _pad_columns(x: torch.Tensor, dim: int, before: int, after: int, dtype: torch.dtype) -> torch.Tensor:
    """A contiguous copy of ``x`` in ``dtype`` with zero columns added
    before and after along ``dim``."""
    shape = list(x.shape)
    shape[dim] += before + after
    out = x.new_zeros(shape, dtype=dtype)
    out.narrow(dim, before, x.shape[dim]).copy_(x)
    return out


def _shift_columns(x: torch.Tensor, dim: int, shift: int, size: int, dtype: torch.dtype) -> torch.Tensor:
    """A contiguous copy of ``x`` in ``dtype`` whose column j along ``dim``
    is ``x``'s column j + shift (zero past the end), ``size`` columns."""
    shape = list(x.shape)
    shape[dim] = size
    out = x.new_zeros(shape, dtype=dtype)
    n = max(0, min(x.shape[dim] - shift, size))
    out.narrow(dim, 0, n).copy_(x.narrow(dim, min(shift, x.shape[dim]), n))
    return out


def _along_diagonal(gp: torch.Tensor, w: int) -> torch.Tensor:
    """``gp`` [B, D, H, W + D - 1, ...] (contiguous) -> the view
    [B, D, H, W, ...] whose entry (b, d, h, j) is ``gp[b, d, h, j + d]``."""
    st = list(gp.stride())
    st[1] += st[3]
    return gp.as_strided((*gp.shape[:3], w, *gp.shape[4:]), st)


def _concat_vjp(g: torch.Tensor, fl: torch.Tensor, fr: torch.Tensor, max_disp: int, d_start: int = 0):
    """Closed-form VJP of the concat volume, summed in f32 (f64 for f64)
    and rounded once, plane i at disparity d = d_start + i:
    ``dfl[w] = sum_i [w >= d] g[i, w, :C]`` and ``dfr[j] = sum_i g[i, j + d,
    C:]`` (columns j + d < W)."""
    w, c = fl.shape[2:]
    acc = _acc_dtype(g.dtype)
    mask = _column_mask(max_disp, w, g.device, d_start)[:, None, :, None]
    dfl = torch.where(mask, g[..., :c], 0).sum(1, dtype=acc)
    gp = _shift_columns(g[..., c:], 3, d_start, w + max_disp - 1, g.dtype)
    dfr = _along_diagonal(gp, w).sum(1, dtype=acc)
    return dfl.to(fl.dtype), dfr.to(fr.dtype)


def _correlation_vjp(g: torch.Tensor, fl: torch.Tensor, fr: torch.Tensor, max_disp: int, d_start: int = 0):
    """Closed-form VJP of the correlation volume, in f32 (f64 for f64) and
    rounded once, plane i at disparity d = d_start + i:
    ``dfl[w] = sum_i [w >= d] g[i, w] fr[w - d] / C`` and ``dfr[j] = sum_i
    g[i, j + d] fl[j + d] / C`` (columns j + d < W)."""
    w, c = fl.shape[2:]
    acc = _acc_dtype(g.dtype)
    gm = torch.where(_column_mask(max_disp, w, g.device, d_start)[:, None], g[..., 0], 0).to(acc)  # [B, D, H, W]
    # frp[w + D - 1 - i] = fr[w - d] (0 for w < d); its windows k = D - 1 - i
    frp = _pad_columns(fr, 2, max_disp - 1 + d_start, 0, acc).narrow(2, 0, w + max_disp - 1)
    dfl = torch.einsum("bkhw,bhkcw->bhwc", gm.flip(1), frp.unfold(2, w, 1))
    gd = _along_diagonal(_shift_columns(gm, 3, d_start, w + max_disp - 1, acc), w)  # g[i, j + d]
    flp = _shift_columns(fl, 2, d_start, w + max_disp - 1, acc)  # window i: fl[j + d]
    dfr = torch.einsum("bdhj,bhdcj->bhjc", gd, flp.unfold(2, w, 1))
    return (dfl / c).to(fl.dtype), (dfr / c).to(fr.dtype)


@functools.cache
def _kernel(name: str):
    fn = getattr(library("cost_volume"), name)
    vp, i = ctypes.c_void_p, ctypes.c_int
    if name == "ecm_cost_volume_concat":
        fn.argtypes = [vp, vp, vp, i, i, i, i, i, i, vp]
    else:
        fn.argtypes = [i, vp, vp, vp, i, i, i, i, i, i, i, vp]
    fn.restype = ctypes.c_int
    return fn


def _check(fl: torch.Tensor, fr: torch.Tensor) -> None:
    if fl.ndim != 4 or fl.shape != fr.shape or fl.dtype != fr.dtype:
        raise ValueError(f"fl/fr must be equal [B, H, W, C]: {fl.shape} {fr.shape}")
    if fl.device != fr.device:
        raise ValueError(f"fl on {fl.device}, fr on {fr.device}")
    if fl.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {fl.device}")


def _check_cuda(fl: torch.Tensor, fr: torch.Tensor) -> None:
    for t in (fl, fr):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("fl/fr must be contiguous and 16-byte aligned")


def _concat_forward(fl, fr, max_disp, d_start):
    if fl.device.type == "cpu":
        return _concat_volume(fl, fr, max_disp, d_start)
    _check_cuda(fl, fr)
    b, h, w, c = fl.shape
    out = torch.empty(b, max_disp, h, w, 2 * c, dtype=fl.dtype, device=fl.device)
    status = _kernel("ecm_cost_volume_concat")(
        fl.data_ptr(), fr.data_ptr(), out.data_ptr(), b, h, w,
        c * fl.element_size(), max_disp, d_start, torch.cuda.current_stream(fl.device).cuda_stream,
    )
    check(status, "cost_volume_concat")
    cost_volume_concat.launches += 1
    return out


def _correlation_smem(c: int, max_disp: int) -> int:
    """Shared memory of the correlation kernel (``cost_volume.cu``): fr's
    tile and halo, then fl's tile, rows of CP + 2 f32 words, CP the power of
    2 from 8 to 64 at or above C."""
    cp = max(8, 1 << (c - 1).bit_length())
    return ((64 + max_disp + 2) // 2 * 2 + 64) * (cp + 2) * 4


_CORR_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _correlation_forward(fl, fr, max_disp, d_start, groups=1):
    if fl.device.type == "cpu":
        return _correlation_volume(fl, fr, max_disp, d_start, groups)
    if fl.dtype not in _CORR_DTYPES:
        raise ValueError(f"cost_volume_correlation takes float32, bfloat16 or float16, got {fl.dtype}")
    _check_cuda(fl, fr)
    b, h, w, c = fl.shape
    if c // groups > 64 or _correlation_smem(c // groups, max_disp) > SMEM_PER_BLOCK:
        raise ValueError(f"cost_volume_correlation takes C / groups <= 64 and D within shared memory, got "
                         f"{c} / {groups}, {max_disp}")
    out = torch.empty(b, max_disp, h, w, groups, dtype=fl.dtype, device=fl.device)
    status = _kernel("ecm_cost_volume_correlation")(
        _CORR_DTYPES[fl.dtype], fl.data_ptr(), fr.data_ptr(), out.data_ptr(),
        b, h, w, c, max_disp, d_start, groups, torch.cuda.current_stream(fl.device).cuda_stream,
    )
    check(status, "cost_volume_correlation")
    if groups == 1:
        cost_volume_correlation.launches += 1
    else:
        cost_volume_correlation.group_launches += 1
    return out


def _no_group_vjp(g, fl, fr, max_disp, d_start):
    raise NotImplementedError("the group-wise correlation volume (groups > 1) has no backward")


def _correlation_parts(fl: torch.Tensor, groups: int, forward):
    """The volume's forward and VJP for ``groups``: ECM's closed-form VJP at
    1, none above."""
    if groups < 1 or fl.shape[-1] % groups:
        raise ValueError(f"groups {groups} does not divide the {fl.shape[-1]} channels")
    if groups == 1:
        return forward, _correlation_vjp
    return functools.partial(forward, groups=groups), _no_group_vjp


class _CostVolume(torch.autograd.Function):
    """A volume built by ``forward`` (a kernel's wrapper or a plain
    builder) whose backward is the closed-form ``vjp``: no volume is rebuilt
    or copied under autograd."""

    @staticmethod
    def forward(ctx, fl, fr, max_disp, d_start, forward, vjp):
        ctx.save_for_backward(fl, fr)
        ctx.max_disp, ctx.d_start, ctx.vjp = max_disp, d_start, vjp
        return forward(fl, fr, max_disp, d_start)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        fl, fr = ctx.saved_tensors
        return (*ctx.vjp(g, fl, fr, ctx.max_disp, ctx.d_start), None, None, None, None)


def _check_range(max_disp: int, d_start: int) -> None:
    if max_disp < 1 or d_start < 0:
        raise ValueError(f"a volume of {max_disp} planes from disparity {d_start}")


def cost_volume_concat_torch(fl: torch.Tensor, fr: torch.Tensor, max_disp: int, d_start: int = 0) -> torch.Tensor:
    """Plain PyTorch concat volume (the CPU path and the kernel's
    reference), by slice assignment: ``max_disp`` planes from disparity
    ``d_start``; differentiable through its closed-form VJP."""
    _check_range(max_disp, d_start)
    return _CostVolume.apply(fl, fr, max_disp, d_start, _concat_volume, _concat_vjp)


def cost_volume_correlation_torch(
    fl: torch.Tensor, fr: torch.Tensor, max_disp: int, d_start: int = 0, groups: int = 1
) -> torch.Tensor:
    """Plain PyTorch correlation volume (the CPU path and the kernel's
    reference): ``max_disp`` planes from disparity ``d_start``, ``groups``
    means, products and means in f32, rounded to fl's dtype; differentiable
    through its closed-form VJP at ``groups`` 1."""
    _check_range(max_disp, d_start)
    return _CostVolume.apply(fl, fr, max_disp, d_start, *_correlation_parts(fl, groups, _correlation_volume))


def cost_volume_concat(fl: torch.Tensor, fr: torch.Tensor, max_disp: int, d_start: int = 0) -> torch.Tensor:
    """Concat volume of ``max_disp`` planes from disparity ``d_start``
    through the CUDA kernel for CUDA tensors; the plain version for CPU
    tensors. Differentiable. Counts its launches in ``.launches``."""
    _check(fl, fr)
    _check_range(max_disp, d_start)
    return _CostVolume.apply(fl, fr, max_disp, d_start, _concat_forward, _concat_vjp)


def cost_volume_correlation(fl: torch.Tensor, fr: torch.Tensor, max_disp: int, d_start: int = 0,
                            groups: int = 1) -> torch.Tensor:
    """Correlation volume of ``max_disp`` planes from disparity ``d_start``,
    ``groups`` groups, through the CUDA kernel for CUDA tensors; the plain
    version for CPU tensors. Differentiable at ``groups`` 1. Counts its
    launches in ``.launches`` (``groups`` 1) and ``.group_launches``."""
    _check(fl, fr)
    _check_range(max_disp, d_start)
    return _CostVolume.apply(fl, fr, max_disp, d_start, *_correlation_parts(fl, groups, _correlation_forward))


cost_volume_concat.launches = 0
cost_volume_correlation.launches = 0
cost_volume_correlation.group_launches = 0
