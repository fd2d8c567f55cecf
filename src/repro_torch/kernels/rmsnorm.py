"""RMSNorm, alone or with the residual add fused in front of it: the
wrappers of the hand-written Hopper kernels in ``csrc/rmsnorm.cu``
(counterpart of ``repro/kernels/rmsnorm.py``).

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version (``ref.rmsnorm_ref``, after a plain add for :func:`add_rmsnorm`).
There is no fallback between the two.  A meta tensor gives the outputs'
shapes (no data), and every route reports ``kernels/work.py``'s formulas
to a step counter.

Training: where autograd needs a gradient, a CUDA call goes through
:class:`RMSNormFn` or :class:`AddRMSNormFn`, whose forward is the kernel
above and whose backward is the hand-written ``rmsnorm_bwd`` of the same
source (:func:`rmsnorm_bwd`); a CPU call runs the plain version under
autograd.  The reference differentiates its plain ``norm_apply`` with
autodiff; the backward computes that gradient.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import ref, work
from .build import load_library, ticket_counters

__all__ = ["rmsnorm", "rmsnorm_plain", "add_rmsnorm", "add_rmsnorm_plain",
           "rmsnorm_bwd", "RMSNormFn", "AddRMSNormFn", "BWD_MAX_D",
           "rmsnorm_launch_count", "add_rmsnorm_launch_count",
           "rmsnorm_bwd_launch_count", "add_rmsnorm_bwd_launch_count",
           "reset_rmsnorm_launch_count"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# the backward's widest row (columns a thread keeps x threads a block)
BWD_MAX_D = 8192
# blocks of the backward per SM (two 8-warp blocks stay resident; each
# writes one partial dw row)
_BWD_BLOCKS_PER_SM = 2

# launches of the CUDA kernels, bumped once per launch and nowhere else:
# both forward entry points, and the fused one alone; the backward, and its
# fused use alone
_LAUNCHES = 0
_FUSED_LAUNCHES = 0
_BWD_LAUNCHES = 0
_FUSED_BWD_LAUNCHES = 0


def rmsnorm_launch_count() -> int:
    """Launches of either entry point, ``rmsnorm_fwd`` or
    ``add_rmsnorm_fwd``."""
    return _LAUNCHES


def add_rmsnorm_launch_count() -> int:
    """Launches of the fused ``add_rmsnorm_fwd`` alone."""
    return _FUSED_LAUNCHES


def rmsnorm_bwd_launch_count() -> int:
    """Launches of the backward ``rmsnorm_bwd``, for either entry point."""
    return _BWD_LAUNCHES


def add_rmsnorm_bwd_launch_count() -> int:
    """Launches of the backward for the fused entry point alone."""
    return _FUSED_BWD_LAUNCHES


def reset_rmsnorm_launch_count() -> None:
    """Zero every count, forward and backward."""
    global _LAUNCHES, _FUSED_LAUNCHES, _BWD_LAUNCHES, _FUSED_BWD_LAUNCHES
    _LAUNCHES = _FUSED_LAUNCHES = _BWD_LAUNCHES = _FUSED_BWD_LAUNCHES = 0


def rmsnorm_plain(x, weight, *, eps=1e-6):
    """The plain PyTorch version: the oracle ``ref.rmsnorm_ref``."""
    return ref.rmsnorm_ref(x, weight, eps=eps)


def add_rmsnorm_plain(x, delta, weight, *, eps=1e-6):
    """The plain PyTorch version of :func:`add_rmsnorm`: ``s = x + delta``
    in x's dtype, then ``ref.rmsnorm_ref(s, weight)``."""
    s = x + delta
    return s, ref.rmsnorm_ref(s, weight, eps=eps)


@functools.cache
def _kernel_fns():
    lib = load_library("rmsnorm")
    vp, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                         ctypes.c_float)
    lib.rmsnorm_fwd.argtypes = [i32, vp, vp, vp, i64, i32, f32, vp]
    lib.add_rmsnorm_fwd.argtypes = [i32, vp, vp, vp, vp, vp, i64, i32, f32, vp]
    lib.rmsnorm_bwd.argtypes = [i32] + [vp] * 8 + [i64, i32, i32, i32, f32,
                                                 vp]
    for fn in (lib.rmsnorm_fwd, lib.add_rmsnorm_fwd, lib.rmsnorm_bwd):
        fn.restype = ctypes.c_int
    return lib.rmsnorm_fwd, lib.add_rmsnorm_fwd, lib.rmsnorm_bwd


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class _BwdGrid(NamedTuple):
    """The backward's grid: ``blocks`` blocks, each writing a partial dw
    row, summed in ``groups`` groups of ``group`` consecutive blocks."""
    blocks: int
    group: int
    groups: int


def _bwd_grid(sms: int) -> _BwdGrid:
    """The backward's grid on a card of ``sms`` SMs, whatever the row
    count, so that the order of dw's sum is fixed by the card alone:
    :data:`_BWD_BLOCKS_PER_SM` blocks an SM, in groups of
    ``ceil(sqrt(blocks))``."""
    blocks = _BWD_BLOCKS_PER_SM * sms
    group = math.isqrt(blocks - 1) + 1
    return _BwdGrid(blocks, group, -(-blocks // group))


def _launch(x, delta, weight, eps):
    """Launch ``rmsnorm_fwd`` (``delta`` None; returns y) or
    ``add_rmsnorm_fwd`` (returns ``(s, y)``)."""
    global _LAUNCHES, _FUSED_LAUNCHES
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the rmsnorm kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("rmsnorm kernel: x must be contiguous")
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    y = torch.empty_like(x)
    s = None if delta is None else torch.empty_like(x)
    if rows == 0 or d == 0:
        return y if s is None else (s, y)
    w = weight.to(torch.float32).contiguous()
    plain_fn, fused_fn, _ = _kernel_fns()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if s is None:
            err = plain_fn(_DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
                           y.data_ptr(), rows, d, float(eps), stream)
        else:
            err = fused_fn(_DTYPE_CODES[x.dtype], x.data_ptr(),
                           delta.data_ptr(), w.data_ptr(), s.data_ptr(),
                           y.data_ptr(), rows, d, float(eps), stream)
    _LAUNCHES += 1
    if s is not None:
        _FUSED_LAUNCHES += 1
    if err != 0:
        name = "rmsnorm_fwd" if s is None else "add_rmsnorm_fwd"
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{err}")
    return y if s is None else (s, y)


def rmsnorm_bwd(s, dy, weight, ds_in=None, *, eps=1e-6):
    """The backward kernel: ``(ds, dw)`` for the norm of ``s`` (the plain
    norm's x, or the fused entry point's rounded sum) given the gradient
    ``dy`` of its output and, for the fused entry point, ``ds_in``, the
    gradient of its output s (None: absent).  ``ds`` is in s's dtype (the
    gradient of x, and for the fused entry point of delta too), ``dw``
    float32.  CUDA tensors only; raises on what the kernel cannot take."""
    global _BWD_LAUNCHES, _FUSED_BWD_LAUNCHES
    _check(s, weight)
    if not s.is_cuda:
        raise ValueError("rmsnorm_bwd launches the CUDA kernel; the CPU "
                         "trains through the plain version")
    if s.dtype not in _DTYPE_CODES:
        raise TypeError(f"the rmsnorm kernel takes float32 or bfloat16, got "
                        f"{s.dtype}")
    for name, t in (("dy", dy), ("ds_in", ds_in)):
        if t is not None and (t.shape != s.shape or t.dtype != s.dtype
                              or t.device != s.device):
            raise ValueError(f"rmsnorm_bwd: {name} must share s's shape, "
                             f"dtype and device, got {tuple(t.shape)} "
                             f"{t.dtype} {t.device}")
    d = s.shape[-1]
    if d > BWD_MAX_D:
        raise ValueError(f"the rmsnorm backward kernel takes rows of at most "
                         f"{BWD_MAX_D} elements, got {d}")
    s, dy = s.contiguous(), dy.contiguous()
    ds_in = None if ds_in is None else ds_in.contiguous()
    rows = s.numel() // d if d else 0
    ds = torch.empty_like(s)
    if rows == 0 or d == 0:
        dw = torch.zeros(d, dtype=torch.float32, device=s.device)
        return (ds if ds_in is None else ds.copy_(ds_in)), dw
    dw = torch.empty(d, dtype=torch.float32, device=s.device)
    w = weight.to(torch.float32).contiguous()
    grid = _bwd_grid(_sm_count(s.device.index))
    part = torch.empty((grid.blocks + grid.groups, d), dtype=torch.float32,
                       device=s.device)
    # a ticket per group of blocks, and one for the groups
    counters = ticket_counters("rmsnorm_bwd", s.device, grid.groups + 1)
    *_, bwd_fn = _kernel_fns()
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        err = bwd_fn(_DTYPE_CODES[s.dtype], s.data_ptr(), dy.data_ptr(),
                     None if ds_in is None else ds_in.data_ptr(),
                     w.data_ptr(), ds.data_ptr(), part.data_ptr(),
                     dw.data_ptr(), counters.data_ptr(), rows, d,
                     grid.blocks, grid.group, float(eps), stream)
    _BWD_LAUNCHES += 1
    if ds_in is not None:
        _FUSED_BWD_LAUNCHES += 1
    if err != 0:
        raise RuntimeError(f"rmsnorm_bwd kernel launch failed with CUDA "
                           f"error {err}")
    return ds, dw


class RMSNormFn(torch.autograd.Function):
    """:func:`rmsnorm` on CUDA tensors with the hand-written backward: the
    forward kernel saves x and the weight, :func:`rmsnorm_bwd` gives
    ``(dx, dw)``."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        with work.block(_work, x, False):
            return _launch(x, None, weight, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        with work.block(_bwd_work, x, False):
            dx, dw = rmsnorm_bwd(x, dy, weight, eps=ctx.eps)
        return dx, dw.to(weight.dtype), None


class AddRMSNormFn(torch.autograd.Function):
    """:func:`add_rmsnorm` on CUDA tensors with the hand-written backward:
    the forward kernel saves the rounded sum s and the weight;
    :func:`rmsnorm_bwd` adds s's own gradient (the residual stream's) to the
    norm's and returns it as the gradient of both x and delta."""

    @staticmethod
    def forward(ctx, x, delta, weight, eps):
        with work.block(_work, x, True):
            s, y = _launch(x, delta, weight, eps)
        ctx.save_for_backward(s, weight)
        ctx.eps = eps
        ctx.set_materialize_grads(False)
        return s, y

    @staticmethod
    def backward(ctx, ds_out, dy):
        s, weight = ctx.saved_tensors
        if dy is None:      # y unused: s's gradient passes straight through
            return ds_out, ds_out, None, None
        with work.block(_bwd_work, s, True):
            ds, dw = rmsnorm_bwd(s, dy, weight, ds_out, eps=ctx.eps)
        return ds, ds, dw.to(weight.dtype), None


def _work(x, fused):
    """``kernel_work``'s ``(name, work)`` of a forward of either entry
    point."""
    return (("add_rmsnorm" if fused else "rmsnorm"),
            lambda: work.rmsnorm_work(x.numel(), x.shape[-1],
                                      x.element_size(), fused=fused))


def _bwd_work(x, fused):
    return (("add_rmsnorm_bwd" if fused else "rmsnorm_bwd"),
            lambda: work.rmsnorm_bwd_work(x.numel(), x.shape[-1],
                                          x.element_size(), fused=fused))


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _check(x, weight):
    if weight.shape != x.shape[-1:]:
        raise ValueError(f"weight {tuple(weight.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    if weight.device != x.device:
        raise ValueError(f"x and weight must lie on one device, got "
                         f"{x.device}, {weight.device}")
    if not x.is_cuda and x.device.type not in ("cpu", "meta"):
        raise ValueError(f"rmsnorm runs on CUDA, CPU or meta tensors, got "
                         f"{x.device}")


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """``x · rsqrt(mean(x²) + eps) · weight`` over the last dim, f32 math,
    output in x's dtype.  A CUDA ``x`` launches the kernel (through
    :class:`RMSNormFn` where autograd needs a gradient), a CPU ``x`` runs
    :func:`rmsnorm_plain`, a meta ``x`` gives the output's shape."""
    _check(x, weight)
    if x.is_cuda:
        if _needs_grad(x, weight):
            return RMSNormFn.apply(x, weight, eps)
        with work.block(_work, x, False):
            return _launch(x, None, weight, eps)
    if x.device.type == "meta":
        return work.counted(_work(x, False), _bwd_work(x, False),
                            lambda x, w: torch.empty_like(x), x, weight)

    def plain(x, w):
        return rmsnorm_plain(x, w, eps=eps)

    if not work.counting():
        return plain(x, weight)
    return work.counted(_work(x, False), _bwd_work(x, False), plain, x,
                        weight)


def add_rmsnorm(x: torch.Tensor, delta: torch.Tensor, weight: torch.Tensor,
                *, eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """The residual add and the norm after it in one pass: ``s = x + delta``
    rounded to x's dtype, and ``y = rmsnorm(s, weight)`` taken from that
    rounded ``s``; returns ``(s, y)``.  x and delta share shape, dtype and
    device and are contiguous.  CUDA tensors launch the kernel (through
    :class:`AddRMSNormFn` where autograd needs a gradient), CPU tensors run
    :func:`add_rmsnorm_plain`, meta tensors give the outputs' shapes."""
    if (delta.shape != x.shape or delta.dtype != x.dtype
            or delta.device != x.device):
        raise ValueError(
            f"x and delta must share shape, dtype and device, got "
            f"{tuple(x.shape)} {x.dtype} {x.device} and "
            f"{tuple(delta.shape)} {delta.dtype} {delta.device}")
    if not (x.is_contiguous() and delta.is_contiguous()):
        raise ValueError("add_rmsnorm: x and delta must be contiguous")
    _check(x, weight)
    if x.is_cuda:
        if _needs_grad(x, delta, weight):
            return AddRMSNormFn.apply(x, delta, weight, eps)
        with work.block(_work, x, True):
            return _launch(x, delta, weight, eps)
    if x.device.type == "meta":
        return work.counted(_work(x, True), _bwd_work(x, True),
                            lambda x, d, w: (torch.empty_like(x),
                                             torch.empty_like(x)),
                            x, delta, weight)

    def plain(x, d, w):
        return add_rmsnorm_plain(x, d, w, eps=eps)

    if not work.counting():
        return plain(x, delta, weight)
    return work.counted(_work(x, True), _bwd_work(x, True), plain, x, delta,
                        weight)
