"""RMSNorm, alone or with the residual add fused in front of it: the
wrappers of the hand-written Hopper kernels in ``csrc/rmsnorm.cu``
(counterpart of ``repro/kernels/rmsnorm.py``).

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version (``ref.rmsnorm_ref``, after a plain add for :func:`add_rmsnorm`).
There is no fallback between the two.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import ref
from .build import load_library

__all__ = ["rmsnorm", "rmsnorm_plain", "add_rmsnorm", "add_rmsnorm_plain",
           "rmsnorm_launch_count", "add_rmsnorm_launch_count",
           "reset_rmsnorm_launch_count"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# launches of the CUDA kernels, bumped once per launch and nowhere else:
# both entry points, and the fused one alone
_LAUNCHES = 0
_FUSED_LAUNCHES = 0


def rmsnorm_launch_count() -> int:
    """Launches of either entry point, ``rmsnorm_fwd`` or
    ``add_rmsnorm_fwd``."""
    return _LAUNCHES


def add_rmsnorm_launch_count() -> int:
    """Launches of the fused ``add_rmsnorm_fwd`` alone."""
    return _FUSED_LAUNCHES


def reset_rmsnorm_launch_count() -> None:
    """Zero both counts."""
    global _LAUNCHES, _FUSED_LAUNCHES
    _LAUNCHES = _FUSED_LAUNCHES = 0


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
    for fn in (lib.rmsnorm_fwd, lib.add_rmsnorm_fwd):
        fn.restype = ctypes.c_int
    return lib.rmsnorm_fwd, lib.add_rmsnorm_fwd


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
    plain_fn, fused_fn = _kernel_fns()
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


def _check(x, weight):
    if weight.shape != x.shape[-1:]:
        raise ValueError(f"weight {tuple(weight.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    if weight.device != x.device:
        raise ValueError(f"x and weight must lie on one device, got "
                         f"{x.device}, {weight.device}")
    if not x.is_cuda and x.device.type != "cpu":
        raise ValueError(f"rmsnorm runs on CUDA or CPU tensors, got "
                         f"{x.device}")


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """``x · rsqrt(mean(x²) + eps) · weight`` over the last dim, f32 math,
    output in x's dtype.  A CUDA ``x`` launches the kernel, a CPU ``x``
    runs :func:`rmsnorm_plain`."""
    _check(x, weight)
    if x.is_cuda:
        return _launch(x, None, weight, eps)
    return rmsnorm_plain(x, weight, eps=eps)


def add_rmsnorm(x: torch.Tensor, delta: torch.Tensor, weight: torch.Tensor,
                *, eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """The residual add and the norm after it in one pass: ``s = x + delta``
    rounded to x's dtype, and ``y = rmsnorm(s, weight)`` taken from that
    rounded ``s``; returns ``(s, y)``.  x and delta share shape, dtype and
    device and are contiguous.  CUDA tensors launch the kernel, CPU tensors
    run :func:`add_rmsnorm_plain`."""
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
        return _launch(x, delta, weight, eps)
    return add_rmsnorm_plain(x, delta, weight, eps=eps)
