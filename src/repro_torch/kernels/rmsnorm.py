"""Fused RMSNorm: the wrapper of the hand-written Hopper kernel in
``csrc/rmsnorm.cu`` (counterpart of ``repro/kernels/rmsnorm.py``).

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version ``ref.rmsnorm_ref``.  There is no fallback between the two.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import ref
from .build import load_library

__all__ = ["rmsnorm", "rmsnorm_plain", "rmsnorm_launch_count",
           "reset_rmsnorm_launch_count"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# launches of the CUDA kernel, bumped once per launch and nowhere else
_LAUNCHES = 0


def rmsnorm_launch_count() -> int:
    """Launches of the ``rmsnorm_fwd`` kernel."""
    return _LAUNCHES


def reset_rmsnorm_launch_count() -> None:
    global _LAUNCHES
    _LAUNCHES = 0


def rmsnorm_plain(x, weight, *, eps=1e-6):
    """The plain PyTorch version: the oracle ``ref.rmsnorm_ref``."""
    return ref.rmsnorm_ref(x, weight, eps=eps)


@functools.cache
def _kernel_fn():
    fn = load_library("rmsnorm").rmsnorm_fwd
    vp = ctypes.c_void_p
    fn.argtypes = [ctypes.c_int, vp, vp, vp, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_float, vp]
    fn.restype = ctypes.c_int
    return fn


def _launch(x, weight, eps) -> torch.Tensor:
    global _LAUNCHES
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the rmsnorm kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("rmsnorm kernel: x must be contiguous")
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    out = torch.empty_like(x)
    if rows == 0 or d == 0:
        return out
    w = weight.to(torch.float32).contiguous()
    fn = _kernel_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
                 out.data_ptr(), rows, d, float(eps), stream)
    _LAUNCHES += 1
    if err != 0:
        raise RuntimeError(f"rmsnorm_fwd kernel launch failed with CUDA "
                           f"error {err}")
    return out


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """``x · rsqrt(mean(x²) + eps) · weight`` over the last dim, f32 math,
    output in x's dtype.  A CUDA ``x`` launches the kernel, a CPU ``x``
    runs :func:`rmsnorm_plain`."""
    if weight.shape != x.shape[-1:]:
        raise ValueError(f"weight {tuple(weight.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    if weight.device != x.device:
        raise ValueError(f"x and weight must lie on one device, got "
                         f"{x.device}, {weight.device}")
    if x.is_cuda:
        return _launch(x, weight, eps)
    if x.device.type != "cpu":
        raise ValueError(f"rmsnorm runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    return rmsnorm_plain(x, weight, eps=eps)
