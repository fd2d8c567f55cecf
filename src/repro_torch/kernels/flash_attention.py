"""Flash attention with GQA, causal mask, sliding window and ``q_offset``:
the wrapper of the hand-written Hopper kernel in
``csrc/flash_attention.cu`` (counterpart of
``repro/kernels/flash_attention.py``).

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version ``ref.attention_ref``.  There is no fallback between the two.  The
layout is the reference's, ``(B, H, S, Dh)``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import ref
from .build import load_library

__all__ = ["flash_attention", "flash_attention_plain", "HEAD_DIMS",
           "flash_launch_count", "reset_flash_launch_count"]

HEAD_DIMS = (32, 64, 128)       # head sizes the kernel is instantiated for
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# launches of the CUDA kernel, bumped once per launch and nowhere else
_LAUNCHES = 0


def flash_launch_count() -> int:
    """Launches of the ``flash_attention_fwd`` kernel."""
    return _LAUNCHES


def reset_flash_launch_count() -> None:
    global _LAUNCHES
    _LAUNCHES = 0


def flash_attention_plain(q, k, v, *, causal=True, window=None, q_offset=0):
    """The plain PyTorch version: the dense oracle ``ref.attention_ref``."""
    return ref.attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)


def _check(q, k, v, window) -> None:
    """Shapes, types and devices every input must have, on either device."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention takes q (B, Hq, Sq, Dh) and k, v "
                         f"(B, Hkv, Sk, Dh); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, _, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or hq % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}"
                         " (same B and Dh, Hq a multiple of Hkv)")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v must lie on one device, got {q.device}, "
                         f"{k.device}, {v.device}")
    if window is not None and window < 0:
        raise ValueError(f"window must be None or >= 0, got {window}")


def _check_kernel_inputs(q, k, v) -> None:
    """What the CUDA kernel additionally needs."""
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the flash attention kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"the flash attention kernel takes head sizes "
                         f"{HEAD_DIMS}, got {q.shape[3]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash attention kernel: {name} must be "
                             "contiguous")


@functools.cache
def _kernel_fn():
    fn = load_library("flash_attention").flash_attention_fwd
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i32, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32,
                   i32, i32, ctypes.c_float, vp]
    fn.restype = i32
    return fn


def _launch(q, k, v, causal, window, q_offset) -> torch.Tensor:
    global _LAUNCHES
    _check_kernel_inputs(q, k, v)
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), b, hq, hkv, sq, sk, dh,
                 int(bool(causal)), -1 if window is None else int(window),
                 int(q_offset), 1.0 / math.sqrt(dh), stream)
    _LAUNCHES += 1
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed with "
                           f"CUDA error {err}")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention ``(B, Hq, Sq, Dh)`` in q's dtype.

    Query head h reads KV head ``h // (Hq // Hkv)``; query row i sits at
    absolute position ``q_offset + i`` and sees key j < Sk when ``j <= pos``
    (``causal``) and ``j > pos - window`` (``window``); a row that sees no
    key is 0.  A CUDA ``q`` launches the kernel, a CPU ``q`` runs
    :func:`flash_attention_plain`.
    """
    _check(q, k, v, window)
    if q.is_cuda:
        return _launch(q, k, v, causal, window, q_offset)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
