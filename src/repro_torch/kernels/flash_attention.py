"""Flash attention with GQA, causal mask, sliding window, a bidirectional
prefix and ``q_offset``: the wrapper of the hand-written Hopper kernels in
``csrc/flash_attention.cu`` (counterpart of
``repro/kernels/flash_attention.py``, whose Pallas kernel has no prefix: the
prefix-LM mask is the reference's ``chunked_attention(prefix_len=)``).

A CUDA tensor launches a kernel (or raises); a CPU tensor takes the plain
version ``ref.attention_ref``.  There is no fallback between the two.  A
meta tensor gives the output's shape (no data), and every route reports
``kernels/work.py``'s formulas to a step counter.  The
layout is the reference's, ``(B, H, S, Dh)``, Dh in :data:`HEAD_DIMS`.
:func:`plan` picks the kernel's design on the host: a decode query
(``Sq == 1``, at most :data:`DECODE_MAX_GROUP` query heads per KV head, no
prefix) is split over the live key range, anything else runs the prefill
design (tensor cores in bf16, CUDA cores in f32).

Training: where autograd needs a gradient (grad mode on and q, k or v
requiring one), a CUDA call goes through :class:`FlashAttentionFn`, whose
forward is the prefill design writing each row's log-sum-exp beside the
output and whose backward is the hand-written kernel of
``csrc/flash_attention_bwd.cu`` (:func:`flash_attention_lse` and
:func:`flash_attention_bwd` are the two launches); a CPU call
runs the plain version under autograd.  The reference has no backward of
its Pallas kernel: it trains through the pure-JAX ``chunked_attention``,
whose gradient JAX's autodiff computes, and the backward computes that
gradient, with every head size of :data:`HEAD_DIMS`, a prefix, and
``Sq != Sk`` (cross-attention).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import ref, work
from .build import load_library, ticket_counters

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_lse",
           "flash_attention_bwd", "FlashAttentionFn", "HEAD_DIMS", "Plan",
           "plan", "bwd_part_elems", "bwd_counter_elems",
           "flash_launch_count", "reset_flash_launch_count"]

# head sizes the kernels (the forward's prefill and decode designs, the
# backward) are instantiated for
HEAD_DIMS = (32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# query heads per KV head a decode block takes (kDMaxRows in the kernel)
DECODE_MAX_GROUP = 16
DECODE_MIN_CHUNK = 32   # fewest keys one decode split walks
DECODE_WAVES = 2        # decode blocks per SM the split count aims at

# calls that launched a kernel, by design, bumped once per call and
# nowhere else: serving's prefill and decode designs, the training forward
# (the prefill design writing the log-sum-exp) and the backward
_LAUNCHES = {"prefill": 0, "decode": 0, "train": 0, "backward": 0}


def flash_launch_count(design: str | None = None) -> int:
    """Calls that launched a flash attention kernel: of one design
    (``"prefill"``, ``"decode"``, ``"train"`` for the training forward,
    ``"backward"``), or of all."""
    return sum(_LAUNCHES.values()) if design is None else _LAUNCHES[design]


def reset_flash_launch_count() -> None:
    for key in _LAUNCHES:
        _LAUNCHES[key] = 0


class Plan(NamedTuple):
    """The kernel design of one call; for ``"decode"`` also the live key
    range ``[k_lo, k_hi)`` and its cut into ``n_split`` chunks of
    ``chunk`` keys (the last may be shorter, an empty range has one empty
    split)."""
    design: str
    k_lo: int = 0
    k_hi: int = 0
    chunk: int = 0
    n_split: int = 0


def plan(q_shape, k_shape, *, causal: bool, window: int | None,
         q_offset: int, sms: int, prefix_len: int = 0) -> Plan:
    """Pick the design for q ``(B, Hq, Sq, Dh)`` against k ``(B, Hkv, Sk,
    Dh)`` on a card with ``sms`` SMs.  Decode splits the live keys of its
    single query position so that ``B * Hkv * n_split`` blocks fill about
    :data:`DECODE_WAVES` waves, each walking at least
    :data:`DECODE_MIN_CHUNK` keys; a prefix (which the decode design does
    not take: its live keys need not be one range) runs the prefill
    design."""
    b, hq, sq = q_shape[:3]
    hkv, sk = k_shape[1], k_shape[2]
    if sq != 1 or hq // hkv > DECODE_MAX_GROUP or prefix_len > 0:
        return Plan("prefill")
    k_hi = min(sk, q_offset + 1) if causal else sk
    k_lo = 0 if window is None else max(0, q_offset - window + 1)
    live = max(0, k_hi - k_lo)
    want = -(-DECODE_WAVES * sms // (b * hkv))
    chunk = max(DECODE_MIN_CHUNK, -(-live // want))
    return Plan("decode", k_lo, k_hi, chunk, max(1, -(-live // chunk)))


def flash_attention_plain(q, k, v, *, causal=True, window=None, q_offset=0,
                          prefix_len=0):
    """The plain PyTorch version: the dense oracle ``ref.attention_ref``."""
    return ref.attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, prefix_len=prefix_len)


def _check(q, k, v, window, prefix_len=0) -> None:
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
    if prefix_len < 0:
        raise ValueError(f"prefix_len must be >= 0, got {prefix_len}")


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
def _kernel_fns():
    lib = load_library("flash_attention")
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    prefill, decode = lib.flash_attention_fwd, lib.flash_decode_fwd
    prefill.argtypes = [i32, vp, vp, vp, vp, vp] + [i32] * 10 + [f32, vp]
    decode.argtypes = [i32, vp, vp, vp, vp, vp] + [i32] * 9 + [f32, vp]
    prefill.restype = decode.restype = i32
    return prefill, decode


@functools.cache
def _bwd_fn():
    fn = load_library("flash_attention_bwd").flash_attention_bwd
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [i32] + [vp] * 13 + [i32] * 10 + [f32, vp]
    fn.restype = i32
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(q, k, v, causal, window, q_offset, lse=None,
            prefix_len=0) -> torch.Tensor:
    """One forward launch; with ``lse`` (a ``(B, Hq, Sq)`` float32 buffer)
    the prefill design also writes each row's log-sum-exp there and counts
    as a training forward."""
    _check_kernel_inputs(q, k, v)
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    p = (Plan("train") if lse is not None else
         plan(q.shape, k.shape, causal=causal, window=window,
              q_offset=q_offset, sms=_sm_count(q.device.index),
              prefix_len=prefix_len))
    prefill, decode = _kernel_fns()
    code, scale = _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(dh)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if p.design == "decode":
            # per split and row: acc[dh], then (m, l)
            part = torch.empty(b * hkv * p.n_split * (hq // hkv) * (dh + 2),
                               dtype=torch.float32, device=q.device)
            err = decode(code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), part.data_ptr(), b, hq, hkv, sk, dh,
                         p.k_lo, p.k_hi, p.chunk, p.n_split, scale, stream)
        else:
            err = prefill(code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(),
                          None if lse is None else lse.data_ptr(),
                          b, hq, hkv, sq, sk, dh,
                          int(bool(causal)),
                          -1 if window is None else int(window),
                          int(prefix_len), int(q_offset), scale, stream)
    _LAUNCHES[p.design] += 1
    if err != 0:
        raise RuntimeError(f"flash attention {p.design} kernel launch failed "
                           f"with CUDA error {err}")
    return out


def bwd_part_elems(q_shape, k_shape, dtype) -> int:
    """float32 elements of each of the two scratch buffers (dK's and dV's
    per-query-head partials, ``(B, Hq, Sk, Dh)``) that the bf16 backward
    sums over each GQA group in head order; 0 where nothing is summed (f32,
    or one query head per KV head)."""
    b, hq, _, dh = q_shape
    hkv, sk = k_shape[1], k_shape[2]
    return b * hq * sk * dh if dtype == torch.bfloat16 and hq != hkv else 0


# rows of a key tile of the bf16 backward's dK/dV grid (kMB in the kernel)
BWD_KEY_TILE = 64


def bwd_counter_elems(q_shape, k_shape, dtype) -> int:
    """Ticket counters the bf16 backward needs for its GQA sum, one per
    (B, KV head, key tile of :data:`BWD_KEY_TILE`); 0 where it writes no
    partials (see :func:`bwd_part_elems`)."""
    if not bwd_part_elems(q_shape, k_shape, dtype):
        return 0
    b, hkv, sk = k_shape[0], k_shape[1], k_shape[2]
    return b * hkv * -(-sk // BWD_KEY_TILE)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` (contiguous) on a 16-byte boundary, as the kernels' 16-byte
    copies need: a view at an odd offset is copied into its own buffer."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, window=None,
                        q_offset=0, prefix_len=0):
    """The backward kernel: ``(dq, dk, dv)`` of the forward ``o`` (with its
    log-sum-exp ``lse``, ``(B, Hq, Sq)`` float32) for the output gradient
    ``do``, in the inputs' dtype, under the forward's mask (its first
    ``prefix_len`` keys seen by every query).  CUDA tensors only; raises on
    what the kernel cannot take."""
    _check(q, k, v, window, prefix_len)
    _check_kernel_inputs(q, k, v)
    if not q.is_cuda:
        raise ValueError("flash_attention_bwd launches the CUDA kernel; the "
                         "CPU trains through the plain version")
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if (o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype
            or do.dtype != q.dtype or lse.shape != (b, hq, sq)
            or lse.dtype != torch.float32):
        raise ValueError(f"flash_attention_bwd: o and do must be q's shape "
                         f"and dtype and lse (B, Hq, Sq) float32; got "
                         f"{tuple(o.shape)} {o.dtype}, {tuple(do.shape)} "
                         f"{do.dtype}, {tuple(lse.shape)} {lse.dtype}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    q, k, v, o, do = (_aligned(t.contiguous()) for t in (q, k, v, o, do))
    lse = lse.contiguous()
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    n_part = bwd_part_elems(q.shape, k.shape, q.dtype)
    part = (torch.empty(2 * n_part, dtype=torch.float32, device=q.device)
            if n_part else None)
    dk_part = None if part is None else part.data_ptr()
    dv_part = None if part is None else part.data_ptr() + 4 * n_part
    n_count = bwd_counter_elems(q.shape, k.shape, q.dtype)
    counters = (ticket_counters("flash_attention_bwd", q.device, n_count)
                .data_ptr() if n_count else None)
    fn = _bwd_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), dk_part, dv_part, counters, dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), b, hq, hkv, sq, sk, dh,
                 int(bool(causal)),
                 -1 if window is None else int(window), int(prefix_len),
                 int(q_offset), 1.0 / math.sqrt(dh), stream)
    _LAUNCHES["backward"] += 1
    if err != 0:
        raise RuntimeError(f"flash attention backward kernel launch failed "
                           f"with CUDA error {err}")
    return dq, dk, dv


def flash_attention_lse(q, k, v, *, causal=True, window=None, q_offset=0,
                        prefix_len=0):
    """The training forward kernel: ``(out, lse)``, the prefill design's
    output (bitwise what serving's prefill gives) and each row's
    log-sum-exp of its scaled live scores, ``(B, Hq, Sq)`` float32, -inf
    for a row that sees no key.  CUDA tensors only."""
    _check(q, k, v, window, prefix_len)
    if not q.is_cuda:
        raise ValueError("flash_attention_lse launches the CUDA kernel; the "
                         "CPU trains through the plain version")
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    return _launch(q, k, v, causal, window, q_offset, lse=lse,
                   prefix_len=prefix_len), lse


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention on CUDA tensors with a hand-written backward: the
    forward is the prefill kernel writing each row's log-sum-exp (the
    ``"train"`` launches), and saves q, k, v, the output and the LSE; the
    backward is :func:`flash_attention_bwd`, under the same mask."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, prefix_len=0):
        mask = _mask(causal, window, q_offset, prefix_len)
        with work.block(_work, q, k, mask, True):
            out, lse = flash_attention_lse(q, k, v, **mask)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = mask
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        with work.block(_bwd_work, q, k, ctx.mask):
            dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do,
                                             **ctx.mask)
        return dq, dk, dv, None, None, None, None


def _work(q, k, mask, train):
    """``kernel_work``'s ``(name, work)`` of a forward: the training
    forward (writing the log-sum-exp) or serving's."""
    return (("flash_attention_train" if train else "flash_attention"),
            lambda: work.flash_fwd_work(tuple(q.shape), tuple(k.shape),
                                        q.element_size(), lse=train, **mask))


def _serve_work(q, k, causal, window, q_offset, prefix_len):
    return _work(q, k, _mask(causal, window, q_offset, prefix_len), False)


def _bwd_work(q, k, mask):
    return ("flash_attention_bwd",
            lambda: work.flash_bwd_work(tuple(q.shape), tuple(k.shape),
                                        q.element_size(), **mask))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0, prefix_len: int = 0) -> torch.Tensor:
    """Online-softmax attention ``(B, Hq, Sq, Dh)`` in q's dtype.

    Query head h reads KV head ``h // (Hq // Hkv)``; query row i sits at
    absolute position ``q_offset + i`` and sees key j < Sk when ``j <= pos``
    (``causal``) and ``j > pos - window`` (``window``), or when ``j <
    prefix_len`` (the prefix-LM mask: a prefix every query sees, rescued
    from the causal mask and the window alike); a row that sees no key is
    0.  A CUDA ``q`` launches the kernel (through :class:`FlashAttentionFn`
    where autograd needs a gradient), a CPU ``q`` runs
    :func:`flash_attention_plain` (differentiable as it stands), and a meta
    ``q`` gives the output's shape (no data; its gradients too).  Every
    route reports
    ``kernels/work.py``'s formulas to a step counter.
    """
    _check(q, k, v, window, prefix_len)
    train = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                         or v.requires_grad)
    if q.is_cuda:
        if train:
            return FlashAttentionFn.apply(q, k, v, causal, window, q_offset,
                                          prefix_len)
        with work.block(_serve_work, q, k, causal, window, q_offset,
                        prefix_len):
            return _launch(q, k, v, causal, window, q_offset,
                           prefix_len=prefix_len)
    mask = _mask(causal, window, q_offset, prefix_len)
    if q.device.type == "meta":
        return work.counted(_work(q, k, mask, train), _bwd_work(q, k, mask),
                            lambda q, k, v: torch.empty_like(q), q, k, v)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on CUDA, CPU or meta "
                         f"tensors, got {q.device}")

    def plain(q, k, v):
        return flash_attention_plain(q, k, v, **mask)

    if not work.counting():
        return plain(q, k, v)
    return work.counted(_work(q, k, mask, train), _bwd_work(q, k, mask),
                        plain, q, k, v)


def _mask(causal, window, q_offset, prefix_len):
    return dict(causal=causal, window=window, q_offset=q_offset,
                prefix_len=prefix_len)
