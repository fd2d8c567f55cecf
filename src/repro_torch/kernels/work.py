"""The work each hand-written kernel does, by formula, and the hook through
which its wrapper reports that work to a step counter.

A kernel's work is the least a device must do for the call: each input
read once, each output written once (bytes), and the arithmetic the
function needs on these inputs (FLOPs), counted for this call's data where
the work depends on it (the keys a mask keeps, the real edges of a block
structure).  ``chip_smoke.py`` holds a kernel's time against the bound
these give; ``roofline/analysis.py::StepCounter`` counts a step's work with
them.

:func:`kernel_work` is the hook: a wrapper runs its kernel (on CUDA), its
plain version (on the CPU) or nothing (on the meta device) inside it, and
while a counter is active the counter adds the wrapper's formula and
leaves out the aten ops the wrapper runs inside; so a step counts the same
work whichever of the three runs.  :func:`counted` runs a plain version
(or a meta tensor's shapes) that way under autograd, its backward counted
as the backward kernel.
"""
from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

__all__ = ["flash_live_mask", "flash_live_counts", "flash_fwd_work",
           "flash_bwd_work", "rmsnorm_work", "rmsnorm_bwd_work",
           "segment_fwd_work", "segment_bwd_work", "PLAN_KEYS",
           "kernel_work", "block", "IDLE", "counted", "counting", "register_counter",
           "unregister_counter"]

# the segment kernels' work-plan arrays (kernels/segment_agg.py reads them
# from here)
PLAN_KEYS = ("row_part", "row_work", "row_split", "row_space")


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def flash_live_mask(sq, sk, causal, window, q_offset, prefix_len=0):
    """The dense ``(sq, sk)`` mask of the (query, key) pairs a call keeps:
    key j is live for query i at position ``q_offset + i`` when ``j <= pos``
    (causal), ``j > pos - window`` (window), or ``j < prefix_len``."""
    q_pos = np.arange(sq)[:, None] + q_offset
    k_pos = np.arange(sk)[None, :]
    live = np.ones((sq, sk), bool)
    if causal:
        live &= k_pos <= q_pos
    if window is not None:
        live &= k_pos > q_pos - window
    return live | (k_pos < prefix_len)


@functools.lru_cache(maxsize=256)
def flash_live_counts(sq, sk, causal, window, q_offset, prefix_len=0):
    """``(pairs, live_keys)`` of :func:`flash_live_mask` without building
    it: the live (query, key) pairs of one head, and the keys some query
    sees (the K/V rows a kernel must load), in O(sq + sk)."""
    pos = np.arange(sq, dtype=np.int64) + q_offset
    hi = np.minimum(sk, pos + 1) if causal else np.full(sq, sk, np.int64)
    lo = (np.clip(pos - window + 1, 0, sk) if window is not None
          else np.zeros(sq, np.int64))
    hi = np.maximum(hi, lo)
    pre = min(max(prefix_len, 0), sk)
    # the prefix's keys outside each row's [lo, hi) range
    inside = np.clip(np.minimum(hi, pre) - np.minimum(lo, pre), 0, None)
    pairs = int((hi - lo).sum() + sq * pre - inside.sum())
    cover = np.zeros(sk + 1, np.int64)
    np.add.at(cover, lo, 1)
    np.add.at(cover, hi, -1)
    seen = np.cumsum(cover[:sk]) > 0
    seen[:pre] = sq > 0
    return pairs, int(seen.sum())


def _flash_counts(q_shape, k_shape, causal, window, q_offset, prefix_len):
    b, hq, sq, dh = q_shape
    hkv, sk = k_shape[1], k_shape[2]
    pairs, keys = flash_live_counts(int(sq), int(sk), bool(causal),
                                    None if window is None else int(window),
                                    int(q_offset), int(prefix_len))
    return b * hq * pairs, b * hkv * keys, dh


def flash_fwd_work(q_shape, k_shape, elem: int, *, causal=True, window=None,
                   q_offset=0, prefix_len=0, lse=False):
    """``(flops, bytes)`` of one forward: 4 Dh FLOPs a live pair (the two
    products); q and the live K/V rows read, o written, and the
    log-sum-exp (f32, a row) where the training forward writes it."""
    pairs, kv_rows, dh = _flash_counts(q_shape, k_shape, causal, window,
                                       q_offset, prefix_len)
    q_numel = int(np.prod(q_shape))
    nbytes = (2 * q_numel + 2 * kv_rows * dh) * elem
    if lse:
        nbytes += q_numel // dh * 4
    return 4.0 * dh * pairs, nbytes


def flash_bwd_work(q_shape, k_shape, elem: int, *, causal=True, window=None,
                   q_offset=0, prefix_len=0):
    """``(flops, bytes)`` of one backward: 10 Dh FLOPs a live pair (S, dP,
    dV, dK, dQ); q, o, dO, the log-sum-exp and the live K/V rows read, dq,
    dk and dv written."""
    pairs, kv_rows, dh = _flash_counts(q_shape, k_shape, causal, window,
                                       q_offset, prefix_len)
    q_numel, k_numel = int(np.prod(q_shape)), int(np.prod(k_shape))
    nbytes = ((4 * q_numel + 2 * kv_rows * dh + 2 * k_numel) * elem
              + q_numel // dh * 4)
    return 10.0 * dh * pairs, nbytes


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_work(numel: int, d: int, elem: int, *, fused=False):
    """``(flops, bytes)`` of one forward: x (and delta) read, y (and s)
    written, the f32 weight read; a square, a sum and two products an
    element (and the add)."""
    arrays = 4 if fused else 2
    return (5.0 if fused else 4.0) * numel, arrays * numel * elem + d * 4


def rmsnorm_bwd_work(numel: int, d: int, elem: int, *, fused=False):
    """``(flops, bytes)`` of one backward: s, dy (and the sum's own
    gradient) and the weight read, ds and the f32 dw written; about ten
    FLOPs an element."""
    arrays = 4 if fused else 3
    return 10.0 * numel, arrays * numel * elem + 2 * 4 * d


# ---------------------------------------------------------------------------
# the segment mean
# ---------------------------------------------------------------------------

def _nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return np.asarray(a).nbytes


def _numel(a) -> int:
    return a.numel() if isinstance(a, torch.Tensor) else np.asarray(a).size


def _real(mask) -> int:
    if isinstance(mask, torch.Tensor):
        return int((mask > 0).sum())
    return int((np.asarray(mask) > 0).sum())


def _plan_bytes(blocks, prefix: str) -> int:
    return sum(_nbytes(blocks[prefix + k]) for k in PLAN_KEYS
               if prefix + k in blocks)


def segment_fwd_work(x_shape, elem: int, blocks, num_rows: int):
    """``(flops, bytes)`` of one forward launch over ``blocks`` (host
    arrays or tensors on the CPU or the card; their masks name the real
    edges): x read, the ``(P?, num_rows, D)`` output written, each real
    edge's source (int64) and mask (f32), the work plan and deg read; 2
    FLOPs a real edge and feature."""
    real = _real(blocks["mask"])
    parts = x_shape[0] if len(x_shape) == 3 else 1
    d = x_shape[-1]
    nbytes = (int(np.prod(x_shape)) * elem + parts * num_rows * d * elem
              + real * (8 + 4) + _plan_bytes(blocks, "")
              + _numel(blocks["deg"]) * 4)
    return 2.0 * real * d, nbytes


def segment_bwd_work(g_shape, elem: int, blocks, n_in: int):
    """``(flops, bytes)`` of one backward launch: g read, dx written, the
    real transpose slots (``t_src`` int64, ``t_mask`` f32), the transpose
    work plan and deg read; a divide per placed forward row and feature,
    a multiply and an add per real edge and feature."""
    real = _real(blocks["t_mask"])
    parts = g_shape[0] if len(g_shape) == 3 else 1
    d = g_shape[-1]
    deg = _numel(blocks["deg"])
    nbytes = (int(np.prod(g_shape)) * elem + parts * n_in * d * elem
              + real * (8 + 4) + _plan_bytes(blocks, "t_") + deg * 4)
    return 2.0 * real * d + deg * d, nbytes


# ---------------------------------------------------------------------------
# the hook
# ---------------------------------------------------------------------------

_COUNTERS: list = []


def register_counter(counter) -> None:
    """Make ``counter`` (an object with ``add_kernel(name, flops, bytes)``
    and a ``suspended`` depth) receive the wrappers' work."""
    _COUNTERS.append(counter)


def unregister_counter(counter) -> None:
    _COUNTERS.remove(counter)


def counting() -> bool:
    """True while some counter is registered."""
    return bool(_COUNTERS)


IDLE = contextlib.nullcontext()


def block(spec_of, *args):
    """The context a wrapper runs its kernel in: :func:`kernel_work` of
    ``spec_of(*args)`` (a ``(name, work)`` pair) while a counter is
    registered, else the shared no-op :data:`IDLE`, so an uncounted launch
    builds no spec, closure or generator."""
    return kernel_work(*spec_of(*args)) if _COUNTERS else IDLE


@contextlib.contextmanager
def kernel_work(name: str, work):
    """Run the block as kernel ``name``: with a counter registered, add
    ``work()`` (``(flops, bytes)``, computed only then) to it and stop it
    counting the aten ops inside; otherwise nothing."""
    if not _COUNTERS:
        yield
        return
    flops, nbytes = work()
    counters = list(_COUNTERS)
    for c in counters:
        c.add_kernel(name, flops, nbytes)
        c.suspended += 1
    try:
        yield
    finally:
        for c in counters:
            c.suspended -= 1


class _Counted(torch.autograd.Function):
    """``fn(*inputs)`` as one counted kernel under autograd: the forward
    runs inside :func:`kernel_work` ``fwd``; the backward, inside ``bwd``,
    recomputes ``fn`` and differentiates it (on meta tensors it gives
    empty gradients of the inputs' shapes)."""

    @staticmethod
    def forward(ctx, fn, fwd, bwd, *inputs):
        ctx.fn, ctx.bwd = fn, bwd
        ctx.save_for_backward(*inputs)
        with kernel_work(*fwd):
            return fn(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        inputs = ctx.saved_tensors
        needs = ctx.needs_input_grad[3:]
        with kernel_work(*ctx.bwd):
            if inputs[0].device.type == "meta":
                gin = [torch.empty_like(x) if n else None
                       for x, n in zip(inputs, needs)]
            else:
                with torch.enable_grad():
                    leaves = [x.detach().requires_grad_(n)
                              for x, n in zip(inputs, needs)]
                    out = ctx.fn(*leaves)
                    outs = out if isinstance(out, tuple) else (out,)
                    pairs = [(o, g) for o, g in zip(outs, grads)
                             if g is not None and o.requires_grad]
                    got = iter(torch.autograd.grad(
                        [o for o, _ in pairs],
                        [x for x in leaves if x.requires_grad],
                        [g for _, g in pairs], allow_unused=True))
                gin = [next(got) if n else None for n in needs]
        return (None, None, None, *gin)


def counted(fwd, bwd, fn, *inputs):
    """``fn(*inputs)`` (the tensors ``inputs``; anything else is bound in
    ``fn``) run as one kernel for the counters: ``fwd`` and ``bwd`` are
    :func:`kernel_work`'s ``(name, work)`` of the forward and of the
    backward.  Where autograd needs a gradient the call goes through an
    autograd Function whose backward recomputes ``fn``; the values are
    those of ``fn`` as it stands."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _Counted.apply(fn, fwd, bwd, *inputs)
    with kernel_work(*fwd):
        return fn(*inputs)
