"""Plain PyTorch oracles for every hand-written kernel (the correctness
ground truth, and the plain versions the wrappers run on CPU tensors).

Counterpart of ``repro/kernels/ref.py``.  In ``segment_agg_ref`` and
``segment_agg_rows_ref``, ``jax.ops.segment_sum`` becomes ``index_add_``,
which on the CPU adds in edge order; indices are int64 tensors.
``attention_ref`` and ``rmsnorm_ref`` are the plain versions of the flash
attention and RMSNorm kernels.
"""
from __future__ import annotations

import torch

__all__ = ["segment_agg_ref", "segment_agg_rows_ref", "attention_ref",
           "rmsnorm_ref"]


def segment_agg_ref(
    x: torch.Tensor,          # (N, D) node features
    edge_src: torch.Tensor,   # (E,)
    edge_dst: torch.Tensor,   # (E,)
    num_nodes: int,
    mean: bool = True,
) -> torch.Tensor:
    """out[v] = sum/mean of x[u] over in-edges (u, v).

    Sums and the mean's division run in float32 (float64 for float64
    inputs), as the kernel's do, and the result is cast back to the input
    dtype.  The reference sums in the input dtype, which is the same thing
    for the float32 and float64 inputs the parity tests compare.
    """
    acc_dt = torch.float64 if x.dtype == torch.float64 else torch.float32
    s = torch.zeros((num_nodes, x.shape[-1]), dtype=acc_dt, device=x.device)
    s.index_add_(0, edge_dst, x[edge_src].to(acc_dt))
    if not mean:
        return s.to(x.dtype)
    deg = torch.zeros(num_nodes, dtype=acc_dt, device=x.device)
    deg.index_add_(0, edge_dst, torch.ones(edge_dst.shape, dtype=acc_dt,
                                           device=x.device))
    return (s / deg.clamp_min(1.0)[:, None]).to(x.dtype)


def segment_agg_rows_ref(
    x: torch.Tensor,          # (N, D) node features
    edge_src: torch.Tensor,   # (E,) indices into x
    edge_dst: torch.Tensor,   # (E,) REBASED destinations in [0, range_rows)
    range_rows: int,          # rows covered by the sub-range
    row_base: int,            # first output row of the sub-range
    num_rows: int,            # total output rows
    mean: bool = True,
) -> torch.Tensor:
    """Aggregate a rebased destination sub-range and place it at
    ``row_base`` inside a zero ``(num_rows, D)`` output."""
    sub = segment_agg_ref(x, edge_src, edge_dst, range_rows, mean=mean)
    out = torch.zeros((num_rows, x.shape[-1]), dtype=x.dtype, device=x.device)
    k = max(0, min(range_rows, num_rows - row_base))
    out[row_base:row_base + k] = sub[:k]
    return out


def attention_ref(
    q: torch.Tensor,          # (B, Hq, Sq, Dh)
    k: torch.Tensor,          # (B, Hkv, Sk, Dh)
    v: torch.Tensor,          # (B, Hkv, Sk, Dh)
    *,
    causal: bool = True,
    window: int | None = None,   # sliding window over keys (None = full)
    q_offset: int = 0,           # absolute position of q[0] (decode: cache len)
    prefix_len: int = 0,         # keys every query sees (prefix-LM)
) -> torch.Tensor:
    """Dense-softmax GQA attention oracle: f32 (f64 for f64 inputs) logits
    with ``-inf`` masking,
    fully masked rows set to 0, output in q's dtype.  The mask is the
    reference's ``_mask_block``: keys below ``prefix_len`` are seen by every
    query, rescued from the causal mask and from the window alike."""
    _, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    acc = torch.promote_types(q.dtype, torch.float32)
    kx = k.repeat_interleave(group, dim=1).to(acc)
    vx = v.repeat_interleave(group, dim=1).to(acc)
    scale = 1.0 / torch.sqrt(torch.tensor(dh, dtype=acc))
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), kx) * scale
    q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    if prefix_len:
        mask |= k_pos < prefix_len
    logits = logits.masked_fill(~mask, float("-inf"))
    w = torch.softmax(logits, dim=-1)
    w = torch.nan_to_num(w, nan=0.0)  # fully-masked rows -> 0
    return torch.einsum("bhqk,bhkd->bhqd", w, vx).to(q.dtype)


def rmsnorm_ref(x: torch.Tensor, weight: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """``x · rsqrt(mean(x²) + eps) · w`` in float32 (float64 for float64
    inputs), cast back to x's dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    scale = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * scale * weight.to(acc)).to(x.dtype)
