"""Plain PyTorch oracles for the segment-mean kernel (the correctness ground
truth, and the plain version :func:`segment_agg.segment_mean_plain` runs).

Counterpart of ``repro/kernels/ref.py``'s ``segment_agg_ref`` and
``segment_agg_rows_ref``: ``jax.ops.segment_sum`` becomes ``index_add_``,
which on the CPU adds in edge order.  Indices are int64 tensors.
"""
from __future__ import annotations

import torch

__all__ = ["segment_agg_ref", "segment_agg_rows_ref"]


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
