"""Public wrappers around the hand-written kernels (counterpart of
``repro/kernels/ops.py``): the segment-mean op, flash attention, RMSNorm and
RMSNorm with the residual add fused in front of it.

Each wrapper has the signature of its JAX counterpart minus ``interpret``
and the block sizes, and can be swapped 1:1 with its ``ref.py`` oracle.  A
CUDA tensor launches the kernel, a CPU tensor runs the plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from . import ref
from .flash_attention import flash_attention
from .rmsnorm import add_rmsnorm, rmsnorm
from .segment_agg import blocks_to_device, build_vjp_blocks, segment_mean_op

__all__ = ["make_mean_blocks", "make_segment_agg", "segment_mean_op",
           "build_vjp_blocks", "flash_attention", "rmsnorm", "add_rmsnorm"]


def make_mean_blocks(indptr: np.ndarray, indices: np.ndarray) -> dict:
    """Host-side: paired forward/transpose block structure for
    :func:`segment_mean_op` from a CSR graph (``num_src_rows == num_rows``)."""
    indptr = np.asarray(indptr)
    n = len(indptr) - 1
    dst = np.repeat(np.arange(n), np.diff(indptr))
    return build_vjp_blocks(np.asarray(indices), dst, num_rows=n,
                            num_src_rows=n)


def make_segment_agg(indptr: np.ndarray, indices: np.ndarray, *,
                     mean: bool = True, use_kernel: bool = True,
                     device="cuda"):
    """Bind the static CSR block structure once per graph on ``device``;
    returns ``agg(x) -> (N, D)``.  ``use_kernel`` routes through
    :func:`segment_mean_op` (the CUDA kernel for CUDA tensors), otherwise
    through the oracle ``ref.segment_agg_ref`` (the reference's
    ``use_pallas``)."""
    dev = resolve_device(device)
    n = len(indptr) - 1
    if not use_kernel:
        src = torch.as_tensor(np.asarray(indices, np.int64), device=dev)
        dst = torch.as_tensor(np.repeat(np.arange(n), np.diff(indptr)),
                              device=dev)
        return lambda x: ref.segment_agg_ref(x, src, dst, n, mean=mean)

    blocks = blocks_to_device(make_mean_blocks(indptr, indices), dev)

    def agg(x: torch.Tensor) -> torch.Tensor:
        return segment_mean_op(x, blocks, num_rows=n, mean=mean)

    return agg
