"""Blocked CSR segment mean (the GNN hot-spot): host block builders and the
forward op, whose CUDA tensors go to the hand-written Hopper kernel in
``csrc/segment_agg.cu``.

Counterpart of ``repro/kernels/segment_agg.py``.  The host builders are
copied from it unchanged (same ``BN``/``BEC`` constants, same padded
``(num_blocks, BE)`` layout, bitwise the same arrays) with one addition:
every blocks dict also carries ``row_ptr`` ``(nb, BN + 1)`` int32, each
destination row's slot range inside its block, built once on the host.
The JAX kernel reduces a block with a one-hot x messages matmul over all
``BE`` slots; the CUDA kernel is a row-owner CSR walk that reads only the
real slots of each row, so it needs those ranges (``block_row_ptr``).

:func:`segment_mean_op` is forward only in this package for now: the
transpose structures (``t_*`` keys) are built, as the reference builds
them, for the backward kernel that joins with full-graph training.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from . import ref
from .build import load_library

__all__ = ["EdgeBlocks", "BN", "BEC", "build_edge_blocks",
           "build_edge_blocks_from_edges", "build_transpose_blocks",
           "build_vjp_blocks", "build_mean_blocks", "block_row_ptr",
           "blocks_to_device", "segment_mean_op", "segment_mean_plain",
           "kernel_launch_count", "reset_kernel_launch_count"]

BN = 128    # destination nodes per block
BEC = 128   # edge-slot granule: BE is a multiple of it

# Launch counter of the CUDA kernel (counterpart of ``pallas_call_count``):
# bumped once per kernel launch and nowhere else, so a run can show that its
# main path went through the kernel rather than the plain version.
_KERNEL_LAUNCHES = 0


def kernel_launch_count() -> int:
    return _KERNEL_LAUNCHES


def reset_kernel_launch_count() -> None:
    global _KERNEL_LAUNCHES
    _KERNEL_LAUNCHES = 0


# ---------------------------------------------------------------------------
# host builders (copied from the reference)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class EdgeBlocks:
    """Static, padded block structure for one CSR graph (host preprocessing)."""

    num_nodes: int
    num_blocks: int
    edges_per_block: int       # BE (multiple of BEC)
    src: np.ndarray            # (num_blocks, BE) int32, pad -> 0 (masked)
    local_dst: np.ndarray      # (num_blocks, BE) int32 in [0, BN), pad -> 0
    mask: np.ndarray           # (num_blocks, BE) float32
    deg: np.ndarray            # (num_blocks, BN) float32 (>=1 where real)


def build_edge_blocks(indptr: np.ndarray, indices: np.ndarray, bn: int = BN,
                      bec: int = BEC) -> EdgeBlocks:
    n = len(indptr) - 1
    nblocks = (n + bn - 1) // bn
    counts = [int(indptr[min((b + 1) * bn, n)] - indptr[b * bn]) for b in range(nblocks)]
    be = max(bec, ((max(counts) + bec - 1) // bec) * bec) if counts else bec

    src = np.zeros((nblocks, be), dtype=np.int32)
    ldst = np.zeros((nblocks, be), dtype=np.int32)
    mask = np.zeros((nblocks, be), dtype=np.float32)
    deg = np.ones((nblocks, bn), dtype=np.float32)
    for b in range(nblocks):
        lo_node, hi_node = b * bn, min((b + 1) * bn, n)
        lo, hi = int(indptr[lo_node]), int(indptr[hi_node])
        k = hi - lo
        src[b, :k] = indices[lo:hi]
        dst_global = np.repeat(
            np.arange(lo_node, hi_node),
            np.diff(indptr[lo_node : hi_node + 1]),
        )
        ldst[b, :k] = dst_global - lo_node
        mask[b, :k] = 1.0
        d = np.diff(indptr[lo_node : hi_node + 1]).astype(np.float32)
        deg[b, : hi_node - lo_node] = np.maximum(d, 1.0)
    return EdgeBlocks(
        num_nodes=n, num_blocks=nblocks, edges_per_block=be,
        src=src, local_dst=ldst, mask=mask, deg=deg,
    )


def build_edge_blocks_from_edges(src: np.ndarray, dst: np.ndarray,
                                 num_rows: int, bn: int = BN,
                                 bec: int = BEC) -> EdgeBlocks:
    """:func:`build_edge_blocks` over an explicit edge list (``dst`` need not
    be sorted; a stable dst-sort reproduces the CSR per-row edge order)."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    order = np.argsort(dst, kind="stable")
    counts = np.bincount(dst, minlength=num_rows)[:num_rows]
    indptr = np.zeros(num_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return build_edge_blocks(indptr, src[order], bn=bn, bec=bec)


def build_transpose_blocks(src: np.ndarray, dst: np.ndarray,
                           num_src_rows: int, bn: int = BN,
                           bec: int = BEC) -> EdgeBlocks:
    """CSC-ordered mirror of a CSR block structure: blocks for the TRANSPOSE
    aggregation over the same edges (grad flows dst -> src), i.e. edges
    re-grouped by SOURCE with the original destinations as the gather index.
    This is the static structure of the backward kernel of
    :func:`segment_mean_op`."""
    return build_edge_blocks_from_edges(dst, src, num_src_rows, bn=bn, bec=bec)


def _pad_min_one_block(blocks: EdgeBlocks, bn: int) -> EdgeBlocks:
    """Guarantee >= 1 (all-pad) block so empty edge sets still stage a valid
    kernel grid — the same guard engine.stacking applies when stacking."""
    if blocks.num_blocks:
        return blocks
    be = blocks.edges_per_block
    return EdgeBlocks(
        num_nodes=blocks.num_nodes, num_blocks=1, edges_per_block=be,
        src=np.zeros((1, be), np.int32), local_dst=np.zeros((1, be), np.int32),
        mask=np.zeros((1, be), np.float32), deg=np.ones((1, bn), np.float32))


def block_row_ptr(local_dst: np.ndarray, mask: np.ndarray,
                  bn: int = BN) -> np.ndarray:
    """Per-block destination-row slot ranges for the CUDA kernel.

    ``local_dst``/``mask`` are ``(..., nb, BE)`` block arrays as the
    builders emit them: each block's real slots (``mask > 0``) form a prefix
    sorted by local destination.  Returns ``row_ptr`` ``(..., nb, bn + 1)``
    int32 with row r's real slots at ``[row_ptr[r], row_ptr[r + 1])``; pad
    slots fall outside every range, so the kernel never reads them.
    """
    ldst = np.asarray(local_dst)
    real = np.asarray(mask) > 0
    k = real.sum(axis=-1, keepdims=True)
    slot = np.arange(real.shape[-1])
    if not (real == (slot < k)).all():
        raise ValueError("block real slots are not a prefix of the block")
    if (np.diff(np.where(real, ldst, bn), axis=-1) < 0).any():
        raise ValueError("block real slots are not sorted by destination row")
    flat = ldst.reshape(-1, ldst.shape[-1])
    rflat = real.reshape(flat.shape)
    blk = np.nonzero(rflat)[0]
    counts = np.bincount(blk * bn + flat[rflat],
                         minlength=flat.shape[0] * bn).reshape(-1, bn)
    ptr = np.zeros((flat.shape[0], bn + 1), np.int32)
    np.cumsum(counts, axis=1, out=ptr[:, 1:])
    return ptr.reshape(ldst.shape[:-1] + (bn + 1,))


def build_mean_blocks(src: np.ndarray, dst: np.ndarray, num_rows: int,
                      bn: int = BN, bec: int = BEC) -> dict[str, np.ndarray]:
    """Forward-only block structure for :func:`segment_mean_op` (no
    transpose mirror): ``src``, ``dst`` (local), ``mask``, ``deg`` and the
    kernel's ``row_ptr``, at least one block even for an empty edge set."""
    fwd = _pad_min_one_block(
        build_edge_blocks_from_edges(src, dst, num_rows, bn=bn, bec=bec), bn)
    return {"src": fwd.src, "dst": fwd.local_dst, "mask": fwd.mask,
            "deg": fwd.deg, "row_ptr": block_row_ptr(fwd.local_dst, fwd.mask, bn)}


def build_vjp_blocks(src: np.ndarray, dst: np.ndarray, num_rows: int,
                     num_src_rows: int, bn: int = BN,
                     bec: int = BEC) -> dict[str, np.ndarray]:
    """Paired forward (dst-blocked CSR) + backward (src-blocked CSC mirror)
    structures for :func:`segment_mean_op`, as a flat dict of arrays: the
    reference's keys plus the forward's ``row_ptr``.

    ``num_rows`` is the aggregation's output row range (destinations live in
    ``[0, num_rows)``); ``num_src_rows`` is the gathered-from row space the
    gradient must cover (sources live in ``[0, num_src_rows)``).
    """
    out = build_mean_blocks(src, dst, num_rows, bn=bn, bec=bec)
    bwd = _pad_min_one_block(
        build_transpose_blocks(src, dst, num_src_rows, bn=bn, bec=bec), bn)
    out.update({"t_src": bwd.src, "t_dst": bwd.local_dst, "t_mask": bwd.mask})
    return out


def blocks_to_device(blocks: dict, device) -> dict[str, torch.Tensor]:
    """Host blocks dict -> tensors on ``device``, converted once here:
    gather indices become int64 (torch's index type, read by the kernel as
    is), ``row_ptr`` stays int32, masks and degrees float32."""
    out = {}
    for k, v in blocks.items():
        v = np.asarray(v)
        if k == "row_ptr":
            out[k] = torch.as_tensor(v.astype(np.int32), device=device)
        elif v.dtype.kind in "iu":
            out[k] = torch.as_tensor(v.astype(np.int64), device=device)
        else:
            out[k] = torch.as_tensor(v.astype(np.float32), device=device)
    return out


# ---------------------------------------------------------------------------
# the op: plain version (CPU) and kernel (CUDA)
# ---------------------------------------------------------------------------

def _row_bases(row_base, num_parts: int) -> list[int]:
    if isinstance(row_base, torch.Tensor):
        rb = row_base.reshape(-1).tolist()
        return rb * num_parts if len(rb) == 1 else rb
    return [int(row_base)] * num_parts


def segment_mean_plain(x: torch.Tensor, blocks: dict, *, num_rows: int,
                       row_base=0, mean: bool = True) -> torch.Tensor:
    """Plain PyTorch version of :func:`segment_mean_op`: the real slots of
    each partition's blocks become an edge list (destination ``b·BN + r``)
    and go through the ported oracle ``ref.segment_agg_rows_ref``.  The
    builders emit masks of exactly 0 or 1, so selecting ``mask > 0`` is the
    kernel's mask weighting."""
    stacked = x.dim() == 3
    xs = x if stacked else x[None]
    bl = blocks if stacked else {k: v[None] for k, v in blocks.items()}
    nb, bn = bl["deg"].shape[-2:]
    rows = torch.arange(nb, device=x.device)[:, None] * bn
    outs = []
    for p, rb in enumerate(_row_bases(row_base, xs.shape[0])):
        real = bl["mask"][p] > 0
        outs.append(ref.segment_agg_rows_ref(
            xs[p], bl["src"][p][real], (rows + bl["dst"][p])[real],
            nb * bn, rb, num_rows, mean=mean))
    out = torch.stack(outs)
    return out if stacked else out[0]


_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}


@functools.cache
def _kernel_fn():
    lib = load_library("segment_agg")
    fn = lib.segment_mean_fwd
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = [i32, vp, vp, vp, vp, vp, vp, i64, vp,
                   i32, i32, i32, i32, i64, i64, i32, i32, vp]
    fn.restype = i32
    return fn


def _launch_kernel(x: torch.Tensor, blocks: dict, num_rows: int, row_base,
                   mean: bool) -> torch.Tensor:
    global _KERNEL_LAUNCHES
    stacked = x.dim() == 3
    xs = x if stacked else x[None]
    bl = {k: blocks[k] if stacked else blocks[k][None]
          for k in ("src", "mask", "row_ptr", "deg")}
    P, n_in, d = xs.shape
    _, nb, be = bl["src"].shape
    bn = bl["deg"].shape[-1]
    if xs.dtype not in _DTYPE_CODES:
        raise TypeError(f"segment_mean_op kernel takes float32, float64 or "
                        f"bfloat16, got {xs.dtype}")
    want = {"src": (torch.int64, (P, nb, be)), "mask": (torch.float32, (P, nb, be)),
            "row_ptr": (torch.int32, (P, nb, bn + 1)),
            "deg": (torch.float32, (P, nb, bn))}
    for k, (dt, shape) in want.items():
        t = bl[k]
        if t.dtype != dt or tuple(t.shape) != shape or t.device != xs.device:
            raise ValueError(
                f"blocks[{k!r}] must be {dt} {shape} on {xs.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device} (build blocks "
                "with this package's builders and blocks_to_device)")
    xs = xs.contiguous()
    bl = {k: v.contiguous() for k, v in bl.items()}
    rb_ptr, rb_scalar = None, 0
    if isinstance(row_base, torch.Tensor):
        rb = row_base.to(device=xs.device, dtype=torch.int64).reshape(-1)
        rb = rb.expand(P).contiguous()
        rb_ptr = rb.data_ptr()
        covered = False
    else:
        rb_scalar = int(row_base)
        covered = rb_scalar <= 0 and rb_scalar + nb * bn >= num_rows
    # the kernel writes every output row its blocks cover; rows outside
    # [row_base, row_base + nb·BN) stay zero only if the buffer starts zero
    alloc = torch.empty if covered else torch.zeros
    out = alloc((P, num_rows, d), dtype=xs.dtype, device=xs.device)
    fn = _kernel_fn()
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        err = fn(_DTYPE_CODES[xs.dtype], xs.data_ptr(), bl["src"].data_ptr(),
                 bl["mask"].data_ptr(), bl["row_ptr"].data_ptr(),
                 bl["deg"].data_ptr(), rb_ptr, rb_scalar, out.data_ptr(),
                 P, nb, be, bn, n_in, num_rows, d, int(bool(mean)), stream)
    _KERNEL_LAUNCHES += 1
    if err != 0:
        raise RuntimeError(f"segment_mean_fwd kernel launch failed with CUDA "
                           f"error {err}")
    return out if stacked else out[0]


def segment_mean_op(x: torch.Tensor, blocks: dict, *, num_rows: int,
                    row_base=0, mean: bool = True) -> torch.Tensor:
    """Blocked segment mean (every forward's Eq. 1 aggregation), forward.

    ``x`` is ``(n_in, D)`` with ``(nb, BE)`` blocks, or stacked
    ``(P, n_in, D)`` with ``(P, nb, BE)`` blocks, in which case ONE kernel
    launch covers all P partitions.  Output row ``row_base + b·BN + r``
    (below ``num_rows``) holds ``Σ mask·x[src] / deg[b, r]`` over block b's
    slots with local destination r; every other row of the zero
    ``(num_rows, D)`` (or ``(P, num_rows, D)``) output is zero.  ``row_base``
    is an int, a scalar tensor, or a ``(P,)`` tensor for the stacked form.

    A CUDA ``x`` goes to the hand-written kernel (or raises); a CPU ``x`` to
    :func:`segment_mean_plain`.  There is no fallback between the two.
    """
    if x.is_cuda:
        if x.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                "segment_mean_op has no backward kernel yet (ROADMAP item 7); "
                "call it under torch.no_grad()")
        return _launch_kernel(x, blocks, int(num_rows), row_base, mean)
    if x.device.type != "cpu":
        raise ValueError(f"segment_mean_op runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    return segment_mean_plain(x, blocks, num_rows=int(num_rows),
                              row_base=row_base, mean=mean)
