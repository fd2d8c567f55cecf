"""Host-side preprocessing for the stacked engine: every partition's
blocked-CSR aggregation structure, and every epoch's minibatches, stacked
into uniform ``(P, ...)`` arrays.

Counterpart of ``repro/engine/stacking.py`` (``_local_csr``,
``_stack_blocks``, ``_sub_csr``, ``build_stacked_vjp_blocks``,
``build_stacked_split_vjp_blocks``, ``build_stacked_feat_store``,
``build_stacked_halo_cache``, ``build_stacked_halo_residual``,
``stack_pytrees``) and of
``stack_epoch_batches`` from ``repro/engine/spmd.py``, copied unchanged
apart from the kernels' work plans (``block_row_work``, one plan over all
P partitions for each direction) that the stacked dict also carries.
Partitions have ragged edge counts, so each partition's
:class:`EdgeBlocks` is padded to the fleet-wide ``(num_blocks,
edges_per_block)``; padding slots carry ``mask == 0`` and lie outside every
work item.  Batches stay NumPy on the host (the sampler thread builds
them); :func:`batches_to_device` moves one epoch in one copy.
"""
from __future__ import annotations

from dataclasses import dataclass

import time

import numpy as np
import torch

from ..graph.distributed import PartitionedGraph
from ..graph.featstore import PartitionFeatStore, build_partition_feat_store
from ..kernels.segment_agg import (BEC, BN, block_row_ptr, block_row_work,
                                   build_edge_blocks, build_transpose_blocks)

__all__ = ["StackedBlocks", "build_stacked_vjp_blocks",
           "build_stacked_split_vjp_blocks", "build_stacked_feat_store",
           "partition_blocks", "partition_vjp_blocks", "partition_arrays",
           "SHARD_KEYS", "build_stacked_halo_cache",
           "build_stacked_halo_residual", "stack_pytrees",
           "stack_epoch_batches", "batches_to_device"]


def build_stacked_feat_store(pg: PartitionedGraph, hot_frac: float,
                             policy: str, dtype, device, part: int | None = None
                             ) -> tuple[dict, PartitionFeatStore]:
    """Stacked device/host split of the feature plane.

    Returns ``(device_entries, fs)``: ``device_entries`` holds the shard
    additions on ``device`` that replace ``features``: ``fs_hot`` (P, H, D)
    resident hot rows (``dtype``, a ``torch.dtype`` or a NumPy dtype) and the
    ``fs_rows_hot`` / ``fs_rows_cold`` (P, H) / (P, C) int64 scatter maps;
    ``fs`` is the :class:`PartitionFeatStore`, whose ``cold`` (P, C, D) NumPy
    array is the host staging source (it stays OFF the device: staging it
    per call is the point of the store).  With ``part``, partition
    ``part``'s row of both, without the partition axis (what one rank of
    the partition mesh holds).
    """
    fs = build_partition_feat_store(pg, hot_frac, policy, dtype)
    if part is not None:
        fs = PartitionFeatStore(hot=fs.hot[part], rows_hot=fs.rows_hot[part],
                                cold=fs.cold[part],
                                rows_cold=fs.rows_cold[part])
    idx = lambda a: torch.as_tensor(a.astype(np.int64), device=device)
    entries = {"fs_hot": torch.as_tensor(fs.hot, device=device),
               "fs_rows_hot": idx(fs.rows_hot),
               "fs_rows_cold": idx(fs.rows_cold)}
    return entries, fs


def build_stacked_halo_cache(pg: PartitionedGraph,
                             layer_dims: tuple[int, ...]) -> dict:
    """Zero-initialised historical-embedding halo cache, stacked ``(P, ...)``
    and carried through the cached eval forward as state.

    Per partition the cache keeps each layer's last-received exchange
    buffers in recv layout ``(P, maxS, D_layer)``; ``layer_dims`` is the
    width each layer's exchange ships (``model.layer_input_dims``: raw
    features first, then hidden embeddings).  All-zero is the correct empty
    state: pad slots must stay zero forever (trash-row hygiene), and
    ``halo_refresh_plan`` always schedules a FULL refresh at age 0, so no
    real cached row is ever read before it has been received once.
    """
    P = pg.num_parts
    max_s = pg.send_idx.shape[-1]
    return {f"h{i}": np.zeros((P, P, max_s, d), dtype=np.float32)
            for i, d in enumerate(layer_dims)}


def build_stacked_halo_residual(pg: PartitionedGraph,
                                layer_dims: tuple[int, ...]) -> dict:
    """Zero-initialised error-feedback residual for the quantized halo
    exchange, stacked ``(P, ...)`` like the halo cache.

    Per partition, ``r{i}`` holds layer i's SEND-side quantization error in
    send-list layout ``(P, maxS, D_layer)`` — ``r{i}[q, s]`` is the error
    left behind the last time send slot s's row was quantized for peer q.
    Zero is the exact empty state: before the first exchange nothing has
    been rounded away, and pad slots (``send_mask == 0``) are kept zero by
    the masked residual update so they never leak into the trash row.
    """
    P = pg.num_parts
    max_s = pg.send_idx.shape[-1]
    return {f"r{i}": np.zeros((P, P, max_s, d), dtype=np.float32)
            for i, d in enumerate(layer_dims)}


@dataclass(frozen=True)
class StackedBlocks:
    """Per-partition blocked CSR, padded to common shapes (leading axis P)."""

    num_blocks: int            # nb (common across partitions)
    edges_per_block: int       # BE (fleet-wide max, multiple of BEC)
    src: np.ndarray            # (P, nb, BE) int32 local source ids, pad -> 0
    local_dst: np.ndarray      # (P, nb, BE) int32 in [0, BN)
    mask: np.ndarray           # (P, nb, BE) float32
    deg: np.ndarray            # (P, nb, BN) float32 (>=1 where real)


def _local_csr(pg: PartitionedGraph, p: int) -> tuple[np.ndarray, np.ndarray]:
    """Rebuild partition p's local CSR (dst-major, ascending — the order
    build_partitioned_graph emits) from its padded edge arrays."""
    real = pg.edge_mask[p] > 0
    src = pg.edge_src[p][real].astype(np.int64)
    dst = pg.edge_dst[p][real].astype(np.int64)
    counts = np.bincount(dst, minlength=pg.max_nodes)
    indptr = np.zeros(pg.max_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, src


def _stack_blocks(per_part, num_parts: int, bn: int) -> StackedBlocks:
    """Pad a list of per-partition EdgeBlocks to fleet-common shapes
    (at least one block so an all-empty fleet still yields a valid grid)."""
    nb = max(1, max(b.num_blocks for b in per_part))
    be = max(b.edges_per_block for b in per_part)
    P = num_parts
    src = np.zeros((P, nb, be), dtype=np.int32)
    ldst = np.zeros((P, nb, be), dtype=np.int32)
    mask = np.zeros((P, nb, be), dtype=np.float32)
    deg = np.ones((P, nb, bn), dtype=np.float32)
    for p, b in enumerate(per_part):
        src[p, : b.num_blocks, : b.edges_per_block] = b.src
        ldst[p, : b.num_blocks, : b.edges_per_block] = b.local_dst
        mask[p, : b.num_blocks, : b.edges_per_block] = b.mask
        deg[p, : b.num_blocks] = b.deg
    return StackedBlocks(num_blocks=nb, edges_per_block=be,
                         src=src, local_dst=ldst, mask=mask, deg=deg)


def _sub_csr(src: np.ndarray, dst: np.ndarray, mask: np.ndarray,
             num_rows: int, row_base: int = 0):
    """CSR over a destination sub-range rebased to start at row 0 (edges
    must already be dst-major ascending, as build_partitioned_graph emits)."""
    real = mask > 0
    s = src[real].astype(np.int64)
    d = dst[real].astype(np.int64) - row_base
    counts = np.bincount(d, minlength=num_rows) if num_rows else np.zeros(0, np.int64)
    indptr = np.zeros(num_rows + 1, dtype=np.int64)
    np.cumsum(counts[:num_rows], out=indptr[1:])
    return indptr, s


def _stack_vjp_dict(fwd_list, bwd_list, num_parts: int, bn: int) -> dict:
    """Pair per-partition forward + transpose EdgeBlocks into the flat
    ``segment_mean_op`` blocks dict, each side padded fleet-wide."""
    f = _stack_blocks(fwd_list, num_parts, bn)
    b = _stack_blocks(bwd_list, num_parts, bn)
    return {"src": f.src, "dst": f.local_dst, "mask": f.mask, "deg": f.deg,
            **block_row_work(block_row_ptr(f.local_dst, f.mask, bn)),
            "t_src": b.src, "t_dst": b.local_dst, "t_mask": b.mask,
            **block_row_work(block_row_ptr(b.local_dst, b.mask, bn),
                             prefix="t_")}


def build_stacked_vjp_blocks(pg: PartitionedGraph, bn: int = BN,
                             bec: int = BEC) -> dict:
    """Stacked paired forward/transpose block structure for the whole-space
    aggregation (``segment_mean_op`` over all ``max_nodes`` local rows):
    the forward is dst-blocked CSR, the transpose is the CSC-ordered mirror
    over the same edges (read by the backward kernel)."""
    fwds, bwds = [], []
    for p in range(pg.num_parts):
        indptr, indices = _local_csr(pg, p)
        fwds.append(build_edge_blocks(indptr, indices, bn=bn, bec=bec))
        real = pg.edge_mask[p] > 0
        bwds.append(build_transpose_blocks(
            pg.edge_src[p][real], pg.edge_dst[p][real], pg.max_nodes,
            bn=bn, bec=bec))
    return _stack_vjp_dict(fwds, bwds, pg.num_parts, bn)


def partition_blocks(blocks: dict, p: int, bn: int = BN) -> dict:
    """Partition ``p``'s forward blocks of a stacked blocks dict, unstacked
    (``(nb, BE)`` arrays) with a work plan of their own over ``(nb, bn)``:
    the stacked plan numbers rows over all P partitions, so a slice of it is
    not a plan.  The slots and their order are the stacked dict's, so one
    launch over them gives partition p's rows of the stacked launch."""
    out = {k: np.asarray(blocks[k])[p] for k in ("src", "dst", "mask", "deg")}
    out.update(block_row_work(block_row_ptr(out["dst"], out["mask"], bn)))
    return out


def partition_vjp_blocks(blocks: dict, p: int, bn: int = BN) -> dict:
    """:func:`partition_blocks` with the transpose mirror the backward
    kernel reads: partition ``p``'s ``t_src`` / ``t_dst`` / ``t_mask``
    slots, in the stacked dict's order, with a transpose plan of their
    own, so the partition mesh runs both segment kernels in their
    single-partition use."""
    out = partition_blocks(blocks, p, bn)
    for k in ("t_src", "t_dst", "t_mask"):
        out[k] = np.asarray(blocks[k])[p]
    out.update(block_row_work(block_row_ptr(out["t_dst"], out["t_mask"], bn),
                              prefix="t_"))
    return out


# the per-partition arrays of a PartitionedGraph one rank of the mesh keeps
SHARD_KEYS = ("features", "send_idx", "send_mask", "recv_pos", "edge_src",
              "edge_dst", "edge_mask", "labels", "train_mask", "val_mask",
              "test_mask")


def partition_arrays(pg: PartitionedGraph, p: int) -> dict:
    """Partition ``p``'s rows of the stacked arrays the mesh engine reads
    (:data:`SHARD_KEYS`), NumPy, without the partition axis."""
    return {k: np.asarray(getattr(pg, k))[p] for k in SHARD_KEYS}


def build_stacked_split_vjp_blocks(pg: PartitionedGraph, bn: int = BN,
                                   bec: int = BEC) -> tuple[dict, dict]:
    """The overlapped forward's interior/boundary aggregation split with the
    transpose mirrors attached: ``(interior, boundary)`` blocks dicts for
    the two ``segment_mean_op`` row-range calls.  Each half blocks ONLY its
    own row range — interior rows ``[0, n_int)``, boundary rows rebased to
    ``[0, n_own - n_int)`` (a zero-range partition contributes all-pad
    blocks that aggregate to exact zeros) — while its transpose covers the
    full ``max_nodes`` source space, the gather side indexing the REBASED
    gradient sub-range the forward produced.  Each half's work plans are
    built over its own padded, stacked arrays, so their ``row_space`` is
    the ``(P, nb, BN)`` that half launches with."""
    ints_f, ints_b, bnds_f, bnds_b = [], [], [], []
    for p in range(pg.num_parts):
        n_int = int(pg.n_int[p])
        ip, isrc = _sub_csr(pg.int_src[p], pg.int_dst[p], pg.int_mask[p],
                            n_int)
        ints_f.append(build_edge_blocks(ip, isrc, bn=bn, bec=bec))
        real_i = pg.int_mask[p] > 0
        ints_b.append(build_transpose_blocks(
            pg.int_src[p][real_i], pg.int_dst[p][real_i], pg.max_nodes,
            bn=bn, bec=bec))

        n_bnd = int(pg.n_own[p] - pg.n_int[p])
        bp, bsrc = _sub_csr(pg.bnd_src[p], pg.bnd_dst[p], pg.bnd_mask[p],
                            n_bnd, row_base=n_int)
        bnds_f.append(build_edge_blocks(bp, bsrc, bn=bn, bec=bec))
        real_b = pg.bnd_mask[p] > 0
        bnds_b.append(build_transpose_blocks(
            pg.bnd_src[p][real_b], pg.bnd_dst[p][real_b] - n_int,
            pg.max_nodes, bn=bn, bec=bec))
    return (_stack_vjp_dict(ints_f, ints_b, pg.num_parts, bn),
            _stack_vjp_dict(bnds_f, bnds_b, pg.num_parts, bn))


def stack_pytrees(trees: list[dict]) -> dict:
    """Stack a list of same-keyed dicts of NumPy arrays along a new leading
    axis (the reference's pytrees here are flat batch dicts)."""
    return {k: np.stack([t[k] for t in trees]) for k in trees[0]}


def stack_epoch_batches(samplers, make_batch, num_parts: int):
    """Draw one epoch of minibatches from every host's sampler and stack them
    into ``(iters, P, ...)`` NumPy arrays for the epoch step.

    The reference's schedule exactly: ``iters`` is the longest host's batch
    count and shorter hosts wrap around (``it % len``).  Returns
    ``(batches, host_seconds, iters)`` where ``host_seconds[p]`` is the
    host-side sampling/gather time attributed to partition p.
    """
    host_batches = [s.batches() for s in samplers]
    iters = max(len(b) for b in host_batches)
    t_host = np.zeros(num_parts)
    rows = []
    for it in range(iters):
        per_p = []
        for p in range(num_parts):
            hb = host_batches[p]
            nodes = hb[it % len(hb)]
            t0 = time.perf_counter()
            per_p.append(make_batch(nodes))
            t_host[p] += time.perf_counter() - t0
        rows.append(stack_pytrees(per_p))          # (P, ...)
    return stack_pytrees(rows), t_host, iters      # (iters, P, ...)


def batches_to_device(batches: dict, device) -> dict:
    """A dict of host NumPy arrays as tensors on ``device``.  For a CUDA
    device every array is packed into one pinned host buffer and moved in
    ONE copy; the tensors are views into the device copy."""
    device = torch.device(device)
    if device.type != "cuda":
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batches.items()}
    spans, off = {}, 0
    for k, v in batches.items():
        spans[k] = off
        off += -(-v.nbytes // 16) * 16          # 16-byte aligned slots
    host = torch.empty(off, dtype=torch.uint8, pin_memory=True)
    buf = host.numpy()
    for k, v in batches.items():
        buf[spans[k]:spans[k] + v.nbytes] = np.ascontiguousarray(v).view(
            np.uint8).reshape(-1)
    dev = host.to(device, non_blocking=True)
    return {k: dev[spans[k]:spans[k] + v.nbytes]
            .view(torch.from_numpy(v[:0]).dtype).view(v.shape)
            for k, v in batches.items()}
