"""Blocked CSR segment mean (the GNN hot-spot): host block builders and the
differentiable op, whose CUDA tensors go to the hand-written Hopper kernels
in ``csrc/segment_agg.cu`` on both passes.

Counterpart of ``repro/kernels/segment_agg.py``.  The host builders are
copied from it unchanged (same ``BN``/``BEC`` constants, same padded
``(num_blocks, BE)`` layout, bitwise the same arrays) with one addition,
built once on the host: the kernels' work plan (:func:`block_row_work`
over the :func:`block_row_ptr` slot ranges, which stay on the host),
``row_part``, ``row_work``, ``row_split`` and ``row_space`` (``t_row_*``
for the transpose), which cuts every row into items of at most
``ROW_WORK_K`` real slots, so one hub row is spread over many warps.

The JAX kernel reduces a block with a one-hot x messages matmul over all
``BE`` slots; the CUDA kernels gather only the real slots of each item.

:func:`segment_mean_op` is a ``torch.autograd.Function``: its backward is
the transpose aggregation over the ``t_*`` structures
(:func:`segment_mean_bwd_op`), and the backward's own backward is the
forward op again, so the op is differentiable to any order.
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
           "block_row_work", "ROW_WORK_K", "PLAN_KEYS", "blocks_to_device",
           "segment_mean_op", "segment_mean_plain",
           "segment_mean_bwd_op", "segment_mean_bwd_plain",
           "kernel_launch_count", "bwd_kernel_launch_count",
           "reset_kernel_launch_count"]

BN = 128    # destination nodes per block
BEC = 128   # edge-slot granule: BE is a multiple of it
ROW_WORK_K = 128   # most real slots one work item of the kernels sums
ZERO_RUN = 32      # most empty rows one work entry zero-fills
# the work plan's keys (``t_`` + each for the transpose mirror)
PLAN_KEYS = ("row_part", "row_work", "row_split", "row_space")
_INT32_KEYS = {*PLAN_KEYS, *("t_" + k for k in PLAN_KEYS)}

# Launch counters of the CUDA kernels (counterpart of ``pallas_call_count``),
# one per op: bumped once per CUDA call (whatever number of grids it runs)
# and nowhere else, so a run can show that its main path went through the
# kernels rather than the plain versions.
_KERNEL_LAUNCHES = 0
_BWD_KERNEL_LAUNCHES = 0


def kernel_launch_count() -> int:
    """CUDA calls of the forward ``segment_mean_fwd`` (gather and merge)."""
    return _KERNEL_LAUNCHES


def bwd_kernel_launch_count() -> int:
    """CUDA calls of the backward ``segment_mean_bwd`` (pre-pass, gather
    and merge)."""
    return _BWD_KERNEL_LAUNCHES


def reset_kernel_launch_count() -> None:
    """Set both kernels' launch counts to 0."""
    global _KERNEL_LAUNCHES, _BWD_KERNEL_LAUNCHES
    _KERNEL_LAUNCHES = 0
    _BWD_KERNEL_LAUNCHES = 0


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
    """Per-block destination-row slot ranges, from which
    :func:`block_row_work` cuts the kernels' work items.

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


def block_row_work(row_ptr: np.ndarray, k: int = ROW_WORK_K,
                   prefix: str = "") -> dict[str, np.ndarray]:
    """The CUDA kernels' work plan over a ``row_ptr`` ``(..., nb, bn + 1)``.

    Rows are numbered flat, ``(p·nb + b)·bn + r`` over all leading axes (so
    a stacked plan is one plan for all P partitions).  Every row with
    ``n`` real slots becomes ``ceil(n / k)`` items of at most ``k``
    consecutive slots, in slot order.  Returns int32 arrays under
    ``prefix`` + :data:`PLAN_KEYS`:

    * ``row_part`` ``(n_part, 3)`` — (row, beg, end) of each item of a row
      with several items; item i writes partial row i of the scratch;
    * ``row_work`` ``(n_work, 4)`` — (row, beg, end, 1) of each row with
      one item, which writes its result, then (row, 0, 0, m) for each run of
      m <= 32 empty consecutive rows inside one 32-row window, which read 0;
    * ``row_split`` ``(n_split, 3)`` — (row, first, end) partial range of
      each row with several items, added in item order by the merge;
    * ``row_space`` ``(..., nb, bn, 0)`` — no data: its shape is the row
      space the plan numbers, which the launch checks against the blocks
      it is given (a plan built before the blocks were padded or
      re-stacked raises instead of reading out of bounds).

    NumPy only, no loop over rows: the serving recompute builds it every
    tick.
    """
    ptr = np.asarray(row_ptr)
    bn = ptr.shape[-1] - 1
    flat = ptr.reshape(-1, bn + 1)
    beg, end = flat[:, :-1].ravel(), flat[:, 1:].ravel()
    if beg.size >= 2**31:
        raise ValueError(f"{beg.size} block rows: the plan's int32 row "
                         "numbers take fewer than 2^31")
    n = end - beg
    rows = np.flatnonzero(n)
    split = n[rows] > k
    if split.any():
        # items of split rows, each row's items consecutive, in slot order
        srows = rows[split]
        sitems = (n[srows] + k - 1) // k
        first = np.cumsum(sitems) - sitems
        prow = np.repeat(srows, sitems)
        pbeg = beg[prow] + (np.arange(prow.size) - np.repeat(first, sitems)) * k
        part = np.stack([prow, pbeg, np.minimum(pbeg + k, end[prow])], 1)
        merge = np.stack([srows, first, first + sitems], 1).astype(np.int32)
        rows = rows[~split]
    else:
        part = merge = np.zeros((0, 3), np.int32)
    # one-item rows, then runs of empty rows, cut where a run crosses a
    # multiple of ZERO_RUN
    empty = np.flatnonzero(n == 0)
    start = np.ones(empty.size + 1, bool)
    start[1:-1] = (empty[1:] - empty[:-1] != 1) | (empty[1:] % ZERO_RUN == 0)
    cut = np.flatnonzero(start)         # run starts, then empty.size
    nf = rows.size
    work = np.zeros((nf + cut.size - 1, 4), np.int32)
    work[:nf, 0] = rows
    work[:nf, 1] = beg[rows]
    work[:nf, 2] = end[rows]
    work[:nf, 3] = 1
    work[nf:, 0] = empty[cut[:-1]]
    work[nf:, 3] = cut[1:] - cut[:-1]
    return {prefix + "row_part": part.astype(np.int32),
            prefix + "row_work": work, prefix + "row_split": merge,
            prefix + "row_space": np.zeros(ptr.shape[:-1] + (bn, 0),
                                           np.int32)}


def build_mean_blocks(src: np.ndarray, dst: np.ndarray, num_rows: int,
                      bn: int = BN, bec: int = BEC) -> dict[str, np.ndarray]:
    """Forward-only block structure for :func:`segment_mean_op` (no
    transpose mirror): ``src``, ``dst`` (local), ``mask``, ``deg`` and the
    kernels' work plan, at least one block even for an empty edge set."""
    fwd = _pad_min_one_block(
        build_edge_blocks_from_edges(src, dst, num_rows, bn=bn, bec=bec), bn)
    return {"src": fwd.src, "dst": fwd.local_dst, "mask": fwd.mask,
            "deg": fwd.deg,
            **block_row_work(block_row_ptr(fwd.local_dst, fwd.mask, bn))}


def build_vjp_blocks(src: np.ndarray, dst: np.ndarray, num_rows: int,
                     num_src_rows: int, bn: int = BN,
                     bec: int = BEC) -> dict[str, np.ndarray]:
    """Paired forward (dst-blocked CSR) + backward (src-blocked CSC mirror)
    structures for :func:`segment_mean_op`, as a flat dict of arrays: the
    reference's keys plus the forward's work plan and the transpose's
    ``t_`` work plan.

    ``num_rows`` is the aggregation's output row range (destinations live in
    ``[0, num_rows)``); ``num_src_rows`` is the gathered-from row space the
    gradient must cover (sources live in ``[0, num_src_rows)``).
    """
    out = build_mean_blocks(src, dst, num_rows, bn=bn, bec=bec)
    bwd = _pad_min_one_block(
        build_transpose_blocks(src, dst, num_src_rows, bn=bn, bec=bec), bn)
    out.update({"t_src": bwd.src, "t_dst": bwd.local_dst, "t_mask": bwd.mask,
                **block_row_work(block_row_ptr(bwd.local_dst, bwd.mask, bn),
                                 prefix="t_")})
    return out


def blocks_to_device(blocks: dict, device) -> dict[str, torch.Tensor]:
    """Host blocks dict -> tensors on ``device``, converted once here:
    gather indices become int64 (torch's index type, read by the kernel as
    is), the work plans stay int32, masks and degrees float32."""
    out = {}
    for k, v in blocks.items():
        v = np.asarray(v)
        if k in _INT32_KEYS:
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


def segment_mean_bwd_plain(g: torch.Tensor, blocks: dict, *, n_in: int,
                           row_base=0, mean: bool = True) -> torch.Tensor:
    """Plain PyTorch version of :func:`segment_mean_bwd_op`, as the
    reference's ``segment_agg_bwd_blocks`` spells it: un-place the forward's
    rows ``[row_base, row_base + nb·BN)`` of ``g`` (rows the forward sliced
    off by ``num_rows`` read zero), divide by the forward's ``deg``, and sum
    over the real slots of the transpose blocks into ``(n_in, D)``."""
    stacked = g.dim() == 3
    gs = g if stacked else g[None]
    bl = blocks if stacked else {k: v[None] for k, v in blocks.items()}
    acc_dt = torch.float64 if g.dtype == torch.float64 else torch.float32
    nb, bn = bl["deg"].shape[-2:]
    num_rows, d = gs.shape[-2:]
    rows = torch.arange(nb * bn, device=g.device)
    t_rows = (torch.arange(bl["t_src"].shape[-2], device=g.device)[:, None]
              * bn)
    outs = []
    for p, rb in enumerate(_row_bases(row_base, gs.shape[0])):
        orow = rows + rb
        keep = (orow >= 0) & (orow < num_rows)
        gsub = torch.zeros((nb * bn, d), dtype=acc_dt, device=g.device)
        gsub[keep] = gs[p][orow[keep]].to(acc_dt)
        if mean:
            gsub = gsub / bl["deg"][p].reshape(-1, 1).to(acc_dt)
        real = bl["t_mask"][p] > 0
        out = torch.zeros((n_in, d), dtype=acc_dt, device=g.device)
        out.index_add_(0, (t_rows + bl["t_dst"][p])[real],
                       gsub[bl["t_src"][p][real]])
        outs.append(out.to(g.dtype))
    out = torch.stack(outs)
    return out if stacked else out[0]


_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}


@functools.cache
def _kernel_fn(name: str):
    lib = load_library("segment_agg")
    fn = getattr(lib, name)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    plan = [vp, i32, vp, i32, vp, i32]     # row_part, row_work, row_split
    if name == "segment_mean_fwd":
        fn.argtypes = [i32, vp, vp, vp, vp, *plan, vp, i64, vp, vp,
                       i32, i32, i32, i64, i64, i32, i32, vp]
    else:
        fn.argtypes = [i32, vp, vp, vp, vp, *plan, vp, i64, vp, vp, vp,
                       i32, i32, i32, i32, i32, i64, i64, i32, i32, vp]
    fn.restype = i32
    return fn


def _check_blocks(bl: dict, want: dict, device) -> dict:
    for k, (dt, shape) in want.items():
        t = bl[k]
        if t.dtype != dt or tuple(t.shape) != shape or t.device != device:
            raise ValueError(
                f"blocks[{k!r}] must be {dt} {shape} on {device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device} (build blocks "
                "with build_vjp_blocks or build_mean_blocks and "
                "blocks_to_device)")
    return {k: bl[k].contiguous() for k in want}


def _plan_args(blocks: dict, prefix: str, device,
               row_space: tuple) -> tuple[list, int]:
    """The work plan's ctypes arguments (pointer, entries) x 3, and the
    number of partial rows the scratch needs; raises if the blocks carry no
    plan (the kernels never walk rows without one) or one built for another
    row space than ``row_space`` (the launch's ``(P, nb, bn)``, or
    ``(nb, bn)`` for unstacked blocks)."""
    keys = [prefix + k for k in PLAN_KEYS]
    missing = [k for k in keys if k not in blocks]
    if missing:
        raise ValueError(
            f"the CUDA segment kernels need the host work plan, missing "
            f"{missing}: build the blocks with build_mean_blocks, "
            "build_vjp_blocks or engine.stacking.build_stacked_vjp_blocks "
            "(or add block_row_work over their block_row_ptr) and move them "
            "with blocks_to_device")
    space = tuple(blocks[keys[3]].shape)
    if space != (*row_space, 0):
        raise ValueError(
            f"blocks[{keys[3]!r}] says the work plan numbers rows "
            f"{space[:-1]}, but the blocks launched with it span "
            f"{row_space}: rebuild the plan (block_row_work) after padding "
            "or stacking the blocks")
    args = []
    for k, cols in zip(keys, (3, 4, 3)):
        t = blocks[k]
        if (t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != cols
                or t.device != device or not t.is_contiguous()):
            raise ValueError(
                f"blocks[{k!r}] must be a contiguous int32 (n, {cols}) "
                f"tensor on {device} (block_row_work and blocks_to_device), "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        args += [t.data_ptr(), t.shape[0]]
    return args, blocks[keys[0]].shape[0]


def _row_base_arg(row_base, P: int, device):
    """``(array, pointer, scalar)``: a ``(P,)`` int64 device array of
    per-partition bases and its pointer, or ``None, None`` and the one
    scalar base."""
    if isinstance(row_base, torch.Tensor):
        rb = row_base.to(device=device, dtype=torch.int64).reshape(-1)
        rb = rb.expand(P).contiguous()
        return rb, rb.data_ptr(), 0
    return None, None, int(row_base)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _launch_kernel(x: torch.Tensor, blocks: dict, num_rows: int, row_base,
                   mean: bool) -> torch.Tensor:
    global _KERNEL_LAUNCHES
    stacked = x.dim() == 3
    xs = x if stacked else x[None]
    bl = {k: blocks[k] if stacked else blocks[k][None]
          for k in ("src", "mask", "deg")}
    P, n_in, d = xs.shape
    _, nb, be = bl["src"].shape
    bn = bl["deg"].shape[-1]
    if xs.dtype not in _DTYPE_CODES:
        raise TypeError(f"segment_mean_op kernel takes float32, float64 or "
                        f"bfloat16, got {xs.dtype}")
    if n_in >= 2**31:
        raise ValueError(f"{n_in} input rows: the kernel's gather index is "
                         "32-bit")
    bl = _check_blocks(bl, {
        "src": (torch.int64, (P, nb, be)), "mask": (torch.float32, (P, nb, be)),
        "deg": (torch.float32, (P, nb, bn))}, xs.device)
    plan, n_part = _plan_args(blocks, "", xs.device,
                              (P, nb, bn) if stacked else (nb, bn))
    xs = xs.contiguous()
    _rb, rb_ptr, rb_scalar = _row_base_arg(row_base, P, xs.device)
    covered = rb_ptr is None and rb_scalar <= 0 and rb_scalar + nb * bn >= num_rows
    # the plan writes every output row its blocks cover (empty rows too);
    # rows outside [row_base, row_base + nb·BN) stay zero only if the buffer
    # starts zero
    alloc = torch.empty if covered else torch.zeros
    out = alloc((P, num_rows, d), dtype=xs.dtype, device=xs.device)
    partials = torch.empty((n_part, d), dtype=_acc_dtype(xs.dtype),
                           device=xs.device)
    fn = _kernel_fn("segment_mean_fwd")
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    with torch.cuda.device(xs.device):
        err = fn(_DTYPE_CODES[xs.dtype], xs.data_ptr(), bl["src"].data_ptr(),
                 bl["mask"].data_ptr(), bl["deg"].data_ptr(), *plan, rb_ptr,
                 rb_scalar, out.data_ptr(), partials.data_ptr(), nb, be, bn,
                 n_in, num_rows, d, int(bool(mean)), stream)
    _KERNEL_LAUNCHES += 1
    if err != 0:
        raise RuntimeError(f"segment_mean_fwd kernel launch failed with CUDA "
                           f"error {err}")
    return out if stacked else out[0]


def _launch_bwd_kernel(g: torch.Tensor, blocks: dict, n_in: int, row_base,
                       mean: bool) -> torch.Tensor:
    global _BWD_KERNEL_LAUNCHES
    stacked = g.dim() == 3
    gs = g if stacked else g[None]
    bl = {k: blocks[k] if stacked else blocks[k][None]
          for k in ("t_src", "t_mask", "deg")}
    P, num_rows, d = gs.shape
    _, nb_t, be_t = bl["t_src"].shape
    nb, bn = bl["deg"].shape[-2:]
    if gs.dtype not in _DTYPE_CODES:
        raise TypeError(f"segment_mean_bwd kernel takes float32, float64 or "
                        f"bfloat16, got {gs.dtype}")
    bl = _check_blocks(bl, {
        "t_src": (torch.int64, (P, nb_t, be_t)),
        "t_mask": (torch.float32, (P, nb_t, be_t)),
        "deg": (torch.float32, (P, nb, bn))}, gs.device)
    plan, n_part = _plan_args(blocks, "t_", gs.device,
                              (P, nb_t, bn) if stacked else (nb_t, bn))
    gs = gs.contiguous()
    _rb, rb_ptr, rb_scalar = _row_base_arg(row_base, P, gs.device)
    acc_dt = _acc_dtype(gs.dtype)
    # gsub: g un-placed from row_base and divided by deg, the forward's
    # nb·BN rows of each partition (the transpose blocks' gather space)
    gsub = torch.empty((P, nb * bn, d), dtype=acc_dt, device=gs.device)
    # the plan writes every source row u < nb_t·BN; rows past the transpose
    # blocks' reach (none, for blocks built with num_src_rows == n_in) stay
    # zero
    alloc = torch.empty if nb_t * bn >= n_in else torch.zeros
    out = alloc((P, n_in, d), dtype=gs.dtype, device=gs.device)
    partials = torch.empty((n_part, d), dtype=acc_dt, device=gs.device)
    fn = _kernel_fn("segment_mean_bwd")
    stream = torch.cuda.current_stream(gs.device).cuda_stream
    with torch.cuda.device(gs.device):
        err = fn(_DTYPE_CODES[gs.dtype], gs.data_ptr(), bl["t_src"].data_ptr(),
                 bl["t_mask"].data_ptr(), bl["deg"].data_ptr(), *plan, rb_ptr,
                 rb_scalar, gsub.data_ptr(), out.data_ptr(),
                 partials.data_ptr(), P, nb, nb_t, be_t, bn, num_rows, n_in,
                 d, int(bool(mean)), stream)
    _BWD_KERNEL_LAUNCHES += 1
    if err != 0:
        raise RuntimeError(f"segment_mean_bwd kernel launch failed with CUDA "
                           f"error {err}")
    return out if stacked else out[0]


def _device_kind(t: torch.Tensor) -> str:
    if t.is_cuda:
        return "cuda"
    if t.device.type != "cpu":
        raise ValueError(f"segment_mean_op runs on CUDA or CPU tensors, got "
                         f"{t.device}")
    return "cpu"


def _fwd(x, blocks, num_rows, row_base, mean):
    if _device_kind(x) == "cuda":
        return _launch_kernel(x, blocks, num_rows, row_base, mean)
    return segment_mean_plain(x, blocks, num_rows=num_rows,
                              row_base=row_base, mean=mean)


def _bwd(g, blocks, n_in, row_base, mean):
    missing = [k for k in ("t_src", "t_dst", "t_mask") if k not in blocks]
    if missing:
        raise ValueError(f"the backward of segment_mean_op needs the "
                         f"transpose blocks, missing {missing} (build the "
                         "blocks with build_vjp_blocks)")
    if _device_kind(g) == "cuda":
        return _launch_bwd_kernel(g, blocks, n_in, row_base, mean)
    return segment_mean_bwd_plain(g, blocks, n_in=n_in, row_base=row_base,
                                  mean=mean)


class _SegmentMean(torch.autograd.Function):
    """``x (n_in rows) -> out (num_rows rows)``; its backward is
    :class:`_SegmentMeanBwd`, the transpose aggregation."""

    @staticmethod
    def forward(ctx, x, blocks, num_rows, row_base, mean):
        ctx.blocks, ctx.row_base, ctx.mean = blocks, row_base, mean
        ctx.num_rows, ctx.n_in = num_rows, x.shape[-2]
        return _fwd(x, blocks, num_rows, row_base, mean)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None
        gx = _SegmentMeanBwd.apply(g, ctx.blocks, ctx.n_in, ctx.num_rows,
                                   ctx.row_base, ctx.mean)
        return gx, None, None, None, None


class _SegmentMeanBwd(torch.autograd.Function):
    """``g (num_rows rows) -> dx (n_in rows)``, linear in ``g``; its own
    backward is the forward op, so both are differentiable to any order
    (the reference gets the same by calling its op with the structures
    swapped)."""

    @staticmethod
    def forward(ctx, g, blocks, n_in, num_rows, row_base, mean):
        ctx.blocks, ctx.row_base, ctx.mean = blocks, row_base, mean
        ctx.num_rows = num_rows
        return _bwd(g, blocks, n_in, row_base, mean)

    @staticmethod
    def backward(ctx, ggx):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None, None
        gg = _SegmentMean.apply(ggx, ctx.blocks, ctx.num_rows, ctx.row_base,
                                ctx.mean)
        return gg, None, None, None, None, None


def segment_mean_op(x: torch.Tensor, blocks: dict, *, num_rows: int,
                    row_base=0, mean: bool = True) -> torch.Tensor:
    """Blocked segment mean (every forward's Eq. 1 aggregation),
    differentiable.

    ``x`` is ``(n_in, D)`` with ``(nb, BE)`` blocks, or stacked
    ``(P, n_in, D)`` with ``(P, nb, BE)`` blocks, in which case ONE call
    (one gather grid and, for rows split across warps, one merge grid)
    covers all P partitions.  Output row ``row_base + b·BN + r``
    (below ``num_rows``) holds ``Σ mask·x[src] / deg[b, r]`` over block b's
    slots with local destination r; every other row of the zero
    ``(num_rows, D)`` (or ``(P, num_rows, D)``) output is zero.  ``row_base``
    is an int, a scalar tensor, or a ``(P,)`` tensor for the stacked form.

    The gradient with respect to ``x`` is :func:`segment_mean_bwd_op` over
    the blocks' transpose mirror (``t_*`` keys, from
    :func:`build_vjp_blocks`); nothing runs for an ``x`` that needs no
    gradient.  On both passes a CUDA tensor goes to the hand-written
    kernels (or raises: they need the blocks' work plan, see
    :func:`block_row_work`) and a CPU tensor to the plain version; there is
    no fallback between the two.
    """
    _device_kind(x)
    return _SegmentMean.apply(x, blocks, int(num_rows), row_base, bool(mean))


def segment_mean_bwd_op(g: torch.Tensor, blocks: dict, *, n_in: int,
                        row_base=0, mean: bool = True) -> torch.Tensor:
    """The transpose of :func:`segment_mean_op` (its backward), itself
    differentiable: ``dx[u] = Σ_{slots (u, r)} g[row_base + r] / deg[r]``
    over the real slots whose output row ``row_base + r`` lies below
    ``num_rows``, the rows of ``g``.  ``g`` is ``(num_rows, D)`` or stacked
    ``(P, num_rows, D)``; returns ``(n_in, D)`` (or ``(P, n_in, D)``).  A
    CUDA ``g`` goes to the ``segment_mean_bwd`` kernel, a CPU ``g`` to
    :func:`segment_mean_bwd_plain`."""
    _device_kind(g)
    return _SegmentMeanBwd.apply(g, blocks, int(n_in), g.shape[-2], row_base,
                                 bool(mean))
