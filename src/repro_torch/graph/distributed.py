"""Distributed graph storage + halo exchange, stacked on one device.

Counterpart of ``repro/graph/distributed.py``.  The NumPy half —
:class:`PartitionedGraph`, :func:`build_partitioned_graph` and
:class:`RecomputePlanner` — is copied from the reference unchanged, so the
port builds bitwise the same padded arrays.  Each partition owns a
contiguous local index space:

    [0, n_int)                interior owned nodes: every in-neighbour is
                              local, so their aggregation needs NO halo data
    [n_int, n_own)            boundary owned nodes: >= 1 in-neighbour lives
                              on another partition
    [n_own, n_own + n_halo)   halo slots (1-hop remote in-neighbours, recv'd)
    [n_local, maxN)           padding, with ONE trash row at ``trash_row``
                              (== maxN - 1) never referenced by a real edge

The device half is the reference's ``mode="stacked"`` path, written out:
all P partitions live in ``(P, ...)`` tensors on one device, and the
``vmap``-batched ``all_to_all`` of the reference is the index transpose
``recv[q][p] = sent[p][q]`` of the ``(P, P, maxS, D)`` send buffer.
Beside the synchronous forward there are the overlapped split forward (:func:`make_overlap_forward`, over the
interior/boundary aggregation pairs :func:`make_ref_split_agg` and
:func:`make_kernel_split_agg`), the error-compensated quantized forward
(``make_distributed_forward(compress="fp16" | "int8")``, over the wire
codec :func:`quantize_rows` / :func:`dequantize_rows`) and the forward
against a historical halo cache (:func:`make_cached_forward`, whose
refresh slot range :func:`halo_refresh_plan` picks).  The partition mesh
(``EngineConfig(mode="spmd")``, one partition per ``torch.distributed``
rank) runs one partition's forward per rank (:func:`make_shard_forward`)
with the exchange a real collective (:func:`mesh_exchange`), through the
same bodies: each builder takes the layout it gathers, exchanges and
lands with.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .csr import CSRGraph

__all__ = ["PartitionedGraph", "build_partitioned_graph",
           "make_distributed_forward", "make_export_forward",
           "make_overlap_forward", "make_cached_forward",
           "halo_refresh_plan", "RecomputePlanner",
           "HALO_COMPRESS_MODES", "quantize_rows", "dequantize_rows",
           "wire_row_bytes", "make_ref_mean_agg",
           "make_kernel_mean_agg", "make_ref_split_agg",
           "make_kernel_split_agg", "make_ref_shard_mean_agg",
           "make_ref_shard_split_agg",
           "make_shard_forward", "mesh_exchange"]


@dataclass
class PartitionedGraph:
    """Stacked, padded per-partition arrays (leading axis = partition)."""

    num_parts: int
    n_own: np.ndarray          # (P,) owned-node counts
    n_int: np.ndarray          # (P,) interior counts (first n_int owned rows)
    n_halo: np.ndarray         # (P,) halo counts
    max_nodes: int             # padded local size (incl. trash row)
    own_cap: int               # max(n_own): static owned-row cap
    features: np.ndarray       # (P, maxN, D)   halo+pad rows zero
    labels: np.ndarray         # (P, maxN)      -1 on non-owned
    edge_src: np.ndarray       # (P, maxE) local ids  (pad -> trash row)
    edge_dst: np.ndarray       # (P, maxE) local ids  (pad -> trash row)
    edge_mask: np.ndarray      # (P, maxE) float32
    int_src: np.ndarray        # (P, maxEi) interior-dst edges (owned src only)
    int_dst: np.ndarray        # (P, maxEi) dst in [0, n_int)  (pad -> own_cap)
    int_mask: np.ndarray       # (P, maxEi) float32
    bnd_src: np.ndarray        # (P, maxEb) boundary-dst edges (owned+halo src)
    bnd_dst: np.ndarray        # (P, maxEb) dst in [n_int, n_own) (pad -> own_cap)
    bnd_mask: np.ndarray       # (P, maxEb) float32
    deg: np.ndarray            # (P, own_cap) float32 in-degree, clamped >= 1
    send_idx: np.ndarray       # (P, P, maxS) local owned ids to send to q
    send_mask: np.ndarray      # (P, P, maxS)
    recv_pos: np.ndarray       # (P, P, maxS) local halo slot for recv from q
    global_ids: np.ndarray     # (P, maxN) global node id (-1 pad)
    train_mask: np.ndarray     # (P, maxN) bool, owned train nodes
    val_mask: np.ndarray       # (P, maxN)
    test_mask: np.ndarray      # (P, maxN)

    @property
    def trash_row(self) -> int:
        """The one sacrificial local row (== max_nodes - 1).  Padding in the
        combined edge arrays and in ``recv_pos`` points here; the forward
        keeps it all-zero at every layer, and :func:`build_partitioned_graph`
        asserts no real edge or real recv slot ever references it."""
        return self.max_nodes - 1

    @property
    def n_boundary(self) -> np.ndarray:
        return self.n_own - self.n_int

    @property
    def halo_bytes_per_layer(self) -> int:
        d = self.features.shape[-1]
        return int(self.n_halo.sum()) * d * self.features.dtype.itemsize

    def halo_slot_bytes(self, lo: int, hi: int) -> int:
        """Real (unpadded) payload of exchanging send slots ``[lo, hi)`` of
        every partition pair, per layer — the refreshed-row bytes a cached
        forward puts on the wire.  ``halo_slot_bytes(0, maxS)`` equals
        :attr:`halo_bytes_per_layer` (every real slot lives in some pair's
        slot range, and Σ_q n_halo[q] counts each exactly once)."""
        d = self.features.shape[-1]
        real = int(self.send_mask[:, :, lo:hi].sum())
        return real * d * self.features.dtype.itemsize

    @property
    def padded_wire_bytes_per_exchange(self) -> int:
        """Bytes the padded static collective actually moves per layer
        (all pair slots padded to maxS), vs the real payload of
        :attr:`halo_bytes_per_layer`."""
        d = self.features.shape[-1]
        return int(np.prod(self.send_idx.shape)) * d * self.features.dtype.itemsize

    def summary(self) -> str:
        return (
            f"P={self.num_parts} own={self.n_own.tolist()} "
            f"int={self.n_int.tolist()} halo={self.n_halo.tolist()} "
            f"maxN={self.max_nodes} ownCap={self.own_cap} "
            f"maxE={self.edge_src.shape[1]} "
            f"maxEi={self.int_src.shape[1]} maxEb={self.bnd_src.shape[1]} "
            f"halo_bytes/layer={self.halo_bytes_per_layer}"
        )


def build_partitioned_graph(
    graph: CSRGraph, parts: np.ndarray, num_parts: int
) -> PartitionedGraph:
    parts = np.asarray(parts)
    n = graph.num_nodes
    P = num_parts
    owned0 = [np.flatnonzero(parts == p) for p in range(P)]

    # per-partition edge lists (grouped per owned dst), 1-hop halo, and the
    # interior/boundary classification: a node is BOUNDARY iff any of its
    # in-neighbours lives on another partition
    owned, halos, local_edges, n_int = [], [], [], np.zeros(P, np.int64)
    for p in range(P):
        own = owned0[p]
        src_all, dst_all = [], []
        for v in own:
            nbrs = graph.neighbors(v)
            src_all.append(nbrs)
            dst_all.append(np.full(len(nbrs), v))
        src = np.concatenate(src_all) if src_all else np.zeros(0, np.int64)
        dst = np.concatenate(dst_all) if dst_all else np.zeros(0, np.int64)
        remote = parts[src] != p
        halos.append(np.unique(src[remote]))
        is_bnd = np.zeros(n, dtype=bool)
        is_bnd[dst[remote]] = True
        interior = own[~is_bnd[own]]
        boundary = own[is_bnd[own]]
        owned.append(np.concatenate([interior, boundary]))
        n_int[p] = len(interior)
        local_edges.append((src, dst))

    n_own = np.array([len(o) for o in owned])
    n_halo = np.array([len(h) for h in halos])
    max_nodes = int((n_own + n_halo).max()) + 1          # +1 trash row
    own_cap = int(n_own.max())
    max_edges = max(1, int(max(len(e[0]) for e in local_edges)))

    d = graph.feature_dim
    feats = np.zeros((P, max_nodes, d), dtype=np.float32)
    labels = np.full((P, max_nodes), -1, dtype=np.int64)
    gids = np.full((P, max_nodes), -1, dtype=np.int64)
    trash = max_nodes - 1
    e_src = np.full((P, max_edges), trash, dtype=np.int32)
    e_dst = np.full((P, max_edges), trash, dtype=np.int32)
    e_msk = np.zeros((P, max_edges), dtype=np.float32)
    deg = np.ones((P, own_cap), dtype=np.float32)
    tr_m = np.zeros((P, max_nodes), dtype=bool)
    va_m = np.zeros((P, max_nodes), dtype=bool)
    te_m = np.zeros((P, max_nodes), dtype=bool)

    # global -> (partition, local id); locals follow the [interior | boundary]
    # owned order so boundary rows are the contiguous range [n_int, n_own)
    g2l = np.full(n, -1, dtype=np.int64)
    for p in range(P):
        g2l[owned[p]] = np.arange(n_own[p])

    halo_l = []            # (P,) global id -> halo slot, as a dense map
    for p in range(P):
        hmap = np.full(n, trash, dtype=np.int64)
        hmap[halos[p]] = n_own[p] + np.arange(n_halo[p])
        halo_l.append(hmap)

    tr, va, te = set(graph.train_idx), set(graph.val_idx), set(graph.test_idx)
    split_src, split_dst = [], []   # per-partition local edges, dst-major
    for p in range(P):
        own = owned[p]
        feats[p, : n_own[p]] = graph.features[own]
        labels[p, : n_own[p]] = graph.labels[own]
        gids[p, : n_own[p]] = own
        if len(halos[p]):
            # halo features start zero; they arrive via exchange
            gids[p, n_own[p] : n_own[p] + n_halo[p]] = halos[p]
        for j, v in enumerate(own):
            tr_m[p, j] = int(v) in tr
            va_m[p, j] = int(v) in va
            te_m[p, j] = int(v) in te

        # re-emit edges dst-major in the NEW local order (interior rows
        # first), keeping each destination's in-neighbour order — that order
        # is what makes split and combined aggregation bit-identical per row
        src, dst = local_edges[p]
        loc_src0 = np.where(parts[src] == p, g2l[src], halo_l[p][src]).astype(np.int64)
        loc_dst0 = g2l[dst]
        order = np.argsort(loc_dst0, kind="stable")
        loc_src = loc_src0[order].astype(np.int32)
        loc_dst = loc_dst0[order].astype(np.int32)
        e_src[p, : len(src)] = loc_src
        e_dst[p, : len(dst)] = loc_dst
        e_msk[p, : len(src)] = 1.0
        split_src.append(loc_src)
        split_dst.append(loc_dst)
        counts = np.bincount(loc_dst, minlength=own_cap)[:own_cap]
        deg[p] = np.maximum(counts, 1).astype(np.float32)

    # destination-disjoint CSR shards: dst-major order puts all interior-dst
    # edges (dst < n_int) ahead of the boundary-dst edges
    n_int_edges = [int(np.searchsorted(split_dst[p], n_int[p]))
                   for p in range(P)]
    max_ei = max(1, max(n_int_edges))
    max_eb = max(1, max(len(split_dst[p]) - n_int_edges[p] for p in range(P)))
    # split pads: src -> trash row (guaranteed zero, so no mask multiply is
    # needed on the hot path), dst -> the sacrificial segment row ``own_cap``
    i_src = np.full((P, max_ei), trash, dtype=np.int32)
    i_dst = np.full((P, max_ei), own_cap, dtype=np.int32)
    i_msk = np.zeros((P, max_ei), dtype=np.float32)
    b_src = np.full((P, max_eb), trash, dtype=np.int32)
    b_dst = np.full((P, max_eb), own_cap, dtype=np.int32)
    b_msk = np.zeros((P, max_eb), dtype=np.float32)
    for p in range(P):
        k = n_int_edges[p]
        i_src[p, :k] = split_src[p][:k]
        i_dst[p, :k] = split_dst[p][:k]
        i_msk[p, :k] = 1.0
        kb = len(split_src[p]) - k
        b_src[p, :kb] = split_src[p][k:]
        b_dst[p, :kb] = split_dst[p][k:]
        b_msk[p, :kb] = 1.0

    # send lists: p sends owned node g to q whenever g is in q's halo
    send_lists = [[[] for _ in range(P)] for _ in range(P)]
    recv_lists = [[[] for _ in range(P)] for _ in range(P)]
    for q in range(P):
        for g in halos[q]:
            p = int(parts[g])
            send_lists[p][q].append(int(g2l[g]))
            recv_lists[q][p].append(int(halo_l[q][g]))
    max_s = max(1, max(len(send_lists[p][q]) for p in range(P) for q in range(P)))
    s_idx = np.zeros((P, P, max_s), dtype=np.int32)
    s_msk = np.zeros((P, P, max_s), dtype=np.float32)
    r_pos = np.full((P, P, max_s), trash, dtype=np.int32)  # pad -> trash
    for p in range(P):
        for q in range(P):
            ks = len(send_lists[p][q])
            if ks:
                s_idx[p, q, :ks] = send_lists[p][q]
                s_msk[p, q, :ks] = 1.0
            kr = len(recv_lists[p][q])  # aligned with send_lists[q][p]
            if kr:
                r_pos[p, q, :kr] = recv_lists[p][q]

    # trash-row hygiene (the invariant the fast path relies on): no REAL
    # edge endpoint and no REAL recv slot may reference the trash row, so it
    # stays all-zero through every layer
    assert not (e_src[e_msk > 0] == trash).any(), "real edge src hit trash row"
    assert not (e_dst[e_msk > 0] == trash).any(), "real edge dst hit trash row"
    assert not (i_src[i_msk > 0] == trash).any()
    assert not (b_src[b_msk > 0] == trash).any()
    # recv_pos[p, q] aligns with send_lists[q][p], i.e. with s_msk[q, p]
    assert not (r_pos[np.swapaxes(s_msk, 0, 1) > 0] == trash).any(), \
        "real recv slot hit trash row"

    return PartitionedGraph(
        num_parts=P, n_own=n_own, n_int=n_int, n_halo=n_halo,
        max_nodes=max_nodes, own_cap=own_cap,
        features=feats, labels=labels, edge_src=e_src, edge_dst=e_dst,
        edge_mask=e_msk, int_src=i_src, int_dst=i_dst, int_mask=i_msk,
        bnd_src=b_src, bnd_dst=b_dst, bnd_mask=b_msk, deg=deg,
        send_idx=s_idx, send_mask=s_msk, recv_pos=r_pos,
        global_ids=gids, train_mask=tr_m, val_mask=va_m, test_mask=te_m,
    )


# ---------------------------------------------------------------------------
# halo exchange, stacked
# ---------------------------------------------------------------------------

def _exchange(sent: torch.Tensor) -> torch.Tensor:
    """``sent[p][q]`` = rows partition p ships to q, ``(P, P, maxS, D)``;
    returns ``recv`` with ``recv[q][p] = sent[p][q]`` — what the reference's
    ``all_to_all(split_axis=0, concat_axis=0)`` makes under ``vmap``.  With
    all partitions stacked on one device this transpose is the whole
    exchange, whatever ``ring_chunks`` says; the partition mesh runs the
    collective and the ring (:class:`_MeshExchange`)."""
    return sent.transpose(0, 1)


def _gather_send(h: torch.Tensor, send_idx: torch.Tensor,
                 send_mask: torch.Tensor) -> torch.Tensor:
    """Every partition's masked send rows: ``(P, maxN, D)`` ->
    ``(P, P, maxS, D)``.  Pad slots gather row 0 times a zero mask."""
    parts = torch.arange(h.shape[0], device=h.device)[:, None, None]
    return h[parts, send_idx] * send_mask[..., None]


def _land(h: torch.Tensor, recv: torch.Tensor,
          recv_pos: torch.Tensor) -> torch.Tensor:
    """``h`` with ``recv`` ``(P, P, maxS, D)`` scattered into its halo
    slots, as a NEW tensor: ``h`` is often the previous layer's ReLU
    output, which autograd keeps for its backward, so it is never written
    in place.  Pad slots all point at the trash row; on CUDA the order
    among those duplicates is unspecified, which is harmless because every
    pad payload is ``h[0] * 0`` (a zero, possibly ``-0.0``, whose gradient
    is zero too)."""
    P, d = h.shape[0], h.shape[-1]
    parts = torch.arange(P, device=h.device)[:, None]
    return h.index_put((parts, recv_pos.reshape(P, -1)),
                       recv.reshape(P, -1, d).to(h.dtype))


def _halo_exchange(h: torch.Tensor, send_idx, send_mask,
                   recv_pos) -> torch.Tensor:
    """One exchange round over all partitions: ``h`` with its halo rows
    landed (a new tensor)."""
    return _land(h, _exchange(_gather_send(h, send_idx, send_mask)), recv_pos)


# ---------------------------------------------------------------------------
# halo exchange on the partition mesh (one partition per rank)
# ---------------------------------------------------------------------------

def _gather_send_shard(h: torch.Tensor, send_idx: torch.Tensor,
                       send_mask: torch.Tensor) -> torch.Tensor:
    """One partition's masked send rows: ``(maxN, D)`` -> ``(P, maxS, D)``,
    row p of :func:`_gather_send`."""
    return h[send_idx] * send_mask[..., None]


def _land_shard(h: torch.Tensor, recv: torch.Tensor,
                recv_pos: torch.Tensor) -> torch.Tensor:
    """One partition's :func:`_land`: ``recv`` ``(P, maxS, D)`` scattered
    into the halo slots of ``h`` ``(maxN, D)`` as a new tensor, the pad
    slots into the trash row."""
    return h.index_put((recv_pos.reshape(-1),),
                       recv.reshape(-1, h.shape[-1]).to(h.dtype))


class _MeshExchange(torch.autograd.Function):
    """The halo exchange across ranks: ``sent[q]`` goes to rank q, and
    ``recv[q]`` comes from it (``engine.compat.exchange``: one all_to_all
    or the chunked ring).  The map ``recv_p[q] = sent_q[p]`` is its own
    transpose, so the backward is the same exchange of the incoming
    gradient, as under the reference's VJP of ``all_to_all``: every rank
    must run it, in the same order, which the identical autograd graphs of
    the ranks give."""

    @staticmethod
    def forward(ctx, sent, mesh, ring_chunks):
        from ..engine.compat import exchange
        ctx.mesh, ctx.ring_chunks = mesh, ring_chunks
        return exchange(sent, mesh, ring_chunks)

    @staticmethod
    def backward(ctx, g):
        from ..engine.compat import exchange
        return exchange(g, ctx.mesh, ctx.ring_chunks), None, None


def mesh_exchange(sent: torch.Tensor, mesh,
                  ring_chunks: int = 0) -> torch.Tensor:
    """Differentiable halo exchange of one partition's send block
    ``(P, maxS, D)`` over ``mesh`` (see :class:`_MeshExchange`)."""
    return _MeshExchange.apply(sent, mesh, int(ring_chunks))


class _MeshExchangeWait(torch.autograd.Function):
    """The end of an exchange started earlier (``engine.compat.
    exchange_start``): the forward waits for it and returns ``recv``; the
    backward is :class:`_MeshExchange`'s, the synchronous exchange of the
    incoming gradient.  ``sent`` only ties ``recv`` to the send block in
    the autograd graph."""

    @staticmethod
    def forward(ctx, sent, pending, mesh, ring_chunks):
        ctx.mesh, ctx.ring_chunks = mesh, ring_chunks
        return pending.wait()

    @staticmethod
    def backward(ctx, g):
        from ..engine.compat import exchange
        return exchange(g, ctx.mesh, ctx.ring_chunks), None, None, None


# ---------------------------------------------------------------------------
# layouts: what a forward's body calls to gather, exchange and land
# ---------------------------------------------------------------------------

class _Stacked:
    """Every partition on one device, ``(P, ...)`` tensors: the exchange is
    the index transpose, and starting it computes it."""

    gather = staticmethod(_gather_send)
    land = staticmethod(_land)
    exchange = staticmethod(_exchange)

    @staticmethod
    def start(sent):
        return _exchange(sent)

    @staticmethod
    def finish(started):
        return started

    @staticmethod
    def layer(model, lp, h, a, activate: bool):
        return model._layer(lp, h, a, activate)

    @staticmethod
    def lift(lp, x):
        return x

    @staticmethod
    def drop(lp, x):
        return x

    @staticmethod
    def interior(n_int, own_cap: int, device):
        """``(P, own_cap, 1)``: row < the partition's ``n_int``."""
        rows = torch.arange(own_cap, device=device)[None, :, None]
        return rows < n_int[:, None, None]


STACKED = _Stacked()


class _Shard:
    """One partition of the mesh: the rank's arrays without the partition
    axis, the exchange a collective (``ring_chunks`` picking its schedule)
    and ``n_int`` a Python int.  Per-partition params arrive as the
    rank's row with a partition axis of 1: their products run batched on
    the rows lifted to that axis, as the stacked forward runs them."""

    gather = staticmethod(_gather_send_shard)
    land = staticmethod(_land_shard)

    def __init__(self, mesh, ring_chunks: int = 0):
        self.mesh, self.ring_chunks = mesh, int(ring_chunks)

    def exchange(self, sent):
        return mesh_exchange(sent, self.mesh, self.ring_chunks)

    def start(self, sent):
        from ..engine.compat import exchange_start
        return sent, exchange_start(sent.detach(), self.mesh,
                                    self.ring_chunks)

    def finish(self, started):
        sent, pending = started
        return _MeshExchangeWait.apply(sent, pending, self.mesh,
                                       self.ring_chunks)

    @staticmethod
    def layer(model, lp, h, a, activate: bool):
        if lp.w_self.dim() == 3:
            return model._layer(lp, h[None], a[None], activate)[0]
        return model._layer(lp, h, a, activate)

    @staticmethod
    def lift(lp, x):
        return x[None] if lp.w_self.dim() == 3 else x

    @staticmethod
    def drop(lp, x):
        return x[0] if lp.w_self.dim() == 3 else x

    @staticmethod
    def interior(n_int: int, own_cap: int, device):
        """``(own_cap, 1)``: row < ``n_int``."""
        return torch.arange(own_cap, device=device)[:, None] < n_int


# ---------------------------------------------------------------------------
# wire codecs (compressed communication)
# ---------------------------------------------------------------------------

HALO_COMPRESS_MODES = ("none", "fp16", "int8")


def quantize_rows(x: torch.Tensor, mode: str):
    """Quantize ``x`` (..., D) row-wise -> ``(payload, scale)``.

    ``fp16``  plain downcast, no side channel (scale is None).
    ``int8``  symmetric per-row scale ``max(|row|) / 127``: payload is int8
              in [-127, 127] (``torch.round`` rounds half to even, as
              ``jnp.round`` does), scale travels as one float32 per row.
              An all-zero row quantizes to (0, scale 0) and dequantizes to
              exact zeros, which keeps pad slots (and through them the
              trash row) clean across a compressed exchange.

    All arithmetic runs in ``x``'s dtype (a bf16 row's ``amax / 127`` and
    ``x / safe`` stay bf16), so the f64 oracle models the engine's
    quantization exactly.  The divisor 127 is a tensor filled on ``x``'s
    device: CUDA divides by a Python scalar as a product with its
    reciprocal, which is not bitwise the quotient, and a tensor made from
    a host value would be a copy that synchronises the stream."""
    if mode == "fp16":
        return x.to(torch.float16), None
    if mode == "int8":
        amax = x.abs().amax(dim=-1, keepdim=True)
        scale = amax / torch.full_like(amax, 127.0)
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        q = torch.round(x / safe).clamp(-127, 127).to(torch.int8)
        return q, scale.to(torch.float32)
    raise ValueError(f"unknown halo compression mode {mode!r} "
                     f"(expected one of {HALO_COMPRESS_MODES[1:]})")


def dequantize_rows(payload: torch.Tensor, scale, mode: str, dtype):
    """Inverse of :func:`quantize_rows` into ``dtype``.  Elementwise and
    deterministic, so the sender's dequantization (error feedback) and the
    receiver's of the same payload are bitwise equal."""
    if mode == "fp16":
        return payload.to(dtype)
    if mode == "int8":
        return payload.to(dtype) * scale.to(dtype)
    raise ValueError(f"unknown halo compression mode {mode!r}")


def wire_row_bytes(d: int, mode: str, itemsize: int = 4) -> int:
    """Bytes ONE exchanged embedding row of width ``d`` occupies on the
    wire: the uncompressed row is ``d * itemsize``, fp16 halves it, int8
    ships one byte per element plus the row's float32 scale."""
    if mode == "none":
        return d * itemsize
    if mode == "fp16":
        return d * 2
    if mode == "int8":
        return d + 4
    raise ValueError(f"unknown halo compression mode {mode!r}")


def _ef_quantized_exchange(sent: torch.Tensor, mask3: torch.Tensor,
                           residual: torch.Tensor, mode: str, out_dtype,
                           exchange=_exchange):
    """Error-compensated quantized exchange of the gathered send buffer
    ``sent`` ``(P, P, S, D)`` (``sent[p][q]``: p's rows for q), or of one
    partition's ``(P, S, D)`` with the mesh's ``exchange``.  Returns
    ``(recv, new_residual)``:

      sent_ef = (sent + residual) * mask        # carry last round's error
      payload = quantize(sent_ef)               # what goes on the wire
      new_residual = (sent_ef - dequant(payload)) * mask
      recv = dequant(exchange(payload))         # landed at the receiver

    The int8 per-row scales travel after the payload by the same
    exchange: on the mesh, two collectives, as in the reference."""
    sent_ef = (sent + residual.to(sent.dtype)) * mask3
    payload, scale = quantize_rows(sent_ef, mode)
    deq = dequantize_rows(payload, scale, mode, sent.dtype)
    new_residual = ((sent_ef - deq) * mask3).to(residual.dtype)
    recv_p = exchange(payload)
    recv_s = None if scale is None else exchange(scale)
    return dequantize_rows(recv_p, recv_s, mode, out_dtype), new_residual


def halo_refresh_plan(age: int, refresh_every: int, cv: bool,
                      max_send: int) -> tuple[int, int]:
    """Static send-slot range ``[lo, hi)`` the next cached forward refreshes.

    ``age`` counts distributed eval forwards since the cache was created
    (host-side, so the choice is a Python constant baked into the trace —
    the cached-epoch executable contains NO collective at all).

      age % K == 0        full refresh: (0, max_send) — bit-for-bit the
                          synchronous exchange, which is what makes the
                          staleness-0 (K == 1) path bitwise-identical to
                          :func:`make_distributed_forward`.
      otherwise, cv off   (0, 0): aggregate purely against the cache.
      otherwise, cv on    the VR-GCN-style partial refresh: the slot space
                          is cut into K-1 contiguous chunks and cached
                          epoch c refreshes chunk c, so every halo row is
                          re-exchanged within K epochs (staleness bound)
                          and each cached epoch pays ~1/(K-1) of the full
                          payload — the "cached h plus the delta of the
                          refreshed rows" estimator.
    """
    K = max(1, int(refresh_every))
    if K == 1 or age % K == 0:
        return 0, max_send
    if not cv:
        return 0, 0
    c = (age % K) - 1
    nc = K - 1
    return (c * max_send) // nc, ((c + 1) * max_send) // nc


# ---------------------------------------------------------------------------
# aggregation backends
# ---------------------------------------------------------------------------

def _segment_sum(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                 num_rows: int, weight=None) -> torch.Tensor:
    """``out[p, v] = Σ_{e: dst[p, e] = v} h[p, src[p, e]] (· weight[p, e])``
    into ``(P, num_rows, D)``, with ``index_add_``."""
    P, _, d = h.shape
    parts = torch.arange(P, device=h.device)[:, None]
    msg = h[parts, src]
    if weight is not None:
        msg = msg * weight[..., None]
    s = torch.zeros((P * num_rows, d), dtype=h.dtype, device=h.device)
    s.index_add_(0, (dst + parts * num_rows).reshape(-1), msg.reshape(-1, d))
    return s.reshape(P, num_rows, d)


def make_ref_mean_agg(max_nodes: int):
    """Plain segment-sum mean aggregation over the stacked local edge
    lists (``index_add_`` in place of ``jax.ops.segment_sum``)."""

    def mean_agg(h: torch.Tensor, shards: dict) -> torch.Tensor:
        P, n, _ = h.shape
        mask = shards["edge_mask"].to(h.dtype)
        s = _segment_sum(h, shards["edge_src"], shards["edge_dst"], n, mask)
        deg = torch.zeros(P * n, dtype=h.dtype, device=h.device)
        parts = torch.arange(P, device=h.device)[:, None]
        deg.index_add_(0, (shards["edge_dst"] + parts * n).reshape(-1),
                       mask.reshape(-1))
        return s / deg.clamp_min(1.0).reshape(P, n, 1)

    return mean_agg


def make_ref_split_agg(own_cap: int):
    """Plain interior/boundary aggregation pair of the overlapped forward
    (``(agg_interior, agg_boundary)``).  Each maps ``(h, shards) ->
    (P, own_cap, D)`` and is only meaningful on its own rows: ``[0,
    n_int)`` for the interior half, ``[n_int, n_own)`` for the boundary
    half; the caller selects per row.

    No mask multiply and no degree pass: padding edges read the all-zero
    trash row and land in the sacrificial row ``own_cap``, which is sliced
    off, and the in-degree is the static ``shards["deg"]``."""

    def half(src_key: str, dst_key: str):
        def agg(h: torch.Tensor, shards: dict) -> torch.Tensor:
            s = _segment_sum(h, shards[src_key], shards[dst_key],
                             own_cap + 1)[:, :own_cap]
            return s / shards["deg"][..., None].to(h.dtype)

        return agg

    return half("int_src", "int_dst"), half("bnd_src", "bnd_dst")


def make_kernel_mean_agg(max_nodes: int):
    """Kernel mean aggregation (counterpart of ``make_pallas_mean_agg``):
    ONE ``segment_mean_op`` launch over the stacked blocked-CSR structure
    ``shards["blk"]`` (``engine.stacking.build_stacked_vjp_blocks``) covers
    all partitions."""
    from ..kernels.segment_agg import segment_mean_op

    def mean_agg(h: torch.Tensor, shards: dict) -> torch.Tensor:
        return segment_mean_op(h, shards["blk"],
                               num_rows=max_nodes).to(h.dtype)

    return mean_agg


def make_ref_shard_mean_agg(max_nodes: int):
    """One partition's :func:`make_ref_mean_agg`: ``(h (maxN, D), shard)``
    with the partition's ``(maxE,)`` edge arrays, through the stacked
    function on a partition axis of 1 (the same ops, so the same rows)."""
    stacked = make_ref_mean_agg(max_nodes)
    keys = ("edge_src", "edge_dst", "edge_mask")

    def mean_agg(h: torch.Tensor, shard: dict) -> torch.Tensor:
        return stacked(h[None], {k: shard[k][None] for k in keys})[0]

    return mean_agg


def make_ref_shard_split_agg(own_cap: int):
    """One partition's :func:`make_ref_split_agg` pair, through the stacked
    halves on a partition axis of 1 (the same ops, so the same rows)."""
    halves = make_ref_split_agg(own_cap)
    keys = ("int_src", "int_dst", "bnd_src", "bnd_dst", "deg")

    def shard_half(half):
        def agg(h: torch.Tensor, shard: dict) -> torch.Tensor:
            return half(h[None], {k: shard[k][None] for k in keys})[0]

        return agg

    return tuple(shard_half(h) for h in halves)


def make_kernel_split_agg(own_cap: int):
    """Kernel interior/boundary pair (counterpart of
    ``make_pallas_split_agg``): each half is ONE ``segment_mean_op`` launch
    over its own stacked row-range blocks (``shards["blk_int"]`` /
    ``shards["blk_bnd"]``, from
    ``engine.stacking.build_stacked_split_vjp_blocks``), placed into the
    ``(P, own_cap, D)`` output at ``row_base`` 0 (interior) or at each
    partition's ``n_int`` (boundary, the ``(P,)`` tensor
    ``shards["n_int"]``; on the partition mesh one partition's unstacked
    blocks and its ``n_int`` as a Python int, so no row base is read back
    from the device).  Both halves are differentiable: the boundary half's
    backward reaches owned and halo source rows."""
    from ..kernels.segment_agg import segment_mean_op

    def agg_interior(h: torch.Tensor, shards: dict) -> torch.Tensor:
        return segment_mean_op(h, shards["blk_int"], num_rows=own_cap,
                               row_base=0).to(h.dtype)

    def agg_boundary(h: torch.Tensor, shards: dict) -> torch.Tensor:
        return segment_mean_op(h, shards["blk_bnd"], num_rows=own_cap,
                               row_base=shards["n_int"]).to(h.dtype)

    return agg_interior, agg_boundary


# ---------------------------------------------------------------------------
# stacked forwards
# ---------------------------------------------------------------------------

def make_distributed_forward(model, pg_meta: dict, agg=None,
                             compress: str = "none", layout=STACKED):
    """The n-layer SYNCHRONOUS forward with halo exchange, over all
    partitions at once: ``fwd(params, shards) -> (P, maxN, C)`` logits,
    ``shards`` holding the stacked ``(P, ...)`` tensors.  ``params`` is a
    ``GraphSAGE`` in the shared or the per-partition form.  The forward is
    differentiable: the exchange's backward routes each halo row's gradient
    to the partition that sent it.

    ``agg(h, shards) -> (P, maxN, D)`` selects the aggregation backend
    (default: :func:`make_ref_mean_agg`).

    ``compress="none"`` returns exactly the forward above.  ``"fp16"`` /
    ``"int8"`` return the error-compensated quantized forward
    ``fwd(params, shards, residual) -> (logits, new_residual)``, where
    ``residual["r{i}"]`` ``(P, P, maxS, D_i)`` is layer i's carried
    send-side quantization error in send-list layout.

    ``layout`` is what the body gathers, exchanges and lands with: the
    stacked one here, one partition's on the mesh
    (:func:`make_shard_forward`).
    """
    mean_agg = agg if agg is not None else make_ref_mean_agg(
        pg_meta["max_nodes"])
    L = layout

    if compress == "none":
        def fwd(params, shards: dict) -> torch.Tensor:
            h = shards["features"]
            last = len(params.layers) - 1
            for i, lp in enumerate(params.layers):
                recv = L.exchange(L.gather(h, shards["send_idx"],
                                           shards["send_mask"]))
                h = L.land(h, recv, shards["recv_pos"])
                h = L.layer(model, lp, h, mean_agg(h, shards), i < last)
            return h

        return fwd

    def fwd_c(params, shards: dict, residual: dict):
        h = shards["features"]
        mask3 = shards["send_mask"][..., None]
        last = len(params.layers) - 1
        new_res = {}
        for i, lp in enumerate(params.layers):
            sent = L.gather(h, shards["send_idx"], shards["send_mask"])
            recv, new_res[f"r{i}"] = _ef_quantized_exchange(
                sent, mask3, residual[f"r{i}"], compress, h.dtype,
                L.exchange)
            h = L.land(h, recv, shards["recv_pos"])
            h = L.layer(model, lp, h, mean_agg(h, shards), i < last)
        return h, new_res

    return fwd_c


def make_cached_forward(model, pg_meta: dict, agg=None, refresh_lo: int = 0,
                        refresh_hi: int | None = None,
                        compress: str = "none", layout=STACKED):
    """The n-layer forward against a HISTORICAL halo cache, over all
    partitions: ``fwd(params, shards, cache) -> (logits, new_cache)``, where
    ``cache["h{i}"]`` ``(P, P, maxS, D_i)`` holds layer i's last-received
    exchange buffers in recv layout (``cache["h{i}"][q][p]`` = the rows p
    last sent to q).

    ``[refresh_lo, refresh_hi)`` is the static send-slot range this call
    re-exchanges (from :func:`halo_refresh_plan`); everything outside it
    aggregates against the cached rows:

      full range    no cache landing: gather, exchange and landing are
                    exactly :func:`make_distributed_forward`'s, so the
                    forward is bitwise the synchronous one, and it also
                    snapshots the recv buffers into the cache.
      empty range   land the cached rows only; no exchange.
      partial       land the cache, then exchange just the slot slice and
                    overwrite those rows fresh (the control-variate delta).

    Cached rows enter the aggregation detached (no gradient through past
    epochs).  Pad slots of the cache stay zero: the refresh writes the
    sender-masked pad rows into them, so landing the cache never puts a
    non-zero into the trash row.

    ``compress != "none"`` quantizes the refreshed slice with error
    feedback on the matching residual slice, and the cache stores the
    dequantized rows: ``fwd(params, shards, cache, residual) -> (logits,
    new_cache, new_residual)``.

    With one partition's ``layout`` (:func:`make_shard_forward`) the cache
    and residual are the rank's ``(P, maxS, D_i)`` rows, and the empty
    range runs no collective at all.
    """
    mean_agg = agg if agg is not None else make_ref_mean_agg(
        pg_meta["max_nodes"])
    lo = int(refresh_lo)
    L = layout

    def land_and_refresh(h, shards, cached, res=None):
        max_s = shards["send_idx"].shape[-1]
        hi = max_s if refresh_hi is None else int(refresh_hi)
        full = lo == 0 and hi == max_s
        if hi > lo:
            # gather (and, compressed, quantize) BEFORE any cache landing:
            # send_idx only points at owned rows, and this order keeps the
            # full refresh's ops those of the synchronous forward
            mask = shards["send_mask"][..., lo:hi]
            sent = L.gather(h, shards["send_idx"][..., lo:hi], mask)
        if not full:
            h = L.land(h, cached.detach(), shards["recv_pos"])
        if hi > lo:
            if res is None:
                recv = L.exchange(sent)
            else:
                recv, new_r = _ef_quantized_exchange(
                    sent, mask[..., None], res[..., lo:hi, :], compress,
                    h.dtype, L.exchange)
                res = res.clone()
                res[..., lo:hi, :] = new_r
            h = L.land(h, recv, shards["recv_pos"][..., lo:hi])
            cached = cached.detach().clone()
            cached[..., lo:hi, :] = recv.to(cached.dtype)
        return h, cached, res

    def fwd(params, shards: dict, cache: dict):
        h = shards["features"]
        last = len(params.layers) - 1
        new_cache = {}
        for i, lp in enumerate(params.layers):
            h, new_cache[f"h{i}"], _ = land_and_refresh(h, shards,
                                                        cache[f"h{i}"])
            h = L.layer(model, lp, h, mean_agg(h, shards), i < last)
        return h, new_cache

    def fwd_c(params, shards: dict, cache: dict, residual: dict):
        h = shards["features"]
        last = len(params.layers) - 1
        new_cache, new_res = {}, {}
        for i, lp in enumerate(params.layers):
            h, new_cache[f"h{i}"], new_res[f"r{i}"] = land_and_refresh(
                h, shards, cache[f"h{i}"], residual[f"r{i}"])
            h = L.layer(model, lp, h, mean_agg(h, shards), i < last)
        return h, new_cache, new_res

    return fwd if compress == "none" else fwd_c


def _neigh_weights(lp):
    """``(w_self, w_neigh, b)`` of a layer for ``(P, rows, d)`` inputs: a
    per-partition bias ``(P, d_out)`` gains the rows axis."""
    b = lp.b if lp.b.dim() == 1 else lp.b[:, None]
    return lp.w_self, lp.w_neigh, b


def make_overlap_forward(model, pg_meta: dict, agg_interior=None,
                         agg_boundary=None, layout=STACKED):
    """The n-layer OVERLAPPED split forward over all partitions:
    ``fwd(params, shards) -> (P, maxN, C)``, of which only the owned rows
    ``[0, n_own)`` are meaningful.  Each layer runs the reference's order:

      1. gather the send rows and exchange them,
      2. the interior aggregation and the self term ``h[:, :own_cap] @
         w_self``, neither of which reads a halo row,
      3. land the received rows (a new tensor),
      4. the boundary aggregation, then the per-row select
         ``torch.where(row < n_int, interior, boundary)`` (a select, so
         neither half's ``-0.0`` or NaN leaks into the other's rows),

    and re-embeds the ``own_cap`` rows into ``(P, maxN, D)`` with zero
    rows after them (the trash row stays zero; halo rows are refreshed by
    the next layer's exchange before anything reads them).  Dense products
    and aggregation outputs cover ``own_cap`` rows instead of ``maxN``.
    Stacked on one device the exchange is an index copy on the same
    stream, so nothing runs concurrently.  ``shards`` holds the stacked
    tensors plus ``n_int`` ``(P,)`` and the split aggregation's
    structures.  With one partition's ``layout`` (:func:`make_shard_forward`)
    step 1 starts the collective and step 3 waits for it, so it runs while
    step 2 does (its backward is the synchronous exchange); ``n_int`` is
    then the rank's Python int.
    """
    max_nodes, own_cap = pg_meta["max_nodes"], pg_meta["own_cap"]
    if agg_interior is None or agg_boundary is None:
        agg_interior, agg_boundary = make_ref_split_agg(own_cap)
    L = layout

    def split_layer(h, shards, lp, activate: bool):
        w_self, w_neigh, b = _neigh_weights(lp)
        started = L.start(L.gather(h, shards["send_idx"],
                                   shards["send_mask"]))
        agg_i = agg_interior(h, shards)
        self_t = L.lift(lp, h)[..., :own_cap, :] @ w_self
        h = L.land(h, L.finish(started), shards["recv_pos"])
        agg_b = agg_boundary(h, shards)
        agg = torch.where(L.interior(shards["n_int"], own_cap, h.device),
                          agg_i, agg_b)
        out = self_t + L.lift(lp, agg) @ w_neigh + b
        return L.drop(lp, torch.relu(out) if activate else out)

    def fwd(params, shards: dict) -> torch.Tensor:
        h = shards["features"]
        last = len(params.layers) - 1
        for i, lp in enumerate(params.layers):
            out = split_layer(h, shards, lp, i < last)
            h = F.pad(out, (0, 0, 0, max_nodes - own_cap))
        return h

    return fwd


def make_export_forward(model, pg_meta: dict, agg=None, layout=STACKED):
    """Synchronous forward that ALSO materializes the serving handoff.

    Returns ``fwd(params, shards) -> {"layers", "logits", "cache"}``:
    ``layers[i]`` is layer i's POST-exchange input embedding ``(P, maxN,
    D_i)`` (owned rows + freshly landed halo rows), ``logits`` is
    :func:`make_distributed_forward`'s output (same spelling), and
    ``cache["h{i}"]`` is the recv-layout halo buffer ``(P, P, maxS, D_i)``.
    """
    mean_agg = agg if agg is not None else make_ref_mean_agg(
        pg_meta["max_nodes"])

    L = layout

    def fwd(params, shards: dict) -> dict:
        h = shards["features"]
        last = len(params.layers) - 1
        layers, cache = [], {}
        for i, lp in enumerate(params.layers):
            recv = L.exchange(L.gather(h, shards["send_idx"],
                                       shards["send_mask"])).contiguous()
            h = L.land(h, recv, shards["recv_pos"])
            cache[f"h{i}"] = recv
            layers.append(h)
            h = L.layer(model, lp, h, mean_agg(h, shards), i < last)
        return {"layers": tuple(layers), "logits": h, "cache": cache}

    return fwd


# ---------------------------------------------------------------------------
# per-shard forwards (the partition mesh)
# ---------------------------------------------------------------------------

def make_shard_forward(model, pg_meta: dict, mesh, agg=None,
                       ring_chunks: int = 0, export: bool = False,
                       compress: str = "none",
                       refresh: tuple[int, int] | None = None,
                       overlap: bool = False, split_agg=None):
    """ONE partition's n-layer forward on the partition mesh, what the
    reference's forwards are under ``shard_map``: the stacked builders'
    bodies over one partition's layout, whose exchange crosses the ranks
    (:func:`mesh_exchange`, ``ring_chunks`` picking the schedule).
    ``shard`` holds the rank's own arrays (no partition axis) and
    ``params`` is a shared-form ``GraphSAGE``, or one partition's row of
    per-partition params with its partition axis of 1
    (``graph.sage.partition_slice``), whose products run batched as the
    stacked forward's do.  Differentiable through the exchange, so every
    rank must run the backward together.  ``agg(h, shard) -> (maxN, D)``
    defaults to :func:`make_ref_shard_mean_agg`; the engine passes
    :func:`make_kernel_mean_agg` over the partition's own blocks.

      default     :func:`make_distributed_forward`: ``fwd(params, shard)
                  -> (maxN, C)``; with ``compress`` ``"fp16"`` / ``"int8"``
                  the error-compensated one, ``fwd(params, shard,
                  residual) -> (logits, new_residual)``, the payload and
                  the int8 scales each a collective
      ``refresh`` ``(lo, hi)``: :func:`make_cached_forward` over the rank's
                  ``(P, maxS, D_i)`` cache (and residual); ``(0, 0)`` runs
                  no collective
      ``overlap`` :func:`make_overlap_forward` over ``split_agg`` (default
                  :func:`make_ref_shard_split_agg`): the exchange started
                  before the interior half and waited on before landing
      ``export``  :func:`make_export_forward`'s handoff for this
                  partition: ``{"layers": (maxN, D_i) per layer, "logits",
                  "cache": {"h{i}": (P, maxS, D_i)}}``
    """
    layout = _Shard(mesh, ring_chunks)
    if overlap:
        aggs = (split_agg if split_agg is not None
                else make_ref_shard_split_agg(pg_meta["own_cap"]))
        return make_overlap_forward(model, pg_meta, *aggs, layout=layout)
    mean_agg = agg if agg is not None else make_ref_shard_mean_agg(
        pg_meta["max_nodes"])
    if export:
        return make_export_forward(model, pg_meta, agg=mean_agg,
                                   layout=layout)
    if refresh is not None:
        return make_cached_forward(model, pg_meta, agg=mean_agg,
                                   refresh_lo=refresh[0],
                                   refresh_hi=refresh[1], compress=compress,
                                   layout=layout)
    return make_distributed_forward(model, pg_meta, agg=mean_agg,
                                    compress=compress, layout=layout)


class RecomputePlanner:
    """Dirty-set propagation over the partitioned CSR shards (serving).

    Built once from a :class:`PartitionedGraph`; answers "after these rows'
    layer-(l-1) embeddings changed, which OWNED rows must recompute layer
    l?" per partition, including the replica mirroring between layers that
    keeps halo copies consistent with their owners.

    The rule per layer (DESIGN.md §9): a row recomputes iff its own input
    changed (self term) or a local in-neighbour's input changed (edges are
    stored dst-major per partition; the planner holds the src-major CSC
    mirror of the same local edge lists).  Rows whose IN-EDGES changed are
    seeded at layer 1 and carried forward by the self term.  Edge removals
    are only RECORDED at first: stale out-edges can only over-propagate
    (recompute a clean row to the same value), never under-propagate, so
    correctness needs no eager CSC deletion.  Once a partition accumulates
    ``compact_after`` recorded removals the planner compacts — rebuilds
    that shard's CSC from (static minus removed) plus the dynamically
    added edges — so long-running serving with heavy churn stops paying
    for dirty cones through edges that no longer exist.  :meth:`compact`
    forces the rebuild on demand.

    The replica map comes from the send/recv lists: owner p's local row
    ``send_idx[p, q, s]`` has a halo copy at q's ``recv_pos[q, p, s]``.
    Serving-time halo growth registers new replicas / out-edges through
    :meth:`add_replica` / :meth:`add_out_edge`.
    """

    def __init__(self, pg: PartitionedGraph, *, compact_after: int = 64):
        P = pg.num_parts
        self.num_parts = P
        self.compact_after = int(compact_after)
        self.compactions = 0
        self.n_own = np.asarray(pg.n_own).copy()
        self._csc = []
        for p in range(P):
            real = np.asarray(pg.edge_mask[p]) > 0
            src = np.asarray(pg.edge_src[p])[real].astype(np.int64)
            dst = np.asarray(pg.edge_dst[p])[real].astype(np.int64)
            order = np.argsort(src, kind="stable")
            n_rows = int(pg.max_nodes)
            counts = np.bincount(src, minlength=n_rows)
            ptr = np.zeros(n_rows + 1, np.int64)
            np.cumsum(counts, out=ptr[1:])
            self._csc.append((ptr, dst[order]))
        # dynamically added out-edges (src_local -> [dst_local]) per part
        self._extra_out: list[dict[int, list[int]]] = [{} for _ in range(P)]
        # removals recorded against the static CSC, pending compaction
        self._removed: list[set[tuple[int, int]]] = [set() for _ in range(P)]
        # replica lists: owner p's local row -> [(peer q, q's halo row)]
        self._rep: list[dict[int, list[tuple[int, int]]]] = [{} for _ in range(P)]
        send_idx = np.asarray(pg.send_idx)
        send_mask = np.asarray(pg.send_mask)
        recv_pos = np.asarray(pg.recv_pos)
        for p in range(P):
            for q in range(P):
                m = send_mask[p, q] > 0
                for s_loc, r_loc in zip(send_idx[p, q][m], recv_pos[q, p][m]):
                    self._rep[p].setdefault(int(s_loc), []).append((q, int(r_loc)))

    # ------------------------------------------------------------- mutation
    def add_out_edge(self, p: int, src_local: int, dst_local: int) -> None:
        self._extra_out[p].setdefault(int(src_local), []).append(int(dst_local))

    def add_replica(self, owner: int, row: int, peer: int, peer_row: int) -> None:
        self._rep[owner].setdefault(int(row), []).append((peer, int(peer_row)))

    def remove_out_edge(self, p: int, src_local: int, dst_local: int) -> None:
        """Record the removal of local edge src -> dst on partition p.

        A dynamically added edge is deleted in place; a static-CSC edge is
        only logged (stale until the next compaction, which is safe — it
        over-propagates).  Hitting ``compact_after`` pending removals
        triggers an automatic compaction of that partition's shard.
        """
        src_local, dst_local = int(src_local), int(dst_local)
        extra = self._extra_out[p].get(src_local)
        if extra is not None and dst_local in extra:
            extra.remove(dst_local)
            if not extra:
                del self._extra_out[p][src_local]
            return
        self._removed[p].add((src_local, dst_local))
        if len(self._removed[p]) >= self.compact_after:
            self._compact(p)

    def compact(self, p: int | None = None) -> None:
        """Force-rebuild the CSC shard(s) so every recorded removal and
        dynamic addition is folded into the static adjacency."""
        for q in ([p] if p is not None else range(self.num_parts)):
            if self._removed[q] or self._extra_out[q]:
                self._compact(int(q))

    def _compact(self, p: int) -> None:
        ptr, dst = self._csc[p]
        n_static = len(ptr) - 1
        src = np.repeat(np.arange(n_static, dtype=np.int64), np.diff(ptr))
        removed = self._removed[p]
        if removed:
            keep = np.fromiter(((int(s), int(d)) not in removed
                                for s, d in zip(src, dst)), bool, src.size)
            src, dst = src[keep], dst[keep]
        ex_src: list[int] = []
        ex_dst: list[int] = []
        for s, lst in self._extra_out[p].items():
            ex_src.extend([int(s)] * len(lst))
            ex_dst.extend(int(d) for d in lst)
        if ex_src:
            src = np.concatenate([src, np.asarray(ex_src, np.int64)])
            dst = np.concatenate([dst, np.asarray(ex_dst, np.int64)])
        n_rows = max(n_static, int(src.max()) + 1 if src.size else 0)
        counts = np.bincount(src, minlength=n_rows)
        new_ptr = np.zeros(n_rows + 1, np.int64)
        np.cumsum(counts, out=new_ptr[1:])
        order = np.argsort(src, kind="stable")
        self._csc[p] = (new_ptr, dst[order])
        self._extra_out[p] = {}
        self._removed[p].clear()
        self.compactions += 1

    # -------------------------------------------------------------- queries
    def replicas(self, p: int, rows: np.ndarray):
        """(peer, peer_row, owner_row) triples for every replica of ``rows``."""
        rep = self._rep[p]
        for r in np.asarray(rows):
            for q, qrow in rep.get(int(r), ()):
                yield q, qrow, int(r)

    def out_rows(self, p: int, rows: np.ndarray) -> np.ndarray:
        """Local out-neighbours (always owned rows: edges target dst-owned)."""
        ptr, dst = self._csc[p]
        extra = self._extra_out[p]
        segs = []
        n_static = len(ptr) - 1
        for r in np.asarray(rows):
            r = int(r)
            if r < n_static:
                segs.append(dst[ptr[r]:ptr[r + 1]])
            if r in extra:
                segs.append(np.asarray(extra[r], np.int64))
        if not segs:
            return np.empty(0, np.int64)
        return np.unique(np.concatenate(segs))

    def propagate(self, dirty_h0: dict[int, np.ndarray],
                  edge_seeds: dict[int, np.ndarray],
                  num_layers: int) -> list[dict[int, np.ndarray]]:
        """``plans[l-1][p]`` = sorted owned rows partition p recomputes at
        layer l (1-based), given local rows (owned or halo) whose input
        features changed and owned rows whose in-edge lists changed."""
        P = self.num_parts
        empty = np.empty(0, np.int64)
        cur = {p: np.unique(np.asarray(dirty_h0.get(p, empty), np.int64))
               for p in range(P)}
        plans: list[dict[int, np.ndarray]] = []
        for l in range(1, num_layers + 1):
            rec = {}
            for p in range(P):
                parts = [self.out_rows(p, cur[p]),
                         cur[p][cur[p] < self.n_own[p]]]
                if l == 1:
                    parts.append(np.asarray(
                        sorted(edge_seeds.get(p, ())), np.int64))
                rec[p] = np.unique(np.concatenate(parts)) if parts else empty
            plans.append(rec)
            if l < num_layers:
                nxt = {p: [rec[p]] for p in range(P)}
                for p in range(P):
                    for q, qrow, _ in self.replicas(p, rec[p]):
                        nxt[q].append(np.asarray([qrow], np.int64))
                cur = {p: np.unique(np.concatenate(nxt[p])) for p in range(P)}
        return plans
