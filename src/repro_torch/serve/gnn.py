"""Partitioned online GNN inference service (counterpart of
``repro/serve/gnn.py``).

  · **Embedding store.**  One tensor per (layer, partition), on the
    engine's device: ``h[l][p]`` holds layer l's POST-exchange input
    embedding for every local row (owned + halo), ``h[L][p]`` the final
    logits for owned rows.  Initialised from
    :meth:`SPMDEngine.export_serving_state`: owned rows from the exported
    layer embeddings, halo rows landed from the exported recv-layout cache
    buffers through ``pg.recv_pos``.  (The reference keeps host numpy
    stores and ships one to the device on every recompute; here they stay
    on the device and only indices and updated rows cross.)

  · **Dirty-set incremental recompute.**  Feature and edge updates mark
    rows dirty; :class:`~repro_torch.graph.distributed.RecomputePlanner`
    propagates the dirty set one hop per layer (self term ∪ local
    out-neighbours, halo replicas mirrored between layers), and
    :meth:`flush` recomputes ONLY those rows — a sub-edge-list aggregation
    through ``segment_mean_op`` (the CUDA kernel on the card) or the plain
    ``index_add_`` spelling, plus a row-gathered dense transform.  Every
    batch is padded to a power-of-two bucket of at least two rows with the
    trash row, as the reference does, so both packages recompute the same
    row sets; sub-edge sums keep each row's edges in ascending global id,
    the order the full aggregation uses.  Whether the incremental result is
    bitwise the from-scratch forward depends on the matmul backend keeping
    a row subset of a product bitwise equal to the same rows of the full
    product (the reference's XLA CPU does for >= 2 rows); the tests state
    what holds where.

  · **Query batching tick.**  Queries accumulate in :meth:`submit`; each
    :meth:`tick` flushes pending recomputes once, answers repeat queries
    from an LRU hot-row cache (a flush invalidates exactly the recomputed
    final-layer rows), then serves the remaining ids with ONE gather per
    owning partition.  Answers are numpy rows.

  · **Health machine.**  A failed partition's store stays frozen at its
    last flush; updates whose propagation cone touches it queue FIFO and
    replay on recovery with bounded exponential backoff; its queries are
    answered from the frozen store with a staleness tag.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..graph.csr import CSRGraph
from ..graph.distributed import PartitionedGraph, RecomputePlanner
from ..graph.sage import GraphSAGE

__all__ = ["GNNServingEngine", "apply_updates_to_graph"]


def _bucket(n: int, lo: int = 2) -> int:
    """Next power of two >= max(n, lo) — the reference's shape bucket."""
    m = max(lo, int(n))
    return 1 << (m - 1).bit_length()


def _dense_recompute(model, h_prev, lp, rows, src, dst, deg,
                     activate: bool):
    """Recompute ``rows``' next-layer embedding from the level-(l-1) store
    with the plain aggregation: segment sum over the (rebased) sub-edge
    list, divide by the clamped degree, then ``h @ w_self + agg @ w_neigh
    + b``.  Pad rows gather the trash row; pad edges land in the
    sacrificial segment M."""
    m = rows.shape[0]
    s = torch.zeros((m + 1, h_prev.shape[-1]), dtype=h_prev.dtype,
                    device=h_prev.device)
    s.index_add_(0, dst, h_prev[src])
    agg = s[:m] / deg.clamp_min(1.0)[:, None]
    return model._layer(lp, h_prev[rows], agg, activate)


def _kernel_recompute(model, h_prev, lp, rows, blocks, activate: bool):
    """The same recompute with the aggregation through ``segment_mean_op``
    (counterpart of the reference's ``_pallas_recompute``)."""
    from ..kernels.segment_agg import segment_mean_op

    agg = segment_mean_op(h_prev, blocks,
                          num_rows=int(rows.shape[0])).to(h_prev.dtype)
    return model._layer(lp, h_prev[rows], agg, activate)


class GNNServingEngine:
    """Online inference over a trained partitioned GraphSAGE.

    ``export`` is :meth:`SPMDEngine.export_serving_state`'s dict and
    ``params`` the ``GraphSAGE`` it was exported with.  The stores and all
    numeric work (recompute, gather) live on ``device``;
    ``use_kernel_agg`` (the reference's ``use_pallas_agg``) picks the
    recompute's aggregation.
    """

    @torch.no_grad()
    def __init__(self, model, params, pg: PartitionedGraph, export: dict, *,
                 use_kernel_agg: bool = True, hot_cache_rows: int = 256,
                 planner_compact_after: int = 64, device="cuda"):
        if len(params.layers) != model.num_layers:
            raise ValueError("params depth != model.num_layers")
        self.device = resolve_device(device)
        self.model = model
        self.params = params
        self.L = model.num_layers
        self.use_kernel_agg = bool(use_kernel_agg)
        P = pg.num_parts
        self.num_parts = P
        self.n_own = np.asarray(pg.n_own).astype(np.int64)
        self.trash_row = int(pg.trash_row)

        # ---- ownership + local<->global maps -----------------------------
        gids_all = np.asarray(pg.global_ids)
        self.num_nodes = int(gids_all.max()) + 1
        self.owner_part = np.full(self.num_nodes, -1, np.int32)
        self.owner_row = np.full(self.num_nodes, -1, np.int64)
        for p in range(P):
            own = gids_all[p][: self.n_own[p]]
            self.owner_part[own] = p
            self.owner_row[own] = np.arange(self.n_own[p])
        self.l2g = [gids_all[p].copy() for p in range(P)]
        self.g2l = [{int(g): i for i, g in enumerate(self.l2g[p]) if g >= 0}
                    for p in range(P)]

        # ---- per-owned-row in-neighbour lists (ascending global id, the
        # order build_partitioned_graph emits and scipy-canonical CSR uses)
        self.nbr_loc: list[list[np.ndarray]] = []
        self.nbr_gid: list[list[np.ndarray]] = []
        for p in range(P):
            real = np.asarray(pg.edge_mask[p]) > 0
            src = np.asarray(pg.edge_src[p])[real].astype(np.int64)
            dst = np.asarray(pg.edge_dst[p])[real].astype(np.int64)
            counts = np.bincount(dst, minlength=int(self.n_own[p]))
            bounds = np.zeros(int(self.n_own[p]) + 1, np.int64)
            np.cumsum(counts[: self.n_own[p]], out=bounds[1:])
            # dst-major emitted order: row v's edges are contiguous
            self.nbr_loc.append([src[bounds[v]:bounds[v + 1]].copy()
                                 for v in range(int(self.n_own[p]))])
            self.nbr_gid.append([self.l2g[p][s] for s in self.nbr_loc[p]])

        # ---- embedding store: land halo rows from the exported recv-layout
        # cache buffers through recv_pos
        dev = self.device
        recv_pos = torch.as_tensor(np.asarray(pg.recv_pos, np.int64),
                                   device=dev)
        self.h: list[list[torch.Tensor]] = []
        for l in range(self.L):
            layer = torch.as_tensor(export["layers"][l], device=dev)
            buf = torch.as_tensor(export["cache"][f"h{l}"], device=dev)
            per_part = []
            for p in range(P):
                arr = layer[p].clone()
                arr[self.n_own[p]:] = 0          # halo re-landed, pads zeroed
                arr[recv_pos[p].reshape(-1)] = buf[p].reshape(-1, arr.shape[-1])
                per_part.append(arr)
            self.h.append(per_part)
        logits = torch.as_tensor(export["logits"], device=dev)
        self.h.append([logits[p][: self.n_own[p]].clone() for p in range(P)])
        self.dtype = self.h[0][0].dtype
        self.np_dtype = torch.empty(0, dtype=self.dtype).numpy().dtype

        self.planner = RecomputePlanner(pg,
                                        compact_after=planner_compact_after)
        self._dirty0: list[set[int]] = [set() for _ in range(P)]
        self._edge_seeds: list[set[int]] = [set() for _ in range(P)]
        self._pending: list[int] = []
        # hot-row query cache: gid -> last served logit row (numpy), LRU up
        # to hot_cache_rows entries, invalidated whenever a flush recomputes
        # that row's final-layer store
        self.hot_cache_rows = int(hot_cache_rows)
        self._hot: dict[int, np.ndarray] = {}
        self.stats = {"ticks": 0, "flushes": 0, "rows_recomputed": 0,
                      "gather_calls": 0, "queries": 0, "halo_rows_grown": 0,
                      "updates_queued": 0, "replay_attempts": 0,
                      "replayed": 0, "degraded_queries": 0,
                      "failovers": 0, "recoveries": 0,
                      "cache_hits": 0, "cache_misses": 0,
                      "planner_compactions": 0}

        # ---- per-partition health state machine --------------------------
        # healthy -> failed (fail_partition / a scheduled fault) -> healthy
        # (recover_partition).  While a partition is failed its stored
        # embeddings stay FROZEN-CONSISTENT: any update whose propagation
        # cone would touch it is queued in arrival order and applied
        # NOWHERE; queries it owns are answered from the frozen state with
        # a per-answer staleness tag.  Replay is retried with bounded
        # exponential backoff and drains FIFO on recovery.
        self.health: list[str] = ["healthy"] * P
        self._failed_since: list[int] = [0] * P
        self._tick_no = 0
        self._queue: list[tuple] = []
        self._queued_feat: set[int] = set()
        self._queued_edges: set[tuple[int, int]] = set()
        self.max_backoff = 8          # backoff cap, in ticks
        self._backoff = 1
        self._retry_next = 0
        self.fault_plan = None

    def _rows(self, rows) -> torch.Tensor:
        return torch.as_tensor(np.asarray(rows, np.int64), device=self.device)

    # ------------------------------------------------------------- updates
    def _local(self, p: int, gid: int) -> int:
        """Local row of ``gid`` on partition p, growing a halo row (seeded
        with the owner's current per-layer embeddings, registered as a
        replica so future flushes keep it in sync) if p has never seen it."""
        row = self.g2l[p].get(gid)
        if row is not None:
            return row
        q = int(self.owner_part[gid])
        qrow = int(self.owner_row[gid])
        row = self.h[0][p].shape[0]
        for l in range(self.L):
            self.h[l][p] = torch.cat(
                [self.h[l][p], self.h[l][q][qrow:qrow + 1]], dim=0)
        self.l2g[p] = np.append(self.l2g[p], gid)
        self.g2l[p][gid] = row
        self.planner.add_replica(q, qrow, p, row)
        if qrow in self._dirty0[q]:
            self._dirty0[p].add(row)
        self.stats["halo_rows_grown"] += 1
        return row

    def update_features(self, gid: int, vec: np.ndarray) -> None:
        """Overwrite one node's input features (owner + every halo copy).
        While any partition in the update's propagation cone is failed the
        update is queued whole (applied nowhere) and replays on recovery."""
        gid = int(gid)
        if self._should_queue_feat(gid):
            self._queue.append(("feat", gid,
                                np.array(vec, self.np_dtype, copy=True)))
            self._queued_feat.add(gid)
            self.stats["updates_queued"] += 1
            return
        p = int(self.owner_part[gid])
        row = int(self.owner_row[gid])
        vec_t = torch.as_tensor(np.asarray(vec, self.np_dtype),
                                device=self.device)
        self.h[0][p][row] = vec_t
        self._dirty0[p].add(row)
        for q, qrow, _ in self.planner.replicas(p, np.asarray([row])):
            self.h[0][q][qrow] = vec_t
            self._dirty0[q].add(qrow)

    def add_edge(self, u: int, v: int) -> bool:
        """Add directed edge u -> v (u becomes an in-neighbour of v).
        Returns False if it already exists.  Growing a previously unseen
        cross-partition source appends a halo row on v's partition."""
        u, v = int(u), int(v)
        if self._should_queue_edge(u, v, adding=True):
            self._queue.append(("add", u, v))
            self._queued_edges.add((u, v))
            self.stats["updates_queued"] += 1
            return True
        p = int(self.owner_part[v])
        vrow = int(self.owner_row[v])
        pos = int(np.searchsorted(self.nbr_gid[p][vrow], u))
        if (pos < len(self.nbr_gid[p][vrow])
                and self.nbr_gid[p][vrow][pos] == u):
            return False
        urow = self._local(p, u)
        self.nbr_gid[p][vrow] = np.insert(self.nbr_gid[p][vrow], pos, u)
        self.nbr_loc[p][vrow] = np.insert(self.nbr_loc[p][vrow], pos, urow)
        self.planner.add_out_edge(p, urow, vrow)
        self._edge_seeds[p].add(vrow)
        return True

    def remove_edge(self, u: int, v: int) -> bool:
        """Remove directed edge u -> v; returns False if absent.  The
        removal is recorded with the planner, which keeps the stale
        out-edge until its per-partition compaction threshold."""
        u, v = int(u), int(v)
        if self._should_queue_edge(u, v, adding=False):
            self._queue.append(("remove", u, v))
            self._queued_edges.add((u, v))
            self.stats["updates_queued"] += 1
            return True
        p = int(self.owner_part[v])
        vrow = int(self.owner_row[v])
        pos = int(np.searchsorted(self.nbr_gid[p][vrow], u))
        if (pos >= len(self.nbr_gid[p][vrow])
                or self.nbr_gid[p][vrow][pos] != u):
            return False
        urow = int(self.nbr_loc[p][vrow][pos])
        self.nbr_gid[p][vrow] = np.delete(self.nbr_gid[p][vrow], pos)
        self.nbr_loc[p][vrow] = np.delete(self.nbr_loc[p][vrow], pos)
        self.planner.remove_out_edge(p, urow, vrow)
        self._edge_seeds[p].add(vrow)
        return True

    # --------------------------------------------------------------- flush
    def _recompute_rows(self, l: int, p: int, rows: np.ndarray) -> None:
        h_prev = self.h[l - 1][p]
        lp = self.params.layers[l - 1]
        activate = l < self.L
        m = int(rows.size)
        # full-partition refresh keeps its exact shape; partial batches pad
        # to a power-of-two bucket, never below two rows
        mp = m if (m == self.n_own[p] and m >= 2) else _bucket(m)
        rp = np.full(mp, self.trash_row, np.int64)
        rp[:m] = rows
        srcs = [self.nbr_loc[p][r] for r in rows]
        counts = np.fromiter((s.size for s in srcs), np.int64, m)
        src = (np.concatenate(srcs) if m else np.empty(0, np.int64))
        dst = np.repeat(np.arange(m), counts)
        if self.use_kernel_agg:
            from ..kernels.segment_agg import blocks_to_device, build_mean_blocks
            blocks = blocks_to_device(build_mean_blocks(src, dst, num_rows=mp),
                                      self.device)
            out = _kernel_recompute(self.model, h_prev, lp, self._rows(rp),
                                    blocks, activate)
        else:
            e = int(src.size)
            ep = _bucket(e, lo=1)
            src_p = np.full(ep, self.trash_row, np.int64)
            dst_p = np.full(ep, mp, np.int64)   # sacrificial segment
            src_p[:e] = src
            dst_p[:e] = dst
            deg = np.ones(mp, np.float64)
            deg[:m] = counts
            out = _dense_recompute(
                self.model, h_prev, lp, self._rows(rp), self._rows(src_p),
                self._rows(dst_p),
                torch.as_tensor(deg, dtype=self.dtype, device=self.device),
                activate)
        self.h[l][p][self._rows(rows)] = out[:m]

    @torch.no_grad()
    def flush(self) -> dict:
        """Apply every pending update to the embedding store: propagate the
        dirty set one hop per layer, recompute exactly those owned rows,
        and mirror refreshed rows to their halo replicas between layers."""
        if (not any(self._dirty0) and not any(self._edge_seeds)):
            self.stats["planner_compactions"] = self.planner.compactions
            return {"rows_recomputed": 0, "per_layer": [0] * self.L}
        P = self.num_parts
        plans = self.planner.propagate(
            {p: np.fromiter(self._dirty0[p], np.int64, len(self._dirty0[p]))
             for p in range(P)},
            {p: np.fromiter(self._edge_seeds[p], np.int64,
                            len(self._edge_seeds[p])) for p in range(P)},
            self.L)
        per_layer, total = [], 0
        for l, rec in enumerate(plans, start=1):
            cnt = 0
            for p in range(P):
                if rec[p].size:
                    self._recompute_rows(l, p, rec[p])
                    cnt += int(rec[p].size)
            if l < self.L:
                # replica pushes, one gather/scatter per (owner, peer) pair:
                # each halo row has one owner, so the pairs never collide
                for p in range(P):
                    pairs: dict[int, tuple[list[int], list[int]]] = {}
                    for q, qrow, r in self.planner.replicas(p, rec[p]):
                        qr, rs = pairs.setdefault(q, ([], []))
                        qr.append(qrow)
                        rs.append(r)
                    for q, (qr, rs) in pairs.items():
                        self.h[l][q][self._rows(qr)] = \
                            self.h[l][p][self._rows(rs)]
            else:
                # final-layer rows changed: their hot-cache entries are stale
                if self._hot:
                    for p in range(P):
                        for r in rec[p]:
                            self._hot.pop(int(self.l2g[p][r]), None)
            per_layer.append(cnt)
            total += cnt
        self._dirty0 = [set() for _ in range(P)]
        self._edge_seeds = [set() for _ in range(P)]
        self.stats["flushes"] += 1
        self.stats["rows_recomputed"] += total
        self.stats["planner_compactions"] = self.planner.compactions
        return {"rows_recomputed": total, "per_layer": per_layer}

    def refresh_full(self) -> dict:
        """From-scratch rematerialization through the same flush machinery
        (every owned row dirty) — the baseline :meth:`flush` must beat."""
        if self._any_failed():
            raise RuntimeError(
                "refresh_full requires every partition healthy; failed: "
                f"{[p for p, h in enumerate(self.health) if h != 'healthy']}")
        for p in range(self.num_parts):
            self._dirty0[p].update(range(int(self.n_own[p])))
        return self.flush()

    # ------------------------------------- health machine / degraded mode
    def _any_failed(self) -> bool:
        return any(h != "healthy" for h in self.health)

    def set_fault_plan(self, plan) -> None:
        """Attach a fault plan: a ``robustness.FaultPlan``, or any object
        whose ``serve_events(tick)`` yields ``("fail" | "recover",
        partition)`` pairs, applied at the start of each :meth:`tick`."""
        self.fault_plan = plan

    def fail_partition(self, p: int) -> None:
        """Mark partition ``p`` failed at the current tick boundary.

        Pending dirty work is flushed FIRST (the failure lands on a flush
        boundary), so the failed store freezes in a fully consistent
        state; from here on any update whose cone touches ``p`` queues."""
        p = int(p)
        if self.health[p] != "healthy":
            return
        self.flush()
        self.health[p] = "failed"
        self._failed_since[p] = self._tick_no
        self.stats["failovers"] += 1

    def recover_partition(self, p: int) -> None:
        """Mark partition ``p`` healthy again; the queued updates replay
        (FIFO, all-or-nothing) at the next :meth:`tick`'s drain."""
        p = int(p)
        if self.health[p] != "failed":
            return
        self.health[p] = "healthy"
        self._backoff = 1
        self._retry_next = self._tick_no
        self.stats["recoveries"] += 1

    def _probe_touches_failed(self, seeds_h0: dict, seeds_edge: dict) -> bool:
        """Would an update with these dirty seeds propagate into a failed
        partition?  Runs the planner's cone (the exact sets flush would
        recompute + the replica pushes between layers) over the probe."""
        failed = {p for p, h in enumerate(self.health) if h != "healthy"}
        if not failed:
            return False
        P = self.num_parts
        for p in failed:
            if seeds_h0.get(p) or seeds_edge.get(p):
                return True
        plans = self.planner.propagate(
            {p: np.fromiter(sorted(seeds_h0.get(p, ())), np.int64,
                            len(seeds_h0.get(p, ()))) for p in range(P)},
            {p: np.fromiter(sorted(seeds_edge.get(p, ())), np.int64,
                            len(seeds_edge.get(p, ()))) for p in range(P)},
            self.L)
        for l, rec in enumerate(plans, start=1):
            for p in range(P):
                if p in failed and rec[p].size:
                    return True
                if l < self.L and rec[p].size:
                    for q, _qrow, _r in self.planner.replicas(p, rec[p]):
                        if q in failed:
                            return True
        return False

    def _should_queue_feat(self, gid: int) -> bool:
        if not self._queue and not self._any_failed():
            return False
        if gid in self._queued_feat:
            return True            # FIFO order behind the queued write
        if not self._any_failed():
            return False
        p = int(self.owner_part[gid])
        row = int(self.owner_row[gid])
        if self.health[p] != "healthy":
            return True
        seeds = {p: {row}}
        for q, qrow, _ in self.planner.replicas(p, np.asarray([row])):
            if self.health[q] != "healthy":
                return True        # h0 mirror would write into q
            seeds.setdefault(q, set()).add(qrow)
        return self._probe_touches_failed(seeds, {})

    def _should_queue_edge(self, u: int, v: int, *, adding: bool) -> bool:
        if not self._queue and not self._any_failed():
            return False
        if (u, v) in self._queued_edges:
            return True            # FIFO order behind the queued edge op
        if not self._any_failed():
            return False
        p = int(self.owner_part[v])
        if self.health[p] != "healthy":
            return True
        if adding and self.health[int(self.owner_part[u])] != "healthy":
            return True            # halo grow would subscribe to a dead host
        return self._probe_touches_failed({}, {p: {int(self.owner_row[v])}})

    def _drain_queue(self) -> None:
        """Replay the queued updates FIFO once every partition is healthy;
        while one is still failed, retry with bounded exponential backoff
        (1, 2, 4, ... capped at ``max_backoff`` ticks)."""
        if not self._queue:
            self._backoff = 1
            self._retry_next = 0
            return
        if self._tick_no < self._retry_next:
            return
        self.stats["replay_attempts"] += 1
        if self._any_failed():
            self._backoff = min(self._backoff * 2, self.max_backoff)
            self._retry_next = self._tick_no + self._backoff
            return
        ops, self._queue = self._queue, []
        self._queued_feat.clear()
        self._queued_edges.clear()
        for op in ops:
            if op[0] == "feat":
                self.update_features(op[1], op[2])
            elif op[0] == "add":
                self.add_edge(op[1], op[2])
            else:
                self.remove_edge(op[1], op[2])
        self.stats["replayed"] += len(ops)
        self._backoff = 1
        self._retry_next = 0

    # ------------------------------------------------------------- queries
    def submit(self, gids) -> None:
        self._pending.extend(int(g) for g in np.atleast_1d(np.asarray(gids)))

    @torch.no_grad()
    def tick(self) -> tuple[dict, dict]:
        """One serving tick: apply scheduled fault events, attempt a queue
        drain, flush pending updates, then answer every queued query with
        one gather per owning partition.  Queries owned by a failed
        partition are answered from its frozen (last-flushed) logits and
        tagged in ``flush_stats['staleness']`` with the number of ticks
        since that partition failed."""
        self._tick_no += 1
        if self.fault_plan is not None:
            for kind, p in self.fault_plan.serve_events(self._tick_no):
                if kind == "fail":
                    self.fail_partition(p)
                else:
                    self.recover_partition(p)
        self._drain_queue()
        flush_stats = self.flush()
        results: dict[int, np.ndarray] = {}
        staleness: dict[int, int] = {}
        by_part: dict[int, list[int]] = {}
        for gid in self._pending:
            p = int(self.owner_part[gid])
            hot = self._hot.get(gid) if self.health[p] == "healthy" else None
            if hot is not None:
                self._hot[gid] = self._hot.pop(gid)    # LRU touch
                results[gid] = hot
                self.stats["cache_hits"] += 1
                continue
            by_part.setdefault(p, []).append(gid)
        for p, gids in by_part.items():
            rows = self.owner_row[np.asarray(gids, np.int64)]
            out = self.h[self.L][p][self._rows(rows)].cpu().numpy()
            self.stats["gather_calls"] += 1
            self.stats["cache_misses"] += len(gids)
            degraded = self.health[p] != "healthy"
            age = self._tick_no - self._failed_since[p] if degraded else 0
            for g, logit_row in zip(gids, out):
                results[g] = logit_row
                if degraded:
                    staleness[g] = age
                elif self.hot_cache_rows > 0:
                    self._hot.pop(g, None)
                    self._hot[g] = logit_row
            if degraded:
                self.stats["degraded_queries"] += len(gids)
            while len(self._hot) > self.hot_cache_rows:
                self._hot.pop(next(iter(self._hot)))
        self.stats["queries"] += len(self._pending)
        self.stats["ticks"] += 1
        self._pending.clear()
        flush_stats["staleness"] = staleness
        flush_stats["queued_updates"] = len(self._queue)
        flush_stats["health"] = list(self.health)
        return results, flush_stats

    def query(self, gids) -> np.ndarray:
        """Submit + tick: logits (k, C) aligned with ``gids``."""
        gids = np.atleast_1d(np.asarray(gids, np.int64))
        self.submit(gids)
        results, _ = self.tick()
        return np.stack([results[int(g)] for g in gids])

    def predict(self, gids) -> np.ndarray:
        return np.argmax(self.query(gids), axis=-1)

    def export_logits(self) -> np.ndarray:
        """(num_nodes, C) logits in global id order (flush first)."""
        self.flush()
        c = self.h[self.L][0].shape[-1]
        out = np.zeros((self.num_nodes, c), self.np_dtype)
        for p in range(self.num_parts):
            own = self.l2g[p][: self.n_own[p]]
            out[own] = self.h[self.L][p].cpu().numpy()
        return out

    # --------------------------------------------------------- constructors
    @classmethod
    def from_engine(cls, engine, pg: PartitionedGraph, params, **kw):
        kw.setdefault("device", engine.device)
        return cls(engine.model, params, pg,
                   engine.export_serving_state(params), **kw)

    @classmethod
    def from_checkpoint(cls, path: str, engine, pg: PartitionedGraph, **kw):
        """Serve a checkpoint saved with ``train.checkpoint.save_pytree``
        (by either package): its params restore on the engine's device in
        the engine's dtype."""
        from ..train.checkpoint import load_pytree

        m = engine.model
        like = GraphSAGE(m.feature_dim, m.hidden_dim, m.num_classes,
                         m.num_layers).init(0).to(engine.device,
                                                   engine.config.dtype)
        return cls.from_engine(engine, pg, load_pytree(path, like), **kw)


def apply_updates_to_graph(graph: CSRGraph, feature_updates: dict | None = None,
                           add_edges=(), remove_edges=()) -> CSRGraph:
    """Oracle-side mirror of the serving update API: rebuild a CSRGraph
    with the given updates applied.  Per-row in-neighbour lists stay
    sorted by global id — the canonical order both build paths aggregate
    in — so a from-scratch forward over the result is the serving
    engine's reference."""
    rows = {}

    def row(v: int) -> list[int]:
        if v not in rows:
            rows[v] = list(graph.neighbors(v))
        return rows[v]

    for u, v in add_edges:
        r = row(int(v))
        pos = int(np.searchsorted(r, int(u)))
        if pos >= len(r) or r[pos] != int(u):
            r.insert(pos, int(u))
    for u, v in remove_edges:
        r = row(int(v))
        pos = int(np.searchsorted(r, int(u)))
        if pos < len(r) and r[pos] == int(u):
            r.pop(pos)

    n = graph.num_nodes
    counts = np.diff(graph.indptr).copy()
    for v, r in rows.items():
        counts[v] = len(r)
    indptr = np.zeros(n + 1, graph.indptr.dtype)
    np.cumsum(counts, out=indptr[1:])
    indices = np.empty(int(indptr[-1]), graph.indices.dtype)
    for v in range(n):
        seg = (rows[v] if v in rows
               else graph.indices[graph.indptr[v]:graph.indptr[v + 1]])
        indices[indptr[v]:indptr[v + 1]] = seg

    features = np.array(graph.features, copy=True)
    for gid, vec in (feature_updates or {}).items():
        features[int(gid)] = np.asarray(vec, features.dtype)
    return CSRGraph(indptr=indptr, indices=indices, features=features,
                    labels=graph.labels, train_idx=graph.train_idx,
                    val_idx=graph.val_idx, test_idx=graph.test_idx,
                    num_classes=graph.num_classes, name=graph.name)
