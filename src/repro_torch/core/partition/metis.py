"""Multilevel k-way weighted graph partitioner (METIS-style, from scratch).

PyMETIS is not installable offline, so we implement the same multilevel
recipe the paper relies on [Karypis & Kumar, SIAM JSC 1998]:

  1. COARSEN   — repeated heavy-edge matching (HEM): collapse the heaviest
                 incident edge of each unmatched vertex; edge weights add up,
                 vertex weights add up.  Stops when the graph is small or
                 matching stalls.
  2. INITIAL   — greedy weighted region-growing from k spread-out seeds on
                 the coarsest graph (capacity-bounded), followed by
                 refinement there.
  3. UNCOARSEN — project the partition back level by level; after each
                 projection run balanced label-propagation refinement
                 (a vectorised Fiduccia–Mattheyses relative: move vertices to
                 the partition they are most heavily connected to, best gains
                 first, under a vertex-weight balance cap).

Minimising *weighted* edge-cut over Algorithm-1 weights is exactly the EW
objective; with unit weights this is the paper's "METIS" baseline.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["metis_kway"]


# --------------------------------------------------------------------------
# graph helpers
# --------------------------------------------------------------------------

def _symmetrize(adj: sp.csr_matrix) -> sp.csr_matrix:
    """Undirected weighted view: W + W^T, zero diagonal."""
    a = (adj + adj.T).tocsr()
    a.setdiag(0)
    a.eliminate_zeros()
    return a


def _heavy_edge_matching(adj: sp.csr_matrix, rng: np.random.Generator) -> np.ndarray:
    """Return match[i] = partner (or i itself).  Visit order random-ish by
    ascending degree (METIS visits low-degree first to protect their edges)."""
    n = adj.shape[0]
    indptr, indices, data = adj.indptr, adj.indices, adj.data
    deg = np.diff(indptr)
    order = np.argsort(deg + rng.random(n), kind="stable")
    match = np.full(n, -1, dtype=np.int64)
    for v in order:
        if match[v] != -1:
            continue
        lo, hi = indptr[v], indptr[v + 1]
        best, best_w = -1, -1.0
        for j in range(lo, hi):
            u = indices[j]
            if u != v and match[u] == -1 and data[j] > best_w:
                best, best_w = u, data[j]
        if best == -1:
            match[v] = v
        else:
            match[v] = best
            match[best] = v
    return match


def _coarsen(
    adj: sp.csr_matrix, vwgt: np.ndarray, rng: np.random.Generator
) -> tuple[sp.csr_matrix, np.ndarray, np.ndarray]:
    """One HEM coarsening step.  Returns (coarse_adj, coarse_vwgt, cmap)."""
    n = adj.shape[0]
    match = _heavy_edge_matching(adj, rng)
    # assign coarse ids: pair (v, match[v]) shares an id
    cmap = np.full(n, -1, dtype=np.int64)
    nxt = 0
    for v in range(n):
        if cmap[v] == -1:
            u = match[v]
            cmap[v] = nxt
            cmap[u] = nxt
            nxt += 1
    nc = nxt
    proj = sp.csr_matrix(
        (np.ones(n), (np.arange(n), cmap)), shape=(n, nc)
    )
    cadj = (proj.T @ adj @ proj).tocsr()
    cadj.setdiag(0)
    cadj.eliminate_zeros()
    cvwgt = np.zeros(nc, dtype=np.float64)
    np.add.at(cvwgt, cmap, vwgt)
    return cadj, cvwgt, cmap


# --------------------------------------------------------------------------
# initial partition on the coarsest graph
# --------------------------------------------------------------------------

def _spread_seeds(adj: sp.csr_matrix, k: int, rng: np.random.Generator) -> np.ndarray:
    """k seeds, BFS-far apart (first = max weighted degree, rest maximin)."""
    n = adj.shape[0]
    wdeg = np.asarray(adj.sum(axis=1)).ravel()
    seeds = [int(np.argmax(wdeg))]
    dist = _bfs_dist(adj, seeds[0])
    for _ in range(1, k):
        cand = int(np.argmax(np.where(np.isfinite(dist), dist, -1) + rng.random(n) * 0.5))
        seeds.append(cand)
        dist = np.minimum(dist, _bfs_dist(adj, cand))
    return np.array(seeds)


def _bfs_dist(adj: sp.csr_matrix, src: int) -> np.ndarray:
    n = adj.shape[0]
    dist = np.full(n, np.inf)
    dist[src] = 0
    frontier = np.array([src])
    d = 0
    indptr, indices = adj.indptr, adj.indices
    visited = np.zeros(n, dtype=bool)
    visited[src] = True
    while frontier.size:
        d += 1
        nxt = []
        for v in frontier:
            nbrs = indices[indptr[v] : indptr[v + 1]]
            new = nbrs[~visited[nbrs]]
            visited[new] = True
            dist[new] = d
            nxt.append(new)
        frontier = np.concatenate(nxt) if nxt else np.array([], dtype=np.int64)
    return dist


def _grow_initial(
    adj: sp.csr_matrix, vwgt: np.ndarray, k: int, cap: float, rng: np.random.Generator
) -> np.ndarray:
    """Greedy capacity-bounded region growing from spread seeds."""
    n = adj.shape[0]
    parts = np.full(n, -1, dtype=np.int64)
    load = np.zeros(k)
    seeds = _spread_seeds(adj, k, rng)
    for p, s in enumerate(seeds):
        if parts[s] == -1:
            parts[s] = p
            load[p] += vwgt[s]
    indptr, indices, data = adj.indptr, adj.indices, adj.data
    # frontier-driven growth: repeatedly attach the strongest-connected
    # unassigned vertex to the least-loaded eligible partition.
    for _ in range(n * 2):
        un = np.flatnonzero(parts == -1)
        if un.size == 0:
            break
        progressed = False
        # vectorised connection strengths of unassigned nodes to each part
        onehot = sp.csr_matrix(
            (np.ones(np.count_nonzero(parts >= 0)),
             (np.flatnonzero(parts >= 0), parts[parts >= 0])),
            shape=(n, k),
        )
        conn = adj[un] @ onehot  # (|un|, k)
        conn = np.asarray(conn.todense())
        order = np.argsort(-conn.max(axis=1))
        for idx in order:
            v = un[idx]
            prefs = np.argsort(-conn[idx])
            for p in prefs:
                if conn[idx, p] <= 0 and load.min() < cap:
                    p = int(np.argmin(load))  # isolated node: least loaded
                if load[p] + vwgt[v] <= cap or load[p] == load.min():
                    parts[v] = p
                    load[p] += vwgt[v]
                    progressed = True
                    break
        if not progressed:
            # stick leftovers on least-loaded parts
            for v in np.flatnonzero(parts == -1):
                p = int(np.argmin(load))
                parts[v] = p
                load[p] += vwgt[v]
            break
    return parts


# --------------------------------------------------------------------------
# refinement (vectorised balanced label propagation / FM-relative)
# --------------------------------------------------------------------------

def _refine(
    adj: sp.csr_matrix,
    vwgt: np.ndarray,
    parts: np.ndarray,
    k: int,
    cap: float,
    passes: int,
    moves_per_pass_frac: float = 0.15,
) -> np.ndarray:
    n = adj.shape[0]
    parts = parts.copy()
    for _ in range(passes):
        onehot = sp.csr_matrix((np.ones(n), (np.arange(n), parts)), shape=(n, k))
        conn = np.asarray((adj @ onehot).todense())  # weight to each part
        cur = conn[np.arange(n), parts]
        conn[np.arange(n), parts] = -np.inf
        best = conn.argmax(axis=1)
        gain = conn[np.arange(n), best] - cur
        cand = np.flatnonzero(gain > 0)
        if cand.size == 0:
            break
        order = cand[np.argsort(-gain[cand])]
        load = np.zeros(k)
        np.add.at(load, parts, vwgt)
        budget = max(1, int(n * moves_per_pass_frac))
        moved = 0
        for v in order:
            if moved >= budget:
                break
            p_new, p_old = int(best[v]), int(parts[v])
            if load[p_new] + vwgt[v] <= cap:
                parts[v] = p_new
                load[p_new] += vwgt[v]
                load[p_old] -= vwgt[v]
                moved += 1
        if moved == 0:
            break
    return parts


def _rebalance(parts: np.ndarray, vwgt: np.ndarray, k: int, cap: float,
               adj: sp.csr_matrix) -> np.ndarray:
    """Hard balance fix-up: spill lowest-connectivity vertices of overweight
    partitions into the lightest ones."""
    n = len(parts)
    parts = parts.copy()
    load = np.zeros(k)
    np.add.at(load, parts, vwgt)
    onehot = sp.csr_matrix((np.ones(n), (np.arange(n), parts)), shape=(n, k))
    conn = np.asarray((adj @ onehot).todense())
    for p in range(k):
        while load[p] > cap:
            members = np.flatnonzero(parts == p)
            # evict member with least internal connectivity
            v = members[np.argmin(conn[members, p])]
            q = int(np.argmin(load))
            if q == p:
                break
            parts[v] = q
            load[p] -= vwgt[v]
            load[q] += vwgt[v]
    return parts


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

def metis_kway(
    adj: sp.spmatrix,
    num_parts: int,
    *,
    vertex_weights: np.ndarray | None = None,
    imbalance: float = 0.05,
    coarsen_to: int | None = None,
    refine_passes: int = 6,
    seed: int = 0,
) -> np.ndarray:
    """Multilevel k-way partition of a (weighted) graph.

    ``adj`` — (n, n) sparse adjacency; weights are the Algorithm-1 edge
    weights for EW or ones for the unweighted METIS baseline.  Returns an
    int64 array of partition ids with vertex-weight balance
    ``max(load) <= (1+imbalance) * mean(load)`` (best effort, guaranteed by a
    final rebalance pass).
    """
    rng = np.random.default_rng(seed)
    adj = _symmetrize(sp.csr_matrix(adj, dtype=np.float64))
    n = adj.shape[0]
    if num_parts <= 1:
        return np.zeros(n, dtype=np.int64)
    vwgt = (
        np.ones(n, dtype=np.float64)
        if vertex_weights is None
        else np.asarray(vertex_weights, dtype=np.float64)
    )
    if coarsen_to is None:
        coarsen_to = max(128 * num_parts, 2048)

    # ---- coarsening phase
    levels: list[tuple[sp.csr_matrix, np.ndarray, np.ndarray]] = []
    cur_adj, cur_vwgt = adj, vwgt
    while cur_adj.shape[0] > coarsen_to:
        cadj, cvwgt, cmap = _coarsen(cur_adj, cur_vwgt, rng)
        if cadj.shape[0] > 0.95 * cur_adj.shape[0]:  # matching stalled
            break
        levels.append((cur_adj, cur_vwgt, cmap))
        cur_adj, cur_vwgt = cadj, cvwgt

    # ---- initial partition at the coarsest level
    total = vwgt.sum()
    cap_final = (1.0 + imbalance) * total / num_parts
    cap_coarse = (1.0 + max(imbalance, 0.10)) * total / num_parts
    parts = _grow_initial(cur_adj, cur_vwgt, num_parts, cap_coarse, rng)
    parts = _refine(cur_adj, cur_vwgt, parts, num_parts, cap_coarse, refine_passes)

    # ---- uncoarsen + refine
    for fadj, fvwgt, cmap in reversed(levels):
        parts = parts[cmap]
        parts = _refine(fadj, fvwgt, parts, num_parts, cap_final, refine_passes)

    parts = _rebalance(parts, vwgt, num_parts, cap_final, adj)
    return parts.astype(np.int64)
