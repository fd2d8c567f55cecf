"""CSR graph container used across the GNN substrate (DGL-format analogue).

Row ``v`` of the CSR stores the *in*-neighbourhood N(v) — the message
sources for Eq. 1 — matching DGL's convention for message passing.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp

__all__ = ["CSRGraph"]


@dataclass
class CSRGraph:
    indptr: np.ndarray           # (n+1,)
    indices: np.ndarray          # (nnz,) in-neighbour ids
    features: np.ndarray         # (n, d) float32
    labels: np.ndarray           # (n,) int64, -1 = unlabelled
    train_idx: np.ndarray
    val_idx: np.ndarray
    test_idx: np.ndarray
    num_classes: int
    name: str = "graph"

    @property
    def num_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_edges(self) -> int:
        return len(self.indices)

    @property
    def feature_dim(self) -> int:
        return self.features.shape[1]

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def adjacency(self) -> sp.csr_matrix:
        n = self.num_nodes
        return sp.csr_matrix(
            (np.ones(self.num_edges, dtype=np.float64), self.indices, self.indptr),
            shape=(n, n),
        )

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v] : self.indptr[v + 1]]

    def induced_subgraph(self, nodes: np.ndarray) -> tuple["CSRGraph", np.ndarray]:
        """Subgraph on ``nodes`` (global ids).  Returns (subgraph, nodes) with
        edges relabelled to local ids; split sets intersected and relabelled."""
        nodes = np.asarray(nodes)
        n = self.num_nodes
        g2l = np.full(n, -1, dtype=np.int64)
        g2l[nodes] = np.arange(len(nodes))
        new_indptr = [0]
        new_indices = []
        for v in nodes:
            nbrs = g2l[self.neighbors(v)]
            nbrs = nbrs[nbrs >= 0]
            new_indices.append(nbrs)
            new_indptr.append(new_indptr[-1] + len(nbrs))
        indices = (
            np.concatenate(new_indices) if new_indices else np.zeros(0, dtype=np.int64)
        )

        def remap(idx: np.ndarray) -> np.ndarray:
            m = g2l[idx]
            return m[m >= 0]

        return (
            CSRGraph(
                indptr=np.asarray(new_indptr, dtype=np.int64),
                indices=indices.astype(np.int64),
                features=self.features[nodes],
                labels=self.labels[nodes],
                train_idx=remap(self.train_idx),
                val_idx=remap(self.val_idx),
                test_idx=remap(self.test_idx),
                num_classes=self.num_classes,
                name=f"{self.name}-sub",
            ),
            nodes,
        )

    def summary(self) -> str:
        return (
            f"{self.name}: |V|={self.num_nodes} |E|={self.num_edges} "
            f"d={self.feature_dim} classes={self.num_classes} "
            f"train/val/test={len(self.train_idx)}/{len(self.val_idx)}/{len(self.test_idx)}"
        )
