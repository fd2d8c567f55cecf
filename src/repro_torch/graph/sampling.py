"""Fixed-shape GraphSAGE neighbour sampling (paper fanout (25, 25)).

Copied unchanged from ``repro/graph/sampling.py`` (host NumPy, no
framework): the same seed gives bitwise the same blocks.

DistDGL samples neighbourhoods on CPU workers and ships blocks to trainers;
we do the same: NumPy sampling here, fixed-shape index blocks into the jitted
model.  Sampling WITH replacement gives static shapes (a TPU requirement —
the reference's choice, kept so both packages draw the same blocks):

    targets      (B,)
    nbrs1        (B, F1)          neighbours of targets
    nbrs2        (B*F1, F2)       neighbours of nbrs1

Isolated nodes self-loop, matching DGL's `add_self_loop` fallback.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .csr import CSRGraph

__all__ = ["SampledBlocks", "NeighborSampler"]


@dataclass
class SampledBlocks:
    """One minibatch of sampled computation blocks (all global node ids)."""

    targets: np.ndarray            # (B,)
    nbrs1: np.ndarray              # (B, F1)
    nbrs2: np.ndarray              # (B*F1, F2)

    def feature_views(self, features: np.ndarray):
        """Gather features: x_t (B,D), x_1 (B,F1,D), x_2 (B,F1,F2,D)."""
        b, f1 = self.nbrs1.shape
        f2 = self.nbrs2.shape[1]
        x_t = features[self.targets]
        x_1 = features[self.nbrs1.reshape(-1)].reshape(b, f1, -1)
        x_2 = features[self.nbrs2.reshape(-1)].reshape(b, f1, f2, -1)
        return x_t, x_1, x_2


class NeighborSampler:
    """Uniform-with-replacement fanout sampler over a CSR graph."""

    def __init__(self, graph: CSRGraph, fanouts: tuple[int, int] = (25, 25), seed: int = 0):
        self.graph = graph
        self.fanouts = fanouts
        self._rng = np.random.default_rng([seed, 0xAB1E])

    def _sample_neighbors(self, nodes: np.ndarray, fanout: int) -> np.ndarray:
        g = self.graph
        deg = g.indptr[nodes + 1] - g.indptr[nodes]
        out = np.empty((len(nodes), fanout), dtype=np.int64)
        r = self._rng.integers(0, 1 << 62, size=(len(nodes), fanout))
        has = deg > 0
        # vectorised modular pick into each node's CSR span
        offs = (r[has] % deg[has, None]) + g.indptr[nodes[has], None]
        out[has] = g.indices[offs]
        out[~has] = nodes[~has, None]  # isolated -> self loop
        return out

    def sample(self, targets: np.ndarray) -> SampledBlocks:
        targets = np.asarray(targets, dtype=np.int64)
        f1, f2 = self.fanouts
        nbrs1 = self._sample_neighbors(targets, f1)
        nbrs2 = self._sample_neighbors(nbrs1.reshape(-1), f2)
        return SampledBlocks(targets=targets, nbrs1=nbrs1, nbrs2=nbrs2)
