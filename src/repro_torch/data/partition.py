"""Entropy-aware corpus sharding — the paper's EW partitioning applied to a
document corpus across data-parallel shards (copied unchanged from
``repro/data/partition.py``, over the port's ``core.partition`` and
``core.entropy``).

We build a kNN document-similarity graph (cosine over doc features), weight
its edges with Algorithm 1 (fanout K = the kNN degree), and run the same
weighted multilevel partitioner used for graphs.  Result: data-parallel
shards with LOW domain entropy — which the GP personalization phase then
exploits, giving per-shard domain-specialist replicas (the paper's federated
view, DESIGN.md §Arch-applicability)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

from ..core.entropy import partition_entropies
from ..core.partition import partition_graph
from .corpus import DomainCorpus

__all__ = ["CorpusShards", "shard_corpus_by_entropy", "knn_graph"]


def knn_graph(features: np.ndarray, k: int = 10) -> sp.csr_matrix:
    """Symmetric kNN cosine-similarity graph (host-side, exact — corpora at
    this scale are small; swap in an ANN index for production)."""
    f = features / np.maximum(np.linalg.norm(features, axis=1, keepdims=True), 1e-12)
    sim = f @ f.T
    np.fill_diagonal(sim, -np.inf)
    n = len(f)
    idx = np.argpartition(-sim, kth=k, axis=1)[:, :k]
    rows = np.repeat(np.arange(n), k)
    cols = idx.reshape(-1)
    a = sp.csr_matrix((np.ones(n * k), (rows, cols)), shape=(n, n))
    a = ((a + a.T) > 0).astype(np.float64).tocsr()
    a.setdiag(0)
    a.eliminate_zeros()
    return a


@dataclass
class CorpusShards:
    num_shards: int
    assignment: np.ndarray          # (num_docs,) shard id
    shard_entropies: np.ndarray     # per-shard domain entropy
    method: str

    def docs_of(self, shard: int) -> np.ndarray:
        return np.flatnonzero(self.assignment == shard)


def shard_corpus_by_entropy(
    corpus: DomainCorpus, num_shards: int, *, method: str = "ew",
    knn: int = 10, seed: int = 0,
) -> CorpusShards:
    """method: 'ew' (entropy-aware), 'metis' (similarity graph, unweighted)
    or 'random' (the standard round-robin loader = the DistDGL analogue)."""
    if method == "random":
        rng = np.random.default_rng([seed, 0x10AD])
        assign = rng.permutation(corpus.num_docs) % num_shards
    else:
        g = knn_graph(corpus.features, k=knn)
        res = partition_graph(
            g.indptr, g.indices, corpus.features, corpus.domains, num_shards,
            method=method, fanout_k=knn, seed=seed,
        )
        assign = res.parts
    ents = partition_entropies(corpus.domains, assign, num_shards,
                               corpus.spec.num_domains)
    return CorpusShards(num_shards=num_shards, assignment=assign.astype(np.int64),
                        shard_entropies=ents, method=method)
