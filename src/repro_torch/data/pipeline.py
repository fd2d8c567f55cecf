"""Sharded batch pipeline with CBS over domain labels (copied unchanged
from ``repro/data/pipeline.py``, over the port's host ``CBSampler``).

Each data-parallel shard draws documents from its own corpus shard; with
``class_balanced=True`` the draw follows the paper's Eq. 3 with the kNN
degree playing the role of the adjacency column norm.  Batches stack to
(P, B_local, S); the LLM trainer (``launch/train.py llm``) runs one shard's
rows at a time.
"""
from __future__ import annotations

import numpy as np

from ..core.sampler.cbs import CBSampler
from .corpus import DomainCorpus
from .partition import CorpusShards, knn_graph

__all__ = ["ShardedBatcher"]


class ShardedBatcher:
    def __init__(self, corpus: DomainCorpus, shards: CorpusShards, *,
                 batch_per_shard: int, class_balanced: bool = True,
                 subset_fraction: float = 0.25, seed: int = 0):
        self.corpus = corpus
        self.shards = shards
        self.batch_per_shard = batch_per_shard
        g = knn_graph(corpus.features, k=10)
        self._samplers = [
            CBSampler(
                g.indptr, g.indices, corpus.domains, shards.docs_of(p),
                batch_size=batch_per_shard, subset_fraction=subset_fraction,
                class_balanced=class_balanced, seed=seed + p,
            )
            for p in range(shards.num_shards)
        ]

    def next_batch(self) -> dict[str, np.ndarray]:
        """(P, B, S) tokens/labels — next-token LM objective (labels are the
        shifted sequence; last position masked)."""
        p = self.shards.num_shards
        b, s = self.batch_per_shard, self.corpus.spec.doc_len
        tokens = np.empty((p, b, s), dtype=np.int32)
        domains = np.empty((p, b), dtype=np.int64)
        for i, sampler in enumerate(self._samplers):
            nodes = sampler.sample_mini_epoch()[:b]
            if len(nodes) < b:  # tiny shard: wrap around
                nodes = np.resize(nodes, b)
            tokens[i] = self.corpus.tokens[nodes]
            domains[i] = self.corpus.domains[nodes]
        labels = np.concatenate(
            [tokens[:, :, 1:], np.full((p, b, 1), -1, np.int32)], axis=2)
        return {"tokens": tokens, "labels": labels, "domains": domains}
