"""Synthetic domain-labelled token corpus for the LLM-side pipeline
(copied unchanged from ``repro/data/corpus.py``; host NumPy, and the port
imports nothing of ``repro``).

The paper's pathology — non-i.i.d. label distributions across compute hosts —
has a direct LLM analogue: *domain* skew across data-parallel shards.  We
generate documents from per-domain Markov token models (so domains are
statistically distinguishable) with a Zipf domain-size distribution (the
class imbalance of Fig. 1b) and per-document feature vectors (domain
prototype + noise — what Alg. 1's similarity taps into).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["CorpusSpec", "DomainCorpus"]


@dataclass(frozen=True)
class CorpusSpec:
    num_docs: int = 2048
    doc_len: int = 256
    vocab_size: int = 512
    num_domains: int = 8
    domain_zipf: float = 1.2
    feature_dim: int = 32
    feature_noise: float = 0.4
    seed: int = 0


class DomainCorpus:
    """tokens: (num_docs, doc_len) int32; domains: (num_docs,); features:
    (num_docs, feature_dim) for the EW doc-similarity graph."""

    def __init__(self, spec: CorpusSpec):
        self.spec = spec
        rng = np.random.default_rng([spec.seed, 0xD0C5])
        k = spec.num_domains
        ranks = np.arange(1, k + 1, dtype=np.float64)
        p = ranks ** (-spec.domain_zipf)
        self.domain_p = p / p.sum()
        self.domains = rng.choice(k, size=spec.num_docs, p=self.domain_p).astype(np.int64)

        # per-domain Markov chains over a shared vocab (peaked transitions)
        v = spec.vocab_size
        self._trans = np.empty((k, v, v), dtype=np.float32) if v <= 1024 else None
        tokens = np.empty((spec.num_docs, spec.doc_len), dtype=np.int32)
        chains = []
        for d in range(k):
            # sparse-ish row-stochastic transition with domain-specific bias
            logits = rng.normal(0, 1.0, (v, v)) + 3.0 * rng.normal(
                0, 1.0, (1, v))  # domain-wide token preference
            probs = np.exp(logits - logits.max(axis=1, keepdims=True))
            probs /= probs.sum(axis=1, keepdims=True)
            chains.append(probs)
        for i in range(spec.num_docs):
            chain = chains[self.domains[i]]
            t = rng.integers(0, v)
            for j in range(spec.doc_len):
                tokens[i, j] = t
                t = rng.choice(v, p=chain[t])
        self.tokens = tokens

        protos = rng.normal(0, 1, (k, spec.feature_dim))
        protos /= np.linalg.norm(protos, axis=1, keepdims=True)
        self.features = (protos[self.domains]
                         + rng.normal(0, spec.feature_noise,
                                      (spec.num_docs, spec.feature_dim))).astype(np.float32)

    @property
    def num_docs(self) -> int:
        return self.spec.num_docs

    def domain_entropy(self, idx: np.ndarray | None = None) -> float:
        from ..core.entropy import label_entropy
        d = self.domains if idx is None else self.domains[idx]
        return label_entropy(d, self.spec.num_domains)
