"""Label-entropy metrics for graph/corpus partitions.

The paper's central observable (Fig. 1a, Table V): the Shannon entropy of the
label distribution inside each partition.  Lower per-partition entropy means
the partition is label-homogeneous, which the paper shows correlates with a
higher local micro-F1 after personalization.

All functions are NumPy host-side utilities: partitioning is a preprocessing
step (as in the paper, where METIS runs on one host before training starts).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

__all__ = [
    "label_entropy",
    "partition_entropies",
    "PartitionStats",
    "partition_stats",
]


def label_entropy(labels: np.ndarray, num_classes: int | None = None) -> float:
    """Shannon entropy (nats) of the empirical label distribution.

    ``labels`` may contain -1 for unlabelled nodes; they are ignored, matching
    the paper's treatment of OGBN-Papers (~98% unlabelled).
    """
    labels = np.asarray(labels)
    labels = labels[labels >= 0]
    if labels.size == 0:
        return 0.0
    if num_classes is None:
        num_classes = int(labels.max()) + 1
    counts = np.bincount(labels, minlength=num_classes).astype(np.float64)
    p = counts / counts.sum()
    nz = p > 0
    return float(-(p[nz] * np.log(p[nz])).sum())


def partition_entropies(
    labels: np.ndarray, parts: np.ndarray, num_parts: int, num_classes: int | None = None
) -> np.ndarray:
    """Entropy of each partition's label distribution. Shape (num_parts,)."""
    labels = np.asarray(labels)
    parts = np.asarray(parts)
    if num_classes is None:
        valid = labels[labels >= 0]
        num_classes = int(valid.max()) + 1 if valid.size else 1
    out = np.zeros(num_parts, dtype=np.float64)
    for k in range(num_parts):
        out[k] = label_entropy(labels[parts == k], num_classes)
    return out


@dataclass(frozen=True)
class PartitionStats:
    """Summary statistics the paper reports about a partitioning."""

    num_parts: int
    sizes: np.ndarray               # nodes per partition
    labelled_sizes: np.ndarray      # LABELLED nodes per partition — the mass
                                    # the entropies describe (labels < 0 are
                                    # invisible to label_entropy)
    entropies: np.ndarray           # per-partition label entropy (nats)
    avg_entropy: float              # H(P) as in Table V (mean over partitions)
    total_entropy: float            # labelled-count-weighted sum (EW objective)
    entropy_variance: float         # the macro-F1 variant balances this
    edge_cut: int                   # raw #cut edges
    weighted_edge_cut: float        # sum of weights of cut edges
    balance: float                  # max(sizes) / mean(sizes)

    def row(self) -> str:
        return (
            f"parts={self.num_parts} H(P)={self.avg_entropy:.4f} "
            f"totH={self.total_entropy:.1f} varH={self.entropy_variance:.4f} "
            f"cut={self.edge_cut} wcut={self.weighted_edge_cut:.1f} "
            f"balance={self.balance:.3f}"
        )


def partition_stats(
    indptr: np.ndarray,
    indices: np.ndarray,
    labels: np.ndarray,
    parts: np.ndarray,
    num_parts: int,
    edge_weights: np.ndarray | None = None,
    num_classes: int | None = None,
) -> PartitionStats:
    """Full partition-quality report over a CSR graph."""
    parts = np.asarray(parts)
    labels = np.asarray(labels)
    sizes = np.bincount(parts, minlength=num_parts)
    # each partition's entropy is computed over its LABELLED nodes only
    # (label_entropy drops labels < 0), so the weighted aggregates must use
    # the same mass — full sizes would let unlabelled nodes (~98% on
    # papers-like graphs) skew the EW objective
    lab_sizes = np.bincount(parts[labels >= 0], minlength=num_parts)
    ents = partition_entropies(labels, parts, num_parts, num_classes)

    # cut edges: CSR row u -> indices[indptr[u]:indptr[u+1]]
    src = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    cut_mask = parts[src] != parts[indices]
    edge_cut = int(cut_mask.sum())
    if edge_weights is None:
        wcut = float(edge_cut)
    else:
        wcut = float(np.asarray(edge_weights)[cut_mask].sum())

    weights = lab_sizes / max(1, lab_sizes.sum())
    total_entropy = float((ents * lab_sizes).sum())
    return PartitionStats(
        num_parts=num_parts,
        sizes=sizes,
        labelled_sizes=lab_sizes,
        entropies=ents,
        avg_entropy=float(ents.mean()),
        total_entropy=total_entropy,
        entropy_variance=float(((ents - ents.mean()) ** 2 * weights).sum()),
        edge_cut=edge_cut,
        weighted_edge_cut=wcut,
        balance=float(sizes.max() / max(1.0, sizes.mean())),
    )
