"""CBS — Class-Balanced Sampler (paper §III-B, Eq. 3).

Copied unchanged from ``repro/core/sampler/cbs.py`` (host NumPy): the same
seed draws bitwise the same mini-epochs.

Per training node v:

    P(v) = ||Â(:, v)||² / CF(class[v])        Â = D^{-1/2} A D^{1/2}

i.e. the squared column norm of the normalised adjacency (a degree-flavoured
importance, inherited from the PC-GNN "pick" sampler) divided by the class
frequency — minority classes are sampled with much higher probability.

A *mini-epoch* trains on a fraction (default 25%) of the local training set,
resampled from P every mini-epoch; batches are drawn uniformly within the
mini-epoch subset.  Mini-epochs are what give the paper its 2–3× epoch-time
reduction: majority-class examples are simply visited less often.

Everything here is host-side NumPy (the sampler feeds index arrays into the
device step), mirroring DistDGL where sampling lives on CPU workers.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp

__all__ = ["cbs_probabilities", "CBSampler", "host_draw_count",
           "reset_host_draw_count"]

_HOST_DRAWS = 0


def host_draw_count() -> int:
    """How many host-side NumPy mini-epoch draws have run (the pipeline
    reports the count per phase)."""
    return _HOST_DRAWS


def reset_host_draw_count() -> None:
    global _HOST_DRAWS
    _HOST_DRAWS = 0


def cbs_probabilities(
    indptr: np.ndarray,
    indices: np.ndarray,
    labels: np.ndarray,
    train_idx: np.ndarray,
) -> np.ndarray:
    """Eq. 3 sampling probabilities over ``train_idx`` (sums to 1)."""
    n = len(indptr) - 1
    deg = np.maximum(np.diff(indptr).astype(np.float64), 1.0)
    d_isqrt = 1.0 / np.sqrt(deg)
    d_sqrt = np.sqrt(deg)
    # Â = D^{-1/2} A D^{1/2}; column v of Â has entries d_u^{-1/2} * d_v^{1/2}
    # over in-edges (u, v).  ||Â(:,v)||² = d_v * Σ_{u∈N(v)} 1/d_u.
    src = indices
    dst = np.repeat(np.arange(n), np.diff(indptr))
    col_sq = np.zeros(n)
    np.add.at(col_sq, dst, (d_isqrt[src] ** 2))
    col_sq *= d_sqrt**2

    labels = np.asarray(labels)
    train_idx = np.asarray(train_idx)
    train_labels = labels[train_idx]
    num_classes = int(train_labels.max()) + 1 if train_labels.size else 1
    cf = np.bincount(train_labels, minlength=num_classes).astype(np.float64)
    p = col_sq[train_idx] / np.maximum(cf[train_labels], 1.0)
    s = p.sum()
    if s <= 0:
        return np.full(len(train_idx), 1.0 / max(1, len(train_idx)))
    return p / s


@dataclass
class CBSampler:
    """Mini-epoch batch stream for one compute host (= one partition).

    ``subset_fraction=1.0`` with ``class_balanced=False`` degrades to the
    plain DistDGL epoch sampler (the paper's baseline), so ablations share
    one code path.
    """

    indptr: np.ndarray
    indices: np.ndarray
    labels: np.ndarray
    train_idx: np.ndarray
    batch_size: int = 1024
    subset_fraction: float = 0.25
    class_balanced: bool = True
    seed: int = 0
    _rng: np.random.Generator = field(init=False, repr=False)
    _probs: np.ndarray = field(init=False, repr=False)

    def __post_init__(self) -> None:
        self._rng = np.random.default_rng(self.seed)
        self.train_idx = np.asarray(self.train_idx)
        if self.class_balanced:
            self._probs = cbs_probabilities(
                self.indptr, self.indices, self.labels, self.train_idx
            )
        else:
            self._probs = np.full(len(self.train_idx), 1.0 / max(1, len(self.train_idx)))

    @property
    def mini_epoch_size(self) -> int:
        if not self.class_balanced:
            return len(self.train_idx)
        return max(self.batch_size, int(len(self.train_idx) * self.subset_fraction))

    def sample_mini_epoch(self) -> np.ndarray:
        """Draw the mini-epoch node SUBSET — a weighted draw without
        replacement over Eq. 3 (the paper samples a subset; duplicates would
        inflate variance)."""
        global _HOST_DRAWS
        _HOST_DRAWS += 1
        k = min(self.mini_epoch_size, len(self.train_idx))
        if k == len(self.train_idx) and not self.class_balanced:
            return self._rng.permutation(self.train_idx)
        support = int((self._probs > 0).sum())
        replace = k > support
        picks = self._rng.choice(
            len(self.train_idx), size=k, replace=replace, p=self._probs
        )
        return self.train_idx[picks]

    def batches(self) -> "list[np.ndarray]":
        """Random batches covering one mini-epoch (last ragged batch kept)."""
        nodes = self.sample_mini_epoch()
        self._rng.shuffle(nodes)
        return [
            nodes[i : i + self.batch_size] for i in range(0, len(nodes), self.batch_size)
        ]

    def empirical_class_distribution(self, num_draws: int = 10) -> np.ndarray:
        """Diagnostic: label distribution CBS actually feeds the trainer."""
        labs = np.concatenate(
            [self.labels[self.sample_mini_epoch()] for _ in range(num_draws)]
        )
        labs = labs[labs >= 0]
        num_classes = int(self.labels[self.labels >= 0].max()) + 1
        counts = np.bincount(labs, minlength=num_classes).astype(np.float64)
        return counts / max(1.0, counts.sum())
