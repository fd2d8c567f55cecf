"""F1 metrics exactly as the paper reports them.

micro-F1    — global TP/FP/FN over all test examples (== accuracy for
              single-label multi-class).
macro-F1    — unweighted mean of per-class F1.
weighted-F1 — per-class F1 averaged with class-frequency weights.

Counterpart of ``repro/train/metrics.py``: the NumPy half (host
evaluation) is copied unchanged; ``f1_scores_jnp`` becomes
:func:`f1_scores_torch` (evaluation on the device).  An out-of-range
prediction counts as a miss on the true class and a false positive of no
class, in both.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["F1Report", "f1_scores", "f1_scores_torch", "confusion_counts"]


@dataclass(frozen=True)
class F1Report:
    micro: float
    macro: float
    weighted: float
    per_class: np.ndarray
    support: np.ndarray

    def row(self) -> str:
        return f"micro={self.micro*100:.2f} macro={self.macro*100:.2f} weighted={self.weighted*100:.2f}"


def confusion_counts(
    preds: np.ndarray, labels: np.ndarray, num_classes: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(tp, fp, fn) per class, ignoring labels < 0.

    An out-of-range prediction (negative or >= num_classes) names no real
    class: it counts as a miss (fn on the true class) but contributes fp to
    NO class — the same rule f1_scores_torch applies.
    """
    valid = labels >= 0
    preds, labels = preds[valid], labels[valid]
    tp = np.zeros(num_classes)
    fp = np.zeros(num_classes)
    fn = np.zeros(num_classes)
    hit = preds == labels
    in_range = (preds >= 0) & (preds < num_classes)
    np.add.at(tp, labels[hit], 1.0)
    np.add.at(fp, preds[~hit & in_range], 1.0)
    np.add.at(fn, labels[~hit], 1.0)
    return tp, fp, fn


def f1_scores(preds: np.ndarray, labels: np.ndarray, num_classes: int) -> F1Report:
    preds = np.asarray(preds)
    labels = np.asarray(labels)
    tp, fp, fn = confusion_counts(preds, labels, num_classes)
    denom = 2 * tp + fp + fn
    per_class = np.where(denom > 0, 2 * tp / np.maximum(denom, 1e-12), 0.0)
    support = tp + fn
    total = support.sum()
    micro_den = 2 * tp.sum() + fp.sum() + fn.sum()
    micro = float(2 * tp.sum() / micro_den) if micro_den > 0 else 0.0
    present = support > 0
    macro = float(per_class[present].mean()) if present.any() else 0.0
    weighted = float((per_class * support).sum() / total) if total > 0 else 0.0
    return F1Report(micro=micro, macro=macro, weighted=weighted,
                    per_class=per_class, support=support)


def f1_scores_torch(preds: torch.Tensor, labels: torch.Tensor,
                    num_classes: int):
    """On-device micro/macro/weighted triple (float32 scalar tensors) of
    1-D ``preds``/``labels``; labels below 0 are ignored."""
    valid = labels >= 0
    safe_labels = labels.clamp_min(0)
    hit = (preds == labels) & valid
    miss = (preds != labels) & valid
    fp_ok = miss & (preds >= 0) & (preds < num_classes)
    safe_preds = preds.clamp(0, num_classes - 1)
    z = lambda: torch.zeros(num_classes, dtype=torch.float32,
                            device=preds.device)
    tp = z().index_add_(0, safe_labels, hit.to(torch.float32))
    fn = z().index_add_(0, safe_labels, miss.to(torch.float32))
    fp = z().index_add_(0, safe_preds, fp_ok.to(torch.float32))
    denom = 2 * tp + fp + fn
    per_class = torch.where(denom > 0, 2 * tp / denom.clamp_min(1e-12),
                            torch.zeros_like(denom))
    support = tp + fn
    micro = 2 * tp.sum() / (2 * tp.sum() + fp.sum() + fn.sum()).clamp_min(1e-12)
    present = (support > 0).to(torch.float32)
    macro = (per_class * present).sum() / present.sum().clamp_min(1.0)
    weighted = (per_class * support).sum() / support.sum().clamp_min(1.0)
    return micro, macro, weighted
