"""Loss functions: cross-entropy, focal loss (the macro-F1 companion to
CBS), and the GP proximal penalty (paper Eq. 4).

Counterpart of ``repro/train/losses.py`` with its rules kept: labels below
0 are padding, a mask is combined with that rule, the log-softmax runs in
float32, and the mean is taken over ``max(sum(w), 1)``.
"""
from __future__ import annotations

import torch

__all__ = ["cross_entropy_loss", "focal_loss", "prox_penalty"]


def _valid_weights(labels: torch.Tensor, mask) -> torch.Tensor:
    valid = labels >= 0
    if mask is not None:
        valid = valid & (mask > 0)
    return valid.to(torch.float32)


def _label_logp(logits: torch.Tensor, labels: torch.Tensor):
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    safe = labels.clamp_min(0).to(torch.int64)
    return logp, logp.gather(-1, safe[..., None])[..., 0]


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None,
                       label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean softmax cross-entropy over (optionally masked) examples;
    entries with ``labels < 0`` are padding."""
    logp, lab = _label_logp(logits, labels)
    nll = -lab
    if label_smoothing > 0.0:
        nll = (1.0 - label_smoothing) * nll - label_smoothing * logp.mean(-1)
    w = _valid_weights(labels, mask)
    return torch.sum(nll * w) / torch.clamp_min(torch.sum(w), 1.0)


def focal_loss(logits: torch.Tensor, labels: torch.Tensor,
               gamma: float = 2.0,
               mask: torch.Tensor | None = None) -> torch.Tensor:
    """Focal loss FL = (1-p_t)^γ · CE — down-weights easy (majority-class)
    examples."""
    _, logpt = _label_logp(logits, labels)
    pt = torch.exp(logpt)
    fl = -torch.pow(1.0 - pt, gamma) * logpt
    w = _valid_weights(labels, mask)
    return torch.sum(fl * w) / torch.clamp_min(torch.sum(w), 1.0)


def prox_penalty(personal_params, global_params) -> torch.Tensor:
    """Eq. 4 regulariser ``‖W_P − W_G‖₂²`` summed over every weight, in
    float32.  ``global_params`` is the frozen phase-0 model: it is detached
    here, so no gradient reaches it.  Both are sequences of tensors (e.g.
    ``module.parameters()``) in the same order."""
    return sum(torch.sum(torch.square(p.to(torch.float32)
                                      - g.detach().to(torch.float32)))
               for p, g in zip(personal_params, global_params, strict=True))
