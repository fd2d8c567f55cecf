from .losses import cross_entropy_loss, focal_loss, prox_penalty
from .metrics import F1Report, f1_scores, f1_scores_torch
from .optim import AdamW, OptState, apply_updates, clip_by_global_norm

__all__ = ["cross_entropy_loss", "focal_loss", "prox_penalty", "F1Report",
           "f1_scores", "f1_scores_torch", "AdamW", "OptState",
           "apply_updates", "clip_by_global_norm"]
