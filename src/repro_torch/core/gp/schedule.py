"""GP phase scheduling + early stopping (paper §III-C).

Copied unchanged from ``repro/core/gp/schedule.py`` (host NumPy): the same
scores give the same phase decisions and budgets.

Phase-0 (generalization) runs until the loss curve "starts to flatten"
(Fig. 3's magenta line) or its own early stop fires on the *average*
validation micro-F1 across partitions — all hosts switch together.

Phase-1 (personalization) runs per-host: each partition's *own* validation
micro-F1 drives its early stop independently, and each keeps its own best
model.  In the stacked engine this is a per-partition iteration budget
(0 once a partition has stopped).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["loss_flattened", "EarlyStopper", "GPScheduleConfig", "GPController"]


def loss_flattened(history: list[float] | np.ndarray, window: int = 5, tol: float = 0.02) -> bool:
    """True when the mean relative improvement over the last ``window``
    epochs drops below ``tol`` — the paper's personalization trigger."""
    h = np.asarray(history, dtype=np.float64)
    if len(h) < window + 1:
        return False
    recent = h[-(window + 1):]
    prev, cur = recent[:-1], recent[1:]
    rel = (prev - cur) / np.maximum(np.abs(prev), 1e-12)
    return bool(rel.mean() < tol)


@dataclass
class EarlyStopper:
    """Maximising early-stopper with patience, tracking the best epoch."""

    patience: int = 5
    min_delta: float = 0.0
    best: float = -np.inf
    best_epoch: int = -1
    bad_epochs: int = 0
    stopped: bool = False

    def update(self, value: float, epoch: int) -> bool:
        """Feed one validation score; returns True if this is a new best."""
        if self.stopped:
            return False
        if value > self.best + self.min_delta:
            self.best = value
            self.best_epoch = epoch
            self.bad_epochs = 0
            return True
        self.bad_epochs += 1
        if self.bad_epochs > self.patience:
            self.stopped = True
        return False

    def state_dict(self) -> dict:
        """JSON-safe snapshot (-inf survives the json round trip)."""
        return {"patience": self.patience, "min_delta": self.min_delta,
                "best": self.best, "best_epoch": self.best_epoch,
                "bad_epochs": self.bad_epochs, "stopped": self.stopped}

    def load_state_dict(self, d: dict) -> None:
        self.patience = int(d["patience"])
        self.min_delta = float(d["min_delta"])
        self.best = float(d["best"])
        self.best_epoch = int(d["best_epoch"])
        self.bad_epochs = int(d["bad_epochs"])
        self.stopped = bool(d["stopped"])


@dataclass
class GPScheduleConfig:
    max_epochs: int = 100
    flatten_window: int = 5
    flatten_tol: float = 0.02
    phase0_patience: int = 8
    phase1_patience: int = 5
    min_phase0_epochs: int = 3
    # optional hard split: fraction of max_epochs spent generalizing
    # (the paper's "parameter controls the proportion"); None = loss-driven
    phase0_fraction: float | None = None


@dataclass
class GPController:
    """Host-side state machine driving the two phases for N partitions."""

    num_partitions: int
    config: GPScheduleConfig = field(default_factory=GPScheduleConfig)
    phase: int = 0
    epoch: int = 0
    loss_history: list[float] = field(default_factory=list)
    phase0_stopper: EarlyStopper = field(init=False)
    phase1_stoppers: list[EarlyStopper] = field(init=False)
    personalize_start_epoch: int = -1

    def __post_init__(self) -> None:
        self.phase0_stopper = EarlyStopper(patience=self.config.phase0_patience)
        self.phase1_stoppers = [
            EarlyStopper(patience=self.config.phase1_patience)
            for _ in range(self.num_partitions)
        ]

    # -- phase-0 -----------------------------------------------------------
    def record_phase0(self, mean_loss: float, mean_val_micro_f1: float) -> bool:
        """Record one generalization epoch.  Returns True when this epoch's
        global model is the best so far (caller snapshots W^G)."""
        assert self.phase == 0
        self.loss_history.append(float(mean_loss))
        is_best = self.phase0_stopper.update(float(mean_val_micro_f1), self.epoch)
        self.epoch += 1
        return is_best

    def should_personalize(self) -> bool:
        if self.phase != 0 or self.epoch < self.config.min_phase0_epochs:
            return False
        if self.config.phase0_fraction is not None:
            return self.epoch >= int(self.config.phase0_fraction * self.config.max_epochs)
        return (
            loss_flattened(self.loss_history, self.config.flatten_window, self.config.flatten_tol)
            or self.phase0_stopper.stopped
        )

    def start_personalization(self) -> None:
        assert self.phase == 0
        self.phase = 1
        self.personalize_start_epoch = self.epoch

    # -- phase-1 -----------------------------------------------------------
    def record_phase1(self, per_partition_val_micro_f1: np.ndarray) -> np.ndarray:
        """Record one personalization epoch.  Returns a bool array marking
        partitions whose current model is their new best (caller snapshots
        those personal models)."""
        assert self.phase == 1
        scores = np.asarray(per_partition_val_micro_f1, dtype=np.float64)
        is_best = np.zeros(self.num_partitions, dtype=bool)
        for i, stopper in enumerate(self.phase1_stoppers):
            is_best[i] = stopper.update(float(scores[i]), self.epoch)
        self.epoch += 1
        return is_best

    @property
    def active_partitions(self) -> np.ndarray:
        """Bool mask of partitions still training in phase-1 ('async' stop)."""
        return np.array([not s.stopped for s in self.phase1_stoppers])

    def phase1_budgets(self, natural_iters, taper: bool = False) -> np.ndarray:
        """Per-partition iteration budgets for the next fused phase-1 step —
        the API the engine's masked variable-length scan consumes.

        ``natural_iters`` is each partition's own mini-epoch batch count (a
        scalar broadcasts).  A partition whose early stop fired gets budget
        0 (its params/opt state ride through the step bitwise untouched);
        with ``taper=True`` a partition that is burning patience (its own
        validation micro-F1 stalling) linearly sheds iterations first, so
        the fused step's trip count — max over budgets — shrinks as hosts
        approach their stop instead of falling off a cliff.
        """
        nat = np.broadcast_to(
            np.asarray(natural_iters, dtype=np.int64),
            (self.num_partitions,)).astype(np.int64).copy()
        if taper:
            for i, s in enumerate(self.phase1_stoppers):
                # nat == 0 marks an empty train set — never promote it to 1
                if not s.stopped and s.bad_epochs > 0 and nat[i] > 0:
                    frac = 1.0 - s.bad_epochs / (2.0 * (s.patience + 1))
                    nat[i] = max(1, int(round(nat[i] * frac)))
        return np.where(self.active_partitions, nat, 0).astype(np.int32)

    @property
    def done(self) -> bool:
        if self.epoch >= self.config.max_epochs:
            return True
        if self.phase == 1:
            return not self.active_partitions.any()
        return False

    # -- resume serialization ---------------------------------------------
    def state_dict(self) -> dict:
        """Full controller state as JSON-safe scalars/lists — everything the
        epoch loop's control flow depends on (RunCheckpointer host state)."""
        return {
            "phase": self.phase,
            "epoch": self.epoch,
            "loss_history": list(self.loss_history),
            "personalize_start_epoch": self.personalize_start_epoch,
            "phase0_stopper": self.phase0_stopper.state_dict(),
            "phase1_stoppers": [s.state_dict() for s in self.phase1_stoppers],
        }

    def load_state_dict(self, d: dict) -> None:
        if len(d["phase1_stoppers"]) != self.num_partitions:
            raise ValueError(
                f"controller state for {len(d['phase1_stoppers'])} partitions "
                f"cannot restore into {self.num_partitions}")
        self.phase = int(d["phase"])
        self.epoch = int(d["epoch"])
        self.loss_history = [float(x) for x in d["loss_history"]]
        self.personalize_start_epoch = int(d["personalize_start_epoch"])
        self.phase0_stopper.load_state_dict(d["phase0_stopper"])
        for s, sd in zip(self.phase1_stoppers, d["phase1_stoppers"]):
            s.load_state_dict(sd)
