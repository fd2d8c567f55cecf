"""Deterministic fault injection for training and serving (DESIGN.md §10).

A :class:`FaultPlan` is a pure, reusable schedule: given the same seed and
knobs it always describes the same faults, so every failure mode a test
exercises is reproducible bit-for-bit.  The plan itself holds no mutable
state — ``run_eat_distgnn`` and ``GNNServingEngine.tick`` query it at
their epoch/tick boundaries:

  · **Partition-host crashes** fire at epoch boundaries (after the epoch's
    checkpoint, the only honest crash point an epoch-granular checkpointer
    can replay through) by raising :class:`InjectedCrash`; serving-side
    crashes fail a partition's health at a tick boundary.
  · **Straggler delays** add per-partition seconds to the simulated host
    time of chosen epochs — the synchronous phases feel them through the
    existing max-over-hosts accounting, numerics are untouched.
  · **Dropped halo-refresh payloads** make the engine discard the freshly
    exchanged cache state for one eval forward (the wire ate the payload;
    the stale cache ages on), via ``SPMDEngine.drop_next_halo_refresh``.
  · **Checkpoint corruption** helpers truncate or bit-flip files on disk
    at seed-determined offsets, for exercising the CRC/fallback paths.

``FaultPlan.random`` draws a full schedule from one seed; explicit
constructor arguments script exact scenarios.
"""
from __future__ import annotations

import os
import zlib
from dataclasses import dataclass, field
from typing import Mapping, Sequence

import numpy as np

__all__ = ["InjectedCrash", "FaultPlan", "truncate_file", "flip_bit"]


class InjectedCrash(RuntimeError):
    """A scheduled partition-host crash (training epoch boundary)."""

    def __init__(self, epoch: int):
        super().__init__(f"injected crash after epoch {epoch}")
        self.epoch = epoch

    def __reduce__(self):
        # pickled by its epoch (a spawned mesh rank hands it to its parent)
        return type(self), (self.epoch,)


def truncate_file(path: str, keep_fraction: float = 0.5) -> int:
    """Cut ``path`` to the leading fraction of its bytes; returns new size."""
    size = os.path.getsize(path)
    keep = max(0, int(size * keep_fraction))
    with open(path, "rb+") as f:
        f.truncate(keep)
    return keep


def flip_bit(path: str, byte_offset: int, bit: int = 0) -> None:
    """Flip one bit in place (the classic silent-corruption model)."""
    with open(path, "rb+") as f:
        f.seek(byte_offset)
        b = f.read(1)
        f.seek(byte_offset)
        f.write(bytes([b[0] ^ (1 << (bit & 7))]))


@dataclass(frozen=True)
class FaultPlan:
    """A seeded, immutable fault schedule.

    ``crash_epochs``       epoch-boundary counts (epochs completed) at which
                           training raises :class:`InjectedCrash`.
    ``straggler``          {epoch: {partition: delay_seconds}} added to the
                           simulated host time.
    ``drop_refresh_epochs`` epochs whose eval-forward halo refresh payload
                           is dropped in transit (halo cache runs only).
    ``serve_fail``         {tick: (partitions,)} failed at that tick.
    ``serve_recover``      {tick: (partitions,)} recovered at that tick.
    ``seed``               drives the corruption helpers' offsets.
    """

    crash_epochs: frozenset = frozenset()
    straggler: Mapping[int, Mapping[int, float]] = field(default_factory=dict)
    drop_refresh_epochs: frozenset = frozenset()
    serve_fail: Mapping[int, tuple] = field(default_factory=dict)
    serve_recover: Mapping[int, tuple] = field(default_factory=dict)
    seed: int = 0

    # ---------------------------------------------------- training queries
    def crash_at(self, epochs_completed: int) -> bool:
        return epochs_completed in self.crash_epochs

    def straggler_delay(self, epoch: int, num_parts: int) -> np.ndarray:
        out = np.zeros(num_parts)
        for p, d in self.straggler.get(epoch, {}).items():
            if 0 <= int(p) < num_parts:
                out[int(p)] = float(d)
        return out

    def drop_halo_refresh(self, epoch: int) -> bool:
        return epoch in self.drop_refresh_epochs

    # ----------------------------------------------------- serving queries
    def serve_events(self, tick: int) -> list[tuple[str, int]]:
        """[('fail'|'recover', partition), ...] scheduled for this tick."""
        ev = [("fail", int(p)) for p in self.serve_fail.get(tick, ())]
        ev += [("recover", int(p)) for p in self.serve_recover.get(tick, ())]
        return ev

    # ------------------------------------------------- checkpoint sabotage
    def corrupt(self, path: str, mode: str = "bitflip") -> dict:
        """Deterministically damage a checkpoint file: the offset is a pure
        function of (plan seed, file name, file size), so the same plan
        always injects the same corruption."""
        size = os.path.getsize(path)
        h = zlib.crc32(os.path.basename(path).encode()) ^ (self.seed * 2654435761)
        if mode == "truncate":
            keep = truncate_file(path, 0.25 + (h % 1000) / 4000.0)
            return {"mode": "truncate", "kept_bytes": keep, "orig_bytes": size}
        if mode == "bitflip":
            # land inside the archive body, past the local zip header
            off = 64 + (h % max(1, size - 128)) if size > 256 else size // 2
            flip_bit(path, off, h % 8)
            return {"mode": "bitflip", "byte_offset": off, "bit": h % 8}
        raise ValueError(f"unknown corruption mode: {mode}")

    # ------------------------------------------------------------ builders
    @classmethod
    def random(cls, seed: int, *, num_parts: int, max_epochs: int,
               crash_prob: float = 0.2, straggler_prob: float = 0.2,
               drop_refresh_prob: float = 0.2, max_delay_s: float = 2.0,
               serve_ticks: int = 0, serve_fail_prob: float = 0.0,
               down_ticks: int = 3) -> "FaultPlan":
        """Draw a full schedule from one seed (same seed → same plan)."""
        rng = np.random.default_rng([seed, 0xFA17])
        crash = frozenset(
            int(e) for e in range(1, max_epochs)
            if rng.random() < crash_prob)
        straggler = {}
        for e in range(max_epochs):
            if rng.random() < straggler_prob:
                p = int(rng.integers(num_parts))
                straggler[e] = {p: float(rng.uniform(0.1, max_delay_s))}
        drops = frozenset(
            int(e) for e in range(max_epochs)
            if rng.random() < drop_refresh_prob)
        fail, recover = {}, {}
        for t in range(1, serve_ticks + 1):
            if rng.random() < serve_fail_prob:
                p = int(rng.integers(num_parts))
                fail.setdefault(t, ())
                fail[t] = fail[t] + (p,)
                rt = t + down_ticks
                recover.setdefault(rt, ())
                recover[rt] = recover[rt] + (p,)
        return cls(crash_epochs=crash, straggler=straggler,
                   drop_refresh_epochs=drops, serve_fail=fail,
                   serve_recover=recover, seed=seed)
