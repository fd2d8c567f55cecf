"""Epoch-granular run checkpointing with a checksummed manifest
(counterpart of ``repro/robustness/checkpoint.py``, unchanged but for
this paragraph: it writes through the port's ``train.checkpoint``).

:class:`RunCheckpointer` persists the FULL pipeline state at epoch
boundaries so a killed run resumes bit-for-bit:

  · each step is one atomic ``save_pytree`` archive (device/host arrays:
    params, opt states, the stacked halo cache, ...) plus a JSON host-state
    blob (controller, RNG generator states, histories) carried in the same
    sidecar the per-entry CRCs live in;
  · a ``manifest.json`` — written LAST, atomically — lists the retained
    steps with whole-file CRCs, so a crash mid-save never publishes a
    half-written checkpoint and the newest VALID step is discoverable;
  · only the last K steps are retained (older archives pruned after the
    manifest stops referencing them);
  · ``load_latest`` walks the manifest newest→oldest, skipping any step
    whose archive fails its integrity checks — one corrupted file costs
    one epoch of progress, not the run.

The arrays template depends on host state (a phase-1 checkpoint carries
personal params a phase-0 one doesn't), so ``load_latest`` takes a
``make_like(host_state) -> template`` callable.
"""
from __future__ import annotations

import json
import os
import zlib
from typing import Any, Callable

from ..train.checkpoint import (CheckpointCorruptError, load_meta,
                                load_pytree, save_pytree)

__all__ = ["RunCheckpointer"]

_MANIFEST = "manifest.json"


def _file_crc(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                return crc
            crc = zlib.crc32(chunk, crc)


class RunCheckpointer:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = max(1, int(keep_last))
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------ plumbing
    def _name(self, step: int) -> str:
        return f"ckpt_{step:06d}"

    def _npz(self, step: int) -> str:
        return os.path.join(self.dir, self._name(step) + ".npz")

    def _manifest_path(self) -> str:
        return os.path.join(self.dir, _MANIFEST)

    def _read_manifest(self) -> dict:
        path = self._manifest_path()
        if not os.path.exists(path):
            return {"steps": [], "entries": {}}
        try:
            with open(path) as f:
                return json.load(f)
        except (json.JSONDecodeError, OSError):
            # a torn manifest write loses the INDEX, not the archives:
            # rebuild from whatever complete checkpoints are on disk
            steps = sorted(
                int(n[5:11]) for n in os.listdir(self.dir)
                if n.startswith("ckpt_") and n.endswith(".npz"))
            return {"steps": steps, "entries": {}}

    def _write_manifest(self, man: dict) -> None:
        tmp = self._manifest_path() + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(man, f, indent=2)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._manifest_path())

    # -------------------------------------------------------------- public
    def steps(self) -> list[int]:
        """Retained steps, oldest first."""
        return sorted(int(s) for s in self._read_manifest()["steps"])

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def save(self, step: int, arrays: Any, host_state: dict) -> str:
        """Persist one epoch boundary; prunes beyond ``keep_last``.  The
        manifest is updated only after the archive is fully on disk."""
        step = int(step)
        path = self._npz(step)
        save_pytree(path, arrays, meta={"step": step, "host": host_state})
        man = self._read_manifest()
        steps = sorted(set(int(s) for s in man["steps"]) | {step})
        drop, steps = steps[:-self.keep_last], steps[-self.keep_last:]
        entries = {k: v for k, v in man.get("entries", {}).items()
                   if int(k) in steps}
        entries[str(step)] = {"file": os.path.basename(path),
                              "crc32": _file_crc(path)}
        self._write_manifest({"steps": steps, "entries": entries})
        for s in drop:
            for stale in (self._npz(s), self._npz(s) + ".meta.json"):
                if os.path.exists(stale):
                    os.remove(stale)
        return path

    def peek(self, step: int) -> dict:
        """Host-state blob of ``step`` (no array I/O)."""
        meta = load_meta(self._npz(step))
        if "host" not in meta:
            raise CheckpointCorruptError(
                f"{self._npz(step)}: missing host-state blob")
        return meta["host"]

    def load(self, step: int, like: Any) -> tuple[Any, dict]:
        """(arrays, host_state) of one step, integrity-checked: whole-file
        CRC from the manifest, then per-entry CRCs inside load_pytree."""
        path = self._npz(step)
        if not os.path.exists(path):
            raise CheckpointCorruptError(f"{path}: missing archive")
        ent = self._read_manifest().get("entries", {}).get(str(int(step)))
        if ent and _file_crc(path) != ent["crc32"]:
            raise CheckpointCorruptError(
                f"{path}: whole-file crc32 mismatch vs manifest")
        host = self.peek(step)
        return load_pytree(path, like), host

    def load_latest(self, make_like: Callable[[dict], Any]
                    ) -> tuple[Any, dict, int] | None:
        """Newest valid checkpoint as (arrays, host_state, step), falling
        back step by step past corrupted archives; None if no checkpoints,
        raises if every retained step is corrupt."""
        steps = self.steps()
        if not steps:
            return None
        skipped: list[str] = []
        for step in reversed(steps):
            try:
                host = self.peek(step)
                arrays, host = self.load(step, make_like(host))
                return arrays, host, step
            except CheckpointCorruptError as e:
                skipped.append(str(e))
        raise CheckpointCorruptError(
            "no valid checkpoint among retained steps "
            f"{steps}: {'; '.join(skipped)}")
