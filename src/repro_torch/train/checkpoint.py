"""Checkpointing: trees of tensors and arrays <-> npz with path-keyed entries
(+ best-model bookkeeping for the GP phases: one global W^G, one W^P per
partition).  Counterpart of ``repro/train/checkpoint.py``, over torch
tensors and NumPy; no ``torch.save`` and no pickle.

The file contract is the reference's, so a file written by either package
loads in the other:

  · **Path-keyed entries.**  Every leaf is one npz entry whose key joins its
    path with ``::``: a dict key as itself, a list or tuple index as its
    number, a named field as ``.field``.  A :class:`~repro_torch.graph.sage.
    GraphSAGE` is the reference's ``SAGEParams``
    (``.layers::{i}::.{w_self,w_neigh,b}``), and an
    :class:`~repro_torch.train.optim.OptState`'s moment lists, in
    ``parameters()`` order, map to that same layout
    (``.mu::.layers::{i}::.w_self`` ...).  ``None`` holds no entry.
  · **Atomic writes.**  ``save_pytree`` writes the npz to a tmp file in the
    target directory, ``fsync``s it and publishes it with ``os.replace``;
    the sidecar ``<name>.npz.meta.json`` is written the same way, AFTER the
    arrays, so a meta/array mismatch is detectable (CRC) rather than silent.
  · **Per-entry CRC.**  The sidecar carries a crc32 per entry and the
    caller's meta under ``"meta"``; ``load_pytree`` verifies every entry it
    restores.  A truncated or bit-flipped file raises
    :class:`CheckpointCorruptError` naming the offending entry.
  · **Key diagnosis.**  A checkpoint whose entries do not match the
    template raises :class:`CheckpointKeyError` with the FULL missing and
    unexpected key sets.
  · **Dtype and device fidelity.**  bfloat16 leaves are widened to float32
    on save and cast back on load (the exact payload).  A tensor leaf of
    the template restores to a tensor of its dtype on its device; a NumPy
    leaf to a NumPy array of its dtype.

Saving copies each tensor to the host (writing a file needs the bytes
there); loading puts each one back on its template's device.
"""
from __future__ import annotations

import json
import os
import zipfile
import zlib
from typing import Any, NamedTuple

import numpy as np
import torch

from ..graph.sage import GraphSAGE
from .optim import OptState

__all__ = ["save_pytree", "load_pytree", "load_meta", "CheckpointManager",
           "CheckpointCorruptError", "CheckpointKeyError"]

_SEP = "::"
# a GraphSAGE layer's weights in parameters() order (the reference's
# SAGELayer fields)
_LAYER_FIELDS = ("w_self", "w_neigh", "b")


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file is unreadable or fails its integrity check."""


class CheckpointKeyError(RuntimeError):
    """Checkpoint entries do not match the restore template."""


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _meta_path(path: str) -> str:
    return _npz_path(path) + ".meta.json"


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic, int, float,
                          bool))


class _Layer(NamedTuple):     # the reference's SAGELayer
    w_self: Any
    w_neigh: Any
    b: Any


class _Params(NamedTuple):    # the reference's SAGEParams
    layers: list


def _layers_of(tensors) -> _Params:
    """A flat ``parameters()``-ordered list in the SAGEParams layout."""
    tensors = list(tensors)
    if len(tensors) % len(_LAYER_FIELDS):
        raise ValueError(f"{len(tensors)} tensors are not whole GraphSAGE "
                         "layers of (w_self, w_neigh, b)")
    return _Params([_Layer(*tensors[i:i + len(_LAYER_FIELDS)])
                    for i in range(0, len(tensors), len(_LAYER_FIELDS))])


def _children(node) -> list[tuple[str, Any]]:
    """``(key, child)`` pairs of one interior node, in the reference's
    flattening order (dict keys sorted, fields in declaration order)."""
    if isinstance(node, GraphSAGE):
        return _children(_layers_of(node.parameters()))
    if isinstance(node, OptState):
        return [(".step", node.step), (".mu", _layers_of(node.mu)),
                (".nu", _layers_of(node.nu))]
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    raise TypeError(f"cannot checkpoint a {type(node).__name__}")


def _leaves(tree, prefix: str = ""):
    """``(key, leaf)`` for every leaf of ``tree``, in flattening order."""
    if tree is None:
        return
    if _is_leaf(tree):
        yield prefix, tree
        return
    for k, c in _children(tree):
        yield from _leaves(c, f"{prefix}{_SEP}{k}" if prefix else k)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            # npz cannot hold bf16; widen (load casts back)
            t = t.to(torch.float32)
        return t.cpu().numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V" or str(arr.dtype) == "bfloat16":
        arr = arr.astype(np.float32)
    return arr


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {k: _to_numpy(v) for k, v in _leaves(tree)}


def _atomic_write(path: str, write_fn) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save_pytree(path: str, tree: Any, meta: dict | None = None) -> None:
    """Atomically persist ``tree``: tmp + ``fsync`` + ``os.replace`` for the
    npz, then the meta sidecar (caller meta under ``"meta"``, per-entry
    crc32 under ``"crc32"``)."""
    final = _npz_path(path)
    os.makedirs(os.path.dirname(final) or ".", exist_ok=True)
    entries = _flatten(tree)
    crcs = {k: zlib.crc32(np.ascontiguousarray(v).tobytes())
            for k, v in entries.items()}
    _atomic_write(final, lambda f: np.savez(f, **entries))
    doc = json.dumps({"crc32": crcs, "meta": meta or {}}, indent=2)
    _atomic_write(_meta_path(path), lambda f: f.write(doc.encode()))


def load_meta(path: str) -> dict:
    """The caller-supplied meta dict saved alongside ``path`` ({} if none)."""
    mp = _meta_path(path)
    if not os.path.exists(mp):
        return {}
    with open(mp) as f:
        doc = json.load(f)
    # the oldest files stored the user meta at top level
    return doc.get("meta", doc) if isinstance(doc, dict) else {}


def _load_crcs(path: str) -> dict[str, int]:
    mp = _meta_path(path)
    if not os.path.exists(mp):
        return {}
    try:
        with open(mp) as f:
            doc = json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        raise CheckpointCorruptError(f"{mp}: unreadable meta sidecar ({e})")
    return doc.get("crc32", {}) if isinstance(doc, dict) else {}


def _restore_leaf(arr: np.ndarray, leaf):
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)
    return np.asarray(arr).astype(np.asarray(leaf).dtype, copy=False)


@torch.no_grad()
def _rebuild(node, prefix: str, take):
    """``node``'s structure with every leaf replaced by ``take(key, leaf)``."""
    if node is None:
        return None
    if _is_leaf(node):
        return take(prefix, node)
    key = lambda k: f"{prefix}{_SEP}{k}" if prefix else k
    if isinstance(node, GraphSAGE):
        out = GraphSAGE(node.feature_dim, node.hidden_dim, node.num_classes,
                        node.num_layers)
        layers = _rebuild(_layers_of(node.parameters()), prefix, take).layers
        for lp, got in zip(out.layers, layers):
            for name in _LAYER_FIELDS:
                setattr(lp, name, torch.nn.Parameter(getattr(got, name)))
        return out
    if isinstance(node, OptState):
        flat = lambda f, ts: [w for layer in _rebuild(
            _layers_of(ts), key(f".{f}"), take).layers for w in layer]
        return OptState(step=take(key(".step"), node.step),
                        mu=flat("mu", node.mu), nu=flat("nu", node.nu))
    if isinstance(node, dict):
        return {k: _rebuild(node[k], key(str(k)), take) for k in sorted(node)}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_rebuild(getattr(node, f), key(f".{f}"), take)
                            for f in node._fields))
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(c, key(str(i)), take)
                          for i, c in enumerate(node))
    raise TypeError(f"cannot restore into a {type(node).__name__}")


def load_pytree(path: str, like: Any) -> Any:
    """Restore into the structure of ``like`` (shape/dtype/device template).

    Raises :class:`CheckpointCorruptError` naming the offending entry on a
    truncated/bit-flipped archive or a CRC mismatch, and
    :class:`CheckpointKeyError` listing the full missing/unexpected key
    sets when the checkpoint doesn't match the template.
    """
    final = _npz_path(path)
    try:
        data = np.load(final)
        available = set(data.files)
    except (zipfile.BadZipFile, OSError, ValueError, EOFError, KeyError) as e:
        raise CheckpointCorruptError(f"{final}: unreadable archive ({e})")
    with data:
        crcs = _load_crcs(path)
        keys = [k for k, _ in _leaves(like)]
        missing = sorted(set(keys) - available)
        unexpected = sorted(available - set(keys))
        if missing or unexpected:
            raise CheckpointKeyError(
                f"{final}: entries do not match template — "
                f"missing {missing or '[]'}, unexpected {unexpected or '[]'}")
        return _rebuild(like, "", lambda key, leaf: _take(data, final, crcs,
                                                          key, leaf))


def _take(data, final: str, crcs: dict, key: str, leaf):
    """Entry ``key`` of the open archive, integrity-checked, as ``leaf``'s
    kind, dtype and device."""
    try:
        arr = data[key]
    except (zipfile.BadZipFile, zlib.error, OSError, ValueError,
            EOFError) as e:
        raise CheckpointCorruptError(
            f"{final}: entry '{key}' is corrupt ({e})")
    if key in crcs and zlib.crc32(
            np.ascontiguousarray(arr).tobytes()) != crcs[key]:
        raise CheckpointCorruptError(
            f"{final}: entry '{key}' failed its crc32 integrity check")
    shape = tuple(np.shape(leaf))
    if tuple(arr.shape) != shape:
        raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {shape}")
    return _restore_leaf(arr, leaf)


class CheckpointManager:
    """Best-model tracking for GP training.

    Phase-0 keeps the best GLOBAL model (avg val micro-F1); phase-1 keeps the
    best PERSONAL model per partition (its own val micro-F1) — 'the best
    model is saved' per the paper, independently for each phase/host.
    ``update_*`` persist only on a strict score improvement and return
    whether they saved; ``save_*`` persist unconditionally.
    """

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def _global_path(self) -> str:
        return os.path.join(self.dir, "global_best.npz")

    def _personal_path(self, partition: int) -> str:
        return os.path.join(self.dir, f"personal_{partition}_best.npz")

    def save_global(self, params: Any, epoch: int, score: float) -> None:
        save_pytree(self._global_path(), params,
                    meta={"epoch": epoch, "score": score, "phase": 0})

    def save_personal(self, partition: int, params: Any, epoch: int,
                      score: float) -> None:
        save_pytree(self._personal_path(partition), params,
                    meta={"epoch": epoch, "score": score, "phase": 1,
                          "partition": partition})

    def global_meta(self) -> dict:
        return load_meta(self._global_path())

    def personal_meta(self, partition: int) -> dict:
        return load_meta(self._personal_path(partition))

    def update_global(self, params: Any, epoch: int, score: float) -> bool:
        prev = self.global_meta().get("score")
        if prev is not None and score <= prev:
            return False
        self.save_global(params, epoch, score)
        return True

    def update_personal(self, partition: int, params: Any, epoch: int,
                        score: float) -> bool:
        prev = self.personal_meta(partition).get("score")
        if prev is not None and score <= prev:
            return False
        self.save_personal(partition, params, epoch, score)
        return True

    def load_global(self, like: Any) -> Any:
        return load_pytree(self._global_path(), like)

    def load_personal(self, partition: int, like: Any) -> Any:
        return load_pytree(self._personal_path(partition), like)
