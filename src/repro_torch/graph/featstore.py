"""Two-tier feature store: hot rows resident on the device, cold rows
staged from pinned host memory per eval or epoch call (counterpart of
``repro/graph/featstore.py``).

Features dominate graph memory: the store keeps only a high-traffic subset
resident and ships the rest when a forward needs the full feature plane.
The split is STATIC and score-ordered: each partition's ``own_cap`` local
feature rows are ranked by a hot-set policy, the top ``hot_frac`` fraction
stays on the device and the remainder lives on the host.

The NumPy parts are copied from the reference unchanged (the reference
module imports ``jax.numpy``, so nothing is imported from it);
:func:`assemble_features` is torch.  Its invariant is *bitwise
reconstruction*: scattering the hot rows and the staged cold rows into a
zero ``(max_nodes, D)`` plane reproduces ``PartitionedGraph.features[p]``
exactly, because

  * ``rows_hot`` and ``rows_cold`` PARTITION ``range(own_cap)``,
  * every row at index >= ``n_own[p]`` of ``pg.features[p]`` is zero by
    construction (halo rows arrive through the exchange, pads are pads), and
  * both tiers are cast to the target dtype with the same NumPy cast the
    all-resident engine's plane goes through (widening is exact).

Downstream forwards only read the assembled ``features`` plane, so the halo
cache and the compressed exchange compose with the store untouched.

Hot-set policies:

  degree   rank by clamped in-degree (``pg.deg``): high-degree rows are
           read by the most aggregations per epoch;
  freq     degree plus a dominating boost for training-set membership.

Ties break by local row index (stable argsort), so the split is a pure
function of the graph and the policy.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["HOT_POLICIES", "FeatureBudgetError", "GlobalFeatStore",
           "PartitionFeatStore", "assemble_features",
           "build_global_feat_store", "build_partition_feat_store",
           "check_feat_budget", "feat_peak_bytes", "host_staging",
           "hot_order", "numpy_dtype", "reconstruct_features"]

HOT_POLICIES = ("degree", "freq")

# dominates any clamped in-degree, so under the "freq" policy every
# training row outranks every non-training row while degree still orders
# rows within each class
_FREQ_BOOST = 1e9


class FeatureBudgetError(ValueError):
    """Raised when a configuration's peak device feature bytes exceed the
    declared ``feat_budget_mb``: the engine refuses to build rather than
    run out of memory mid-epoch.  A ``ValueError`` so existing
    config-validation handling catches it."""


def numpy_dtype(dtype) -> np.dtype:
    """``dtype`` (a ``torch.dtype`` or anything ``np.dtype`` takes) as a
    NumPy dtype."""
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def host_staging(cold: np.ndarray, device) -> torch.Tensor:
    """A cold tier as the host tensor it is staged from onto ``device``:
    page-locked (pinned) when ``device`` is a CUDA device, so every staging
    is an asynchronous DMA copy, never one from pageable memory; a plain
    host tensor when the caller asked for the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(cold))
    return t.pin_memory() if torch.device(device).type == "cuda" else t


def hot_order(scores) -> np.ndarray:
    """Row indices in descending score order, ties broken by row index
    (stable sort on the negated scores): the one ranking primitive both
    store splits share."""
    return np.argsort(-np.asarray(scores, np.float64), kind="stable")


def _hot_count(hot_frac: float, n: int) -> int:
    if not 0.0 <= hot_frac <= 1.0:
        raise ValueError(f"hot_frac must be in [0, 1], got {hot_frac}")
    return min(max(int(round(hot_frac * n)), 0), n)


def _scores(policy: str, deg: np.ndarray, is_train: np.ndarray) -> np.ndarray:
    if policy not in HOT_POLICIES:
        raise ValueError(f"unknown hot_policy {policy!r} "
                         f"(expected one of {HOT_POLICIES})")
    scores = np.asarray(deg, np.float64)
    if policy == "freq":
        scores = scores + _FREQ_BOOST * np.asarray(is_train, np.float64)
    return scores


# ---------------------------------------------------------------------------
# partition-local store (the engine's stacked feature plane)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PartitionFeatStore:
    """Score-split owned feature rows of a :class:`PartitionedGraph`.

    ``hot`` (P, H, D) is the device-resident tier, ``cold`` (P, C, D) the
    host staging buffer (H + C == own_cap); ``rows_hot``/``rows_cold`` are
    the local row ids each tier scatters back into.  All arrays are
    target-dtype NumPy: the caller moves ``hot`` to the device once and
    stages ``cold`` per call.
    """

    hot: np.ndarray        # (P, H, D) target dtype
    rows_hot: np.ndarray   # (P, H) int32 local row ids
    cold: np.ndarray       # (P, C, D) target dtype, host-resident
    rows_cold: np.ndarray  # (P, C) int32


def build_partition_feat_store(pg, hot_frac: float, policy: str,
                               dtype) -> PartitionFeatStore:
    """Split each partition's ``own_cap`` feature rows into hot/cold tiers.

    ``H = round(hot_frac * own_cap)`` is shared across partitions (the hot
    tier must stack into one (P, H, D) array); ragged real row counts are
    handled by the padding rows, which are all-zero and score lowest under
    both policies' real signals.
    """
    dtype = numpy_dtype(dtype)
    P, own_cap = pg.deg.shape
    d = pg.features.shape[-1]
    H = _hot_count(hot_frac, own_cap)
    C = own_cap - H
    feats = np.asarray(pg.features, dtype)
    hot = np.empty((P, H, d), dtype)
    cold = np.empty((P, C, d), dtype)
    rows_hot = np.empty((P, H), np.int32)
    rows_cold = np.empty((P, C), np.int32)
    for p in range(P):
        order = hot_order(_scores(policy, pg.deg[p],
                                  pg.train_mask[p, :own_cap]))
        rows_hot[p] = order[:H]
        rows_cold[p] = order[H:]
        hot[p] = feats[p, rows_hot[p]]
        cold[p] = feats[p, rows_cold[p]]
    return PartitionFeatStore(hot=hot, rows_hot=rows_hot,
                              cold=cold, rows_cold=rows_cold)


def assemble_features(hot: torch.Tensor, rows_hot: torch.Tensor,
                      cold: torch.Tensor, rows_cold: torch.Tensor,
                      max_nodes: int) -> torch.Tensor:
    """The full feature plane ``zeros((max_nodes, D)) ∪ hot ∪ cold``, bitwise
    equal to the all-resident ``features`` (see the module invariant).

    One partition's tiers (``hot`` (H, D), ``rows_hot`` (H,), ``cold`` (C,
    D), ``rows_cold`` (C,)) give its ``(max_nodes, D)`` plane; stacked tiers
    with a leading partition axis give the ``(P, max_nodes, D)`` stack in
    one pair of index copies.  The cold rows are cast to the hot dtype.
    Empty tiers (``hot_frac`` 0.0 and 1.0) copy nothing."""
    d = hot.shape[-1]
    if hot.dim() == 2:
        out = hot.new_zeros((max_nodes, d))
        out[rows_hot] = hot
        out[rows_cold] = cold.to(hot.dtype)
        return out
    P = hot.shape[0]
    out = hot.new_zeros((P, max_nodes, d))
    parts = torch.arange(P, device=hot.device)[:, None]
    out[parts, rows_hot] = hot
    out[parts, rows_cold] = cold.to(hot.dtype)
    return out


def reconstruct_features(fs: PartitionFeatStore, max_nodes: int) -> np.ndarray:
    """Host-side inverse of the split: the full (P, max_nodes, D) stack in
    the store's dtype, what the serving export hands to the export forward
    in place of the resident stack."""
    P, _, d = fs.hot.shape
    out = np.zeros((P, max_nodes, d), fs.hot.dtype)
    for p in range(P):
        out[p, fs.rows_hot[p]] = fs.hot[p]
        out[p, fs.rows_cold[p]] = fs.cold[p]
    return out


# ---------------------------------------------------------------------------
# global store (the DeviceEpochSampler's gather table)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GlobalFeatStore:
    """Score-split GLOBAL feature rows for the on-device epoch sampler.

    Batches gather through ``remap`` into the concatenated ``[hot | cold]``
    table: ``concat(hot, cold)[remap[i]] == features[i]`` bitwise for every
    global node id i (``remap`` is a permutation of ``range(N)`` split at
    ``Nh``).
    """

    hot: np.ndarray       # (Nh, D) target dtype, device-bound
    remap: np.ndarray     # (N,) int32 global id -> [hot | cold] slot
    cold: np.ndarray      # (Nc, D) target dtype, host-resident
    hot_ids: np.ndarray   # (Nh,) global ids in score order
    cold_ids: np.ndarray  # (Nc,)


def build_global_feat_store(graph, hot_frac: float, policy: str,
                            dtype) -> GlobalFeatStore:
    dtype = numpy_dtype(dtype)
    n = graph.num_nodes
    feats = np.asarray(graph.features, dtype)
    deg = np.maximum(np.diff(np.asarray(graph.indptr)), 1)
    is_train = np.zeros(n, bool)
    is_train[np.asarray(graph.train_idx)] = True
    order = hot_order(_scores(policy, deg, is_train))
    nh = _hot_count(hot_frac, n)
    hot_ids = order[:nh]
    cold_ids = order[nh:]
    remap = np.empty(n, np.int32)
    remap[hot_ids] = np.arange(nh, dtype=np.int32)
    remap[cold_ids] = nh + np.arange(n - nh, dtype=np.int32)
    return GlobalFeatStore(hot=feats[hot_ids], remap=remap,
                           cold=feats[cold_ids],
                           hot_ids=hot_ids, cold_ids=cold_ids)


# ---------------------------------------------------------------------------
# feature-memory budget (the bigger-than-device gate)
# ---------------------------------------------------------------------------

def feat_peak_bytes(num_parts: int, max_nodes: int, feat_dim: int,
                    itemsize: int, *, hot_rows: int | None = None,
                    cold_rows: int = 0, groups: int = 0) -> int:
    """Closed-form PEAK device feature bytes of a configuration.

    All-resident (``hot_rows is None``): the stacked plane itself,
    ``P * maxN * D * B``.

    Feat-store: the resident hot tier plus the worst transient, the staged
    cold rows and the assembled plane of every partition one eval
    materializes at once.  ``groups == 0`` (no streaming) assembles all P
    partitions together; ``groups == G`` streams the eval over G-partition
    groups, so only G cold buffers + G assembled planes exist at a time:

        P*H*D*B  +  G'*C*D*B  +  G'*maxN*D*B      with G' = G or P
    """
    b = int(itemsize)
    if hot_rows is None:
        return num_parts * max_nodes * feat_dim * b
    g = groups if groups else num_parts
    return (num_parts * hot_rows * feat_dim * b
            + g * cold_rows * feat_dim * b
            + g * max_nodes * feat_dim * b)


def check_feat_budget(budget_mb: float, peak_bytes: int,
                      context: str = "") -> None:
    """Refuse-to-build guard: raise :class:`FeatureBudgetError` when the
    configuration's peak feature bytes exceed ``budget_mb`` (<= 0 disables
    the check)."""
    if budget_mb <= 0:
        return
    budget = budget_mb * 1e6
    if peak_bytes > budget:
        raise FeatureBudgetError(
            f"peak device feature bytes {peak_bytes} exceed "
            f"feat_budget_mb={budget_mb:g} ({int(budget)} bytes)"
            + (f" [{context}]" if context else "")
            + "; enable feat_store / lower hot_frac / set feat_groups "
              "to stream the eval over partition groups")
