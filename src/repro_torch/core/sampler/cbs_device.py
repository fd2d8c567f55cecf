"""Device-side epoch sampling: Eq. 3 probabilities and the epoch draw as
torch ops on the card, for both training phases (counterpart of
``repro/core/sampler/cbs_device.py``).

``core/sampler/cbs.py`` keeps the host NumPy sampler; this module draws the
same distributions with a ``torch.Generator`` on the engine's device, so an
async epoch (subset resample, batch shuffle, fanout sampling, feature
gather) ships no batch from the host.  One :class:`DeviceEpochSampler`
serves both phases: phase 1's CBS mini-epoch is ``class_balanced=True``;
phase 0 draws the same program, the Eq. 3 mini-epoch with CBS on or, with
``class_balanced=False``, a uniform shuffle of the whole local train set
(flat log-probabilities make the Gumbel top-k ranking a uniform
permutation).

Pieces:

  · :func:`eq3_column_norms`, :func:`cbs_probabilities_device`: Eq. 3 over
    ``train_idx`` in the dtype asked for (float64 matches the NumPy
    ``cbs_probabilities`` to ~1e-12).  The column sums run per CSR row
    (``segment_reduce``), a fixed order, so two builds give bitwise the same
    probabilities on the card.
  · :func:`gumbel_subset`: a weighted draw without replacement (Gumbel
    top-k) along the last axis; any leading axes are independent rows.
  · :func:`device_fanout`: uniform with-replacement neighbour picks over
    the global CSR, a modular pick inside each node's span; isolated nodes
    self-loop (the host ``NeighborSampler``'s contract).
  · :class:`DeviceEpochSampler`: the stacked per-partition state (padded
    train sets, log Eq. 3 rows, mini-epoch sizes) and the global CSR,
    features (or, under the two-tier feature store, the hot rows, the
    ``remap`` into ``[hot | cold]`` and the host cold rows) and labels, with
    :meth:`~DeviceEpochSampler.draw_epoch` and
    :meth:`~DeviceEpochSampler.make_batch` over all P partitions at once
    (``rows=`` cuts a batch to one partition's row after the fanouts).

The reference's PRNG streams (jax keys) cannot be reproduced in torch, so
the draws agree with it in distribution, not bitwise: the tests hold them
to the reference's statistical thresholds.  :func:`device_draw_count`
counts epoch draws made here, so a test can tell the device path ran, as
``cbs.host_draw_count`` tells the host path did not.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...device import resolve_device
from ...graph.featstore import build_global_feat_store, host_staging

__all__ = [
    "cbs_probabilities_device",
    "eq3_column_norms",
    "gumbel_subset",
    "device_fanout",
    "DeviceEpochSampler",
    "build_device_epoch_sampler",
    "device_draw_count",
    "reset_device_draw_count",
]

_DEVICE_DRAWS = 0
# the fanout's uniform ints lie in [0, 2^31 - 1), as the reference's
# int32 randint; the pick is their residue modulo the degree
_RAND_HI = 2 ** 31 - 1


def device_draw_count() -> int:
    """How many epoch draws :meth:`DeviceEpochSampler.draw_epoch` has made
    (one per call, whatever the number of partitions)."""
    return _DEVICE_DRAWS


def reset_device_draw_count() -> None:
    global _DEVICE_DRAWS
    _DEVICE_DRAWS = 0


def _as_index(a, device=None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device or a.device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


def eq3_column_norms(indptr, indices, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """``||Â(:,v)||² = d_v · Σ_{u∈N(v)} 1/d_u`` for every node, in
    ``dtype``: the train-set-independent half of Eq. 3, computed once and
    shared by all partitions."""
    indptr = _as_index(indptr, device)
    indices = _as_index(indices, indptr.device)
    counts = indptr[1:] - indptr[:-1]
    deg = counts.to(dtype).clamp_min(1.0)
    d_isqrt = 1.0 / torch.sqrt(deg)
    d_sqrt = torch.sqrt(deg)
    if indices.numel() == 0:
        col_sq = torch.zeros_like(deg)
    else:
        # CSR slots are grouped by their row, so a per-row sum in slot order
        col_sq = torch.segment_reduce(d_isqrt[indices] ** 2, "sum",
                                      lengths=counts)
    return col_sq * d_sqrt ** 2


def cbs_probabilities_device(indptr, indices, labels, train_idx,
                             col_sq=None, dtype=torch.float32,
                             device=None) -> torch.Tensor:
    """Eq. 3 sampling probabilities over ``train_idx``:
    ``P(v) ∝ ||Â(:,v)||² / CF(class[v])``, uniform where the mass is zero.
    ``col_sq`` (a precomputed :func:`eq3_column_norms`) sets the dtype and
    device when given, else ``dtype`` and ``device`` do."""
    if col_sq is None:
        col_sq = eq3_column_norms(indptr, indices, dtype, device)
    dev = col_sq.device
    labels = _as_index(labels, dev)
    train_idx = _as_index(train_idx, dev)
    train_labels = labels[train_idx]
    cf = torch.bincount(train_labels).to(col_sq.dtype) if train_labels.numel() \
        else torch.zeros(1, dtype=col_sq.dtype, device=dev)
    p = col_sq[train_idx] / cf[train_labels].clamp_min(1.0)
    s = p.sum()
    uniform = torch.full_like(p, 1.0 / max(1, train_idx.numel()))
    return torch.where(s > 0, p / torch.where(s > 0, s, 1.0), uniform)


def gumbel_subset(gen: torch.Generator, logp: torch.Tensor,
                  subset_size: int) -> torch.Tensor:
    """Positions of a weighted draw WITHOUT replacement of ``subset_size``
    slots from ``exp(logp)`` along the last axis (Gumbel top-k).  The noise
    is ``-log(E)``, E ~ Exponential(1) from ``gen``, which is finite for
    every draw (``-log(-log(U))`` is infinite at U = 0), so ``-inf`` entries
    (padding, zero-probability nodes) stay ``-inf`` and sort last."""
    e = torch.empty(logp.shape, dtype=torch.float32,
                    device=logp.device).exponential_(generator=gen)
    keys = logp.to(torch.float32) - torch.log(e)
    order = torch.argsort(keys, dim=-1, descending=True, stable=True)
    return order[..., :subset_size]


def device_fanout(gen: torch.Generator, nodes: torch.Tensor,
                  indptr: torch.Tensor, indices: torch.Tensor,
                  fanout: int) -> torch.Tensor:
    """``fanout`` uniform with-replacement neighbours of every node over the
    global CSR, shape ``nodes.shape + (fanout,)``: a uniform int in
    ``[0, 2^31 - 1)`` modulo ``max(deg, 1)`` inside the node's CSR span;
    isolated nodes pick themselves."""
    start = indptr[nodes]
    deg = indptr[nodes + 1] - start
    r = torch.randint(0, _RAND_HI, nodes.shape + (fanout,), generator=gen,
                      device=nodes.device)
    if indices.numel() == 0:
        return nodes[..., None].expand(r.shape).clone()
    has = (deg > 0)[..., None]
    # an isolated node's span is empty: read slot 0 and discard it
    offs = torch.where(has, start[..., None] + r % deg.clamp_min(1)[..., None],
                       0)
    return torch.where(has, indices[offs], nodes[..., None])


@dataclass(frozen=True)
class DeviceEpochSampler:
    """Stacked per-partition sampler state on the device.

    ``train_idx``, ``logp`` and ``k`` carry a leading partition axis P;
    the global CSR, features and labels are shared by all partitions (a
    neighbour in another partition is fetched as the host sampler fetches
    it).  One instance drives phase 1's async mini-epochs and phase 0's
    async epochs; every epoch draws afresh from the generator it is given,
    and within one epoch each valid train index is visited at most once.

    Under the two-tier feature store ``features`` is None: ``hot_feats``
    holds the hot rows on the device, ``cold_host`` the cold rows on the host
    (pinned on a CUDA build; the caller stages them once per epoch call),
    and batches gather through ``remap`` into ``[hot | cold]``, bitwise the
    resident gather (the table is a permutation of the feature rows).
    """

    indptr: torch.Tensor     # (N+1,) int64
    indices: torch.Tensor    # (E,)  int64
    features: torch.Tensor | None   # (N, D); None under the feature store
    labels: torch.Tensor     # (N,)  int32
    train_idx: torch.Tensor  # (P, T) int64 global ids, 0-padded
    logp: torch.Tensor       # (P, T) float32 log Eq. 3, -inf on padding
    k: torch.Tensor          # (P,)  int64 per-partition mini-epoch size
    subset_size: int         # K = max_p k_p
    batch_size: int
    num_batches: int         # I = ceil(K / B)
    fanouts: tuple
    natural_iters: np.ndarray = None   # host (P,): ceil(k_p / B), budgets
    hot_feats: torch.Tensor | None = None   # (Nh, D) resident hot rows
    remap: torch.Tensor | None = None       # (N,) int64 id -> [hot | cold]
    cold_host: torch.Tensor | None = None   # (Nc, D) host cold rows

    @property
    def nbytes(self) -> int:
        """Bytes staged on the device (what building the sampler ships):
        the features, or under the store the hot rows and ``remap``."""
        feats = ((self.features,) if self.features is not None
                 else (self.hot_feats, self.remap))
        return sum(t.numel() * t.element_size() for t in (
            self.indptr, self.indices, *feats, self.labels,
            self.train_idx, self.logp, self.k))

    def feature_table(self, cold: torch.Tensor | None = None) -> torch.Tensor:
        """The table batches gather from: ``features``, or under the store
        ``[hot | cold]`` with ``cold`` the staged cold rows (cast to the hot
        dtype).  ``cold`` must be given exactly when the sampler was built
        with the store."""
        if (cold is None) != (self.cold_host is None):
            raise ValueError(
                "feat-store mismatch: pass cold= exactly when the sampler "
                "was built with feat_store=True")
        if cold is None:
            return self.features
        return torch.cat([self.hot_feats, cold.to(self.hot_feats.dtype)])

    def draw_epoch(self, gen: torch.Generator, logp=None, train_idx=None,
                   k=None):
        """One epoch's batch nodes for every row: a Gumbel top-k subset (a
        uniform permutation when the row's log-probabilities are flat), then
        a uniform shuffle inside the valid prefix only, padded to ``(I, B)``
        a row.  Returns ``(nodes, valid)``, each ``(R, I, B)``.  The rows are
        the sampler's P partitions unless ``logp``, ``train_idx`` and ``k``
        give another stacked row set (``(R, T)``, ``(R, T)``, ``(R,)``)."""
        global _DEVICE_DRAWS
        _DEVICE_DRAWS += 1
        logp = self.logp if logp is None else logp
        train_idx = self.train_idx if train_idx is None else train_idx
        k = self.k if k is None else k
        K, B, I = self.subset_size, self.batch_size, self.num_batches
        rows = logp.shape[0]
        pick = gumbel_subset(gen, logp, K)                      # (R, K)
        nodes = torch.gather(train_idx, 1, pick)
        valid = torch.arange(K, device=logp.device)[None, :] < k[:, None]
        # shuffle WITHIN the valid prefix: a partition whose k is below the
        # fleet-wide K keeps its real nodes packed in the leading slots, so
        # its natural_iters budgeted batches cover exactly its own mini-epoch
        r = torch.rand((rows, K), generator=gen, device=logp.device)
        order = torch.argsort(torch.where(valid, r, r + 2.0), dim=1,
                              stable=True)
        nodes = torch.gather(nodes, 1, order)
        valid = torch.gather(valid, 1, order)
        pad = I * B - K
        nodes = torch.nn.functional.pad(nodes, (0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
        return nodes.view(rows, I, B), valid.view(rows, I, B)

    def make_batch(self, gen: torch.Generator, nodes: torch.Tensor,
                   valid: torch.Tensor, cold: torch.Tensor | None = None, *,
                   table: torch.Tensor | None = None, rows=None) -> dict:
        """One training batch from ``nodes``/``valid`` (``(..., B)``, e.g.
        ``(P, B)``): the two-hop fanout and the feature gather, as the
        pipeline's host ``make_batch`` builds it: ``x_t (..., B, D)``,
        ``x_1 (..., B, f1, D)``, ``x_2 (..., B, f1, f2, D)``, ``labels``
        (int32, -1 where the slot is not valid) and a float ``mask``.

        The gather reads ``table`` when given (a :meth:`feature_table`
        built once per epoch call), else :meth:`feature_table` of ``cold``
        (the staged cold rows, exactly when the sampler was built with the
        store); under the store it goes through ``remap``.

        ``rows`` (an index or slice of the leading axis) cuts the batch to
        those rows AFTER both fanouts ran over all of them, so the
        generator advances as it does for the whole batch and the rows are
        bitwise the whole batch's: a rank of the partition mesh builds its
        partition's row of the stacked batch this way."""
        feats = table if table is not None else self.feature_table(cold)
        gather = ((lambda ix: feats[ix]) if self.remap is None
                  else (lambda ix: feats[self.remap[ix]]))
        f1, f2 = self.fanouts
        nbrs1 = device_fanout(gen, nodes, self.indptr, self.indices, f1)
        nbrs2 = device_fanout(gen, nbrs1.flatten(-2), self.indptr,
                              self.indices, f2)
        if rows is not None:
            nodes, valid = nodes[rows], valid[rows]
            nbrs1, nbrs2 = nbrs1[rows], nbrs2[rows]
        return {"x_t": gather(nodes), "x_1": gather(nbrs1),
                "x_2": gather(nbrs2).view(*nbrs1.shape, f2, feats.shape[-1]),
                "labels": torch.where(valid, self.labels[nodes], -1),
                "mask": valid.to(feats.dtype)}


def build_device_epoch_sampler(graph, host_train, num_parts: int, *,
                               batch_size: int, subset_fraction: float = 0.25,
                               class_balanced: bool = True,
                               fanouts: tuple = (10, 10),
                               dtype=torch.float32,
                               feat_store: bool = False,
                               hot_frac: float = 0.5,
                               hot_policy: str = "degree",
                               device="cuda") -> DeviceEpochSampler:
    """Stage a :class:`DeviceEpochSampler` from a CSR graph (``indptr``,
    ``indices``, ``features``, ``labels``) and the per-partition train
    sets.  Mini-epoch sizes mirror ``CBSampler.mini_epoch_size``, so the
    budgets (``natural_iters``) match the host sampler's batch counts; with
    ``class_balanced=False`` every partition's epoch is its whole local
    train set drawn as a uniform permutation (the phase-0 plain epoch).

    With ``feat_store=True`` the (N, D) features are NOT staged: the top
    ``hot_frac`` of the rows by ``hot_policy`` score go to the device
    (``hot_feats``) and the rest stay on the host (``cold_host``, pinned on
    a CUDA device) for the engine to stage once per epoch call; batches
    gather through ``remap`` into ``[hot | cold]``."""
    dev = resolve_device(device)
    t_max = max(1, max(len(t) for t in host_train))
    train_pad = np.zeros((num_parts, t_max), np.int64)
    logp = np.full((num_parts, t_max), -np.inf, np.float32)
    ks = np.zeros(num_parts, np.int64)
    # the O(E) graph pass of Eq. 3 does not depend on the train set
    col_sq = (eq3_column_norms(graph.indptr, graph.indices, torch.float32,
                               dev) if class_balanced else None)
    for p in range(num_parts):
        t = np.asarray(host_train[p])
        if len(t) == 0:
            continue
        train_pad[p, : len(t)] = t
        if class_balanced:
            probs = cbs_probabilities_device(
                graph.indptr, graph.indices, graph.labels, t,
                col_sq=col_sq).cpu().numpy()
            size = max(batch_size, int(len(t) * subset_fraction))
        else:
            probs = np.full(len(t), 1.0 / len(t))
            size = len(t)
        with np.errstate(divide="ignore"):
            logp[p, : len(t)] = np.log(probs)
        # a draw without replacement cannot exceed the positive-probability
        # support: cap the mini-epoch there, so a zero-probability node is
        # never trained on
        support = int((probs > 0).sum())
        ks[p] = min(size, len(t), max(support, 0))
    subset_size = int(ks.max()) if ks.max() > 0 else batch_size
    num_batches = max(1, -(-subset_size // batch_size))
    natural = np.maximum(1, -(-ks // batch_size)).astype(np.int32)
    natural[ks == 0] = 0
    if feat_store:
        gfs = build_global_feat_store(graph, hot_frac, hot_policy, dtype)
        feat_kw = dict(features=None,
                       hot_feats=torch.as_tensor(gfs.hot, device=dev),
                       remap=_as_index(gfs.remap, dev),
                       cold_host=host_staging(gfs.cold, dev))
    else:
        feat_kw = dict(features=torch.as_tensor(np.asarray(graph.features),
                                                dtype=dtype, device=dev))
    return DeviceEpochSampler(
        indptr=_as_index(graph.indptr, dev),
        indices=_as_index(graph.indices, dev),
        labels=torch.as_tensor(np.asarray(graph.labels, np.int32),
                               device=dev),
        train_idx=torch.as_tensor(train_pad, device=dev),
        logp=torch.as_tensor(logp, device=dev),
        k=torch.as_tensor(ks, device=dev),
        subset_size=subset_size,
        batch_size=batch_size,
        num_batches=num_batches,
        fanouts=tuple(fanouts),
        natural_iters=natural,
        **feat_kw,
    )
