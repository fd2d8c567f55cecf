"""GP train steps — the paper's two synchronisation regimes over all P
partitions at once (counterpart of ``repro/core/gp/trainer.py``, its
stacked single-device form).

Phase 0 "generalize": data-parallel SGD on shared weights.  Each
partition's loss is computed on its own batch; the step descends the mean
of the P losses, whose gradient is the cross-partition gradient mean the
reference takes (``sum(grads) / P``), up to rounding.

Phase 1 "personalize": per-partition weights (leading axis P, see
``graph.sage.broadcast_to_partitions``), no cross-partition gradient
traffic; each partition descends its own loss plus the Eq. 4 proximal pull
toward the frozen W^G, and a per-partition ``active`` flag freezes
partitions whose budget is spent, bit for bit.

Compressed phase-0 gradient syncs (``grad_compress``): the reducers take
the P per-partition gradients stacked ``(P, ...)`` — the bucketed mean,
elementwise the plain ``sum / P``, and the top-k sparsified mean with
error feedback — and :func:`make_reduce_generalize_step` feeds them from
one backward through per-partition copies of the shared weights.

Steps update the params module in place (its tensors get the new values)
and return it with the new optimizer state; the reference returns new
pytrees.  A caller that keeps an earlier model takes a copy
(``graph.sage.clone_params``).  The single-partition phase-1 step
(:func:`make_personalize_partition_step`) serves the sequential oracle
(``engine.sequential.SequentialReference``), which runs it one partition
at a time.  On the partition mesh (one partition per rank) phase 0 runs
:func:`make_mesh_generalize_step`, whose gradient mean is a real
collective (or one of the per-shard reducers), and phase 1 the
single-partition step on each rank.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ...graph.sage import broadcast_to_partitions
from ...train.losses import cross_entropy_loss, focal_loss, prox_penalty
from ...train.optim import apply_updates

__all__ = ["GPHyperParams", "GRAD_COMPRESS_MODES", "make_generalize_step",
           "make_mesh_generalize_step",
           "make_reduce_generalize_step", "make_fullgraph_loss_fn",
           "make_personalize_step", "make_personalize_partition_step",
           "broadcast_to_partitions", "grad_topk_size",
           "grad_sync_wire_bytes", "make_bucketed_reduce_stacked",
           "make_topk_reduce_stacked", "make_grad_reduce_stacked",
           "make_bucketed_reduce_shard", "make_topk_reduce_shard"]


@dataclass(frozen=True)
class GPHyperParams:
    lambda_prox: float = 0.01      # Eq. 4 λ
    use_prox: bool = True


@torch.no_grad()
def _assign(params, values) -> None:
    for p, v in zip(params.parameters(), values, strict=True):
        p.copy_(v)


def make_generalize_step(loss_fn: Callable, optimizer) -> Callable:
    """Phase-0 step ``(params, opt_state, batch) -> (params, opt_state,
    losses)``.  ``loss_fn(params, batch)`` returns the ``(P,)``
    per-partition losses (or one scalar); the step descends their mean and
    returns them detached."""

    def step(params, opt_state, batch):
        weights = list(params.parameters())
        losses = loss_fn(params, batch)
        grads = torch.autograd.grad(losses.mean(), weights)
        updates, opt_state = optimizer.update(grads, opt_state, weights)
        _assign(params, apply_updates([w.detach() for w in weights], updates))
        return params, opt_state, losses.detach()

    return step


def make_mesh_generalize_step(loss_fn: Callable, optimizer, mesh,
                              gather_sum: bool = False, reduce=None,
                              topk: bool = False, lift=None) -> Callable:
    """Phase-0 step on the partition mesh, the reference's ``shard_map``
    step: ``(params, opt_state, batch[, residual]) -> (params, opt_state,
    loss[, residual])`` with ``batch`` this rank's partition and ``loss``
    its scalar loss.  Each
    rank differentiates its own loss (on the full graph the backward
    crosses the exchange, so every rank's gradient also holds its peers'
    losses through the rows it sent), then averages the gradients over
    the ranks before AdamW, whose ``grad_clip`` sees the mean, as in the
    reference.  The mean is a ``pmean`` (``engine.compat.pmean``: one
    all_reduce, summed in the collective's order), or with ``gather_sum``
    the reference's async spelling (``repro/engine/spmd.py``'s fused
    phase-0 program): ONE ``all_gather`` of every rank's gradients, then a
    sum in partition order, ``/ P`` — data movement and one deterministic
    reduction, the same on every rank.  ``reduce`` replaces the mean with
    a per-shard reducer of ``grad_compress``
    (:func:`make_bucketed_reduce_shard`, or with ``topk``
    :func:`make_topk_reduce_shard`, whose step also carries the rank's
    ``(N,)`` residual).  A reducer's step differentiates as the stacked
    reducer step does, on a partition axis of 1: the loss of a
    per-partition copy of the weights on ``lift(batch)`` (the rank's batch
    in the per-partition form), so a world of 1 is bitwise the stacked
    engine.  Replicated params stay replicated: every rank applies the
    same update."""
    from ...engine.compat import all_gather, pmean

    def mean(grads):
        if not gather_sum:
            return pmean(grads, mesh)
        out = []
        for g in all_gather(grads, mesh):          # (P, ...) each
            total = g[0]
            for q in range(1, mesh.world):
                total = total + g[q]
            out.append(total / mesh.world)
        return out

    def step(params, opt_state, batch, residual=None):
        weights = list(params.parameters())
        if reduce is None:
            loss = loss_fn(params, batch)
            grads = mean(torch.autograd.grad(loss, weights))
        else:
            per_part = broadcast_to_partitions(params, 1)
            losses = loss_fn(per_part, lift(batch))
            grads = [g[0] for g in torch.autograd.grad(
                losses.sum(), list(per_part.parameters()))]
            loss = losses.reshape(())
            if topk:
                grads, residual = reduce(grads, residual)
            else:
                grads = reduce(grads)
        updates, opt_state = optimizer.update(grads, opt_state, weights)
        _assign(params, apply_updates([w.detach() for w in weights], updates))
        if topk:
            return params, opt_state, loss.detach(), residual
        return params, opt_state, loss.detach()

    return step


def make_fullgraph_loss_fn(fwd: Callable, loss: str = "ce",
                           focal_gamma: float = 2.0) -> Callable:
    """Phase-0 loss over the FULL graph instead of a sampled minibatch.

    ``fwd(params, shards) -> (P, maxN, C)`` is the stacked distributed
    forward (halo exchange + the differentiable blocked aggregation op);
    the batch is ``{"shard", "labels", "train_mask"}`` with ``(P, ...)``
    entries.  Returns the ``(P,)`` per-partition losses, so
    :func:`make_generalize_step` drives it as it drives the sampled loss;
    gradients flow through the halo exchange into the partitions that sent
    the rows, and through the aggregation op's backward kernel into local
    ones.  With ``fwd`` one partition's forward (the partition mesh's
    :func:`~repro_torch.graph.distributed.make_shard_forward`), the batch
    holds that partition's arrays and the loss is its scalar loss."""

    def one(logits, lab, m):
        if loss == "focal":
            return focal_loss(logits, lab, gamma=focal_gamma, mask=m)
        return cross_entropy_loss(logits, lab, mask=m)

    def loss_fn(params, batch) -> torch.Tensor:
        logits = fwd(params, batch["shard"])
        if logits.dim() == 2:             # one partition (the mesh)
            return one(logits, batch["labels"], batch["train_mask"])
        return torch.stack([
            one(logits[p], batch["labels"][p], batch["train_mask"][p])
            for p in range(logits.shape[0])])

    return loss_fn


def make_personalize_step(loss_fn: Callable, optimizer,
                          hp: GPHyperParams = GPHyperParams()) -> Callable:
    """Phase-1 step over per-partition params:
    ``(pparams, opt_state, batch, global_params, active) -> (pparams,
    opt_state, losses (P,))``.  ``batch`` has a leading partition axis,
    ``opt_state`` comes from ``AdamW.init_stacked`` and ``active`` is a bool
    ``(P,)`` tensor; an inactive partition's params and optimizer state
    come back bitwise unchanged.  ``global_params`` (shared form) enters
    the prox term detached."""

    def step(pparams, opt_state, batch, global_params, active):
        weights = list(pparams.parameters())
        losses = loss_fn(pparams, batch)
        if hp.use_prox:
            gw = list(global_params.parameters())
            prox = torch.stack([prox_penalty([w[p] for w in weights], gw)
                                for p in range(losses.shape[0])])
            losses = losses + hp.lambda_prox * prox
        grads = torch.autograd.grad(losses.sum(), weights)
        new, opt_state = optimizer.step_stacked(
            grads, opt_state, [w.detach() for w in weights], active)
        _assign(pparams, new)
        return pparams, opt_state, losses.detach()

    return step


def make_personalize_partition_step(loss_fn: Callable, optimizer,
                                    hp: GPHyperParams = GPHyperParams(),
                                    inplace: bool = False) -> Callable:
    """SINGLE-partition phase-1 step, no leading partition axis anywhere:
    ``(params, opt_state, batch, global_params, active) -> (params,
    opt_state, loss)``.  ``params`` is a shared-form ``GraphSAGE`` (one
    partition's weights), ``opt_state`` comes from ``AdamW.init``, ``batch``
    is one partition's batch and ``active`` a bool (or 0-d bool tensor).
    The loss adds the Eq. 4 prox pull toward ``global_params``, which
    enters detached.  An inactive partition's params and optimizer state
    come back bitwise unchanged: the new values are selected, never
    multiplied by a gate (``p + 0.0`` flips the sign of ``-0.0``), as
    whole tensors on the host's reading of ``active`` (no third set of
    moments beside the old and the new).

    ``inplace`` steps the params and ``opt_state`` in place through
    ``optimizer.update_`` (bitwise the same values, without a second copy
    of the moments); the partition must then be active (``active`` True),
    and the ``opt_state`` passed in is consumed."""

    def step(params, opt_state, batch, global_params, active):
        if inplace and active is not True:
            raise ValueError("an in-place personalize step needs an active "
                             f"partition (active=True), got {active!r}")
        weights = list(params.parameters())
        loss = loss_fn(params, batch)
        if hp.use_prox:
            gw = [g.detach() for g in global_params.parameters()]
            loss = loss + hp.lambda_prox * prox_penalty(weights, gw)
        grads = torch.autograd.grad(loss, weights)
        if inplace:
            return params, optimizer.update_(list(grads), opt_state,
                                             weights), loss.detach()
        old = [w.detach() for w in weights]
        updates, new_state = optimizer.update(grads, opt_state, old)
        keep_new = bool(active)
        sel = lambda new, prev: new if keep_new else prev
        _assign(params, [sel(w + u, w) for w, u in zip(old, updates)])
        kept = type(opt_state)(
            step=sel(new_state.step, opt_state.step),
            mu=[sel(n, o) for n, o in zip(new_state.mu, opt_state.mu)],
            nu=[sel(n, o) for n, o in zip(new_state.nu, opt_state.nu)])
        return params, kept, loss.detach()

    return step


# ---------------------------------------------------------------------------
# compressed phase-0 gradient reduction
#
# The stacked forms of the reference's reducers take the (P, ...)
# per-partition gradients in ``parameters()`` order and return the mean
# gradient in one partition's shapes; the shard forms (the partition mesh:
# a bucketed reduce-scatter and all-gather, a top-k all_gather, each
# summed in partition order) take one rank's gradients and run the
# collectives.
# ---------------------------------------------------------------------------

GRAD_COMPRESS_MODES = ("none", "bucketed", "topk")


def grad_topk_size(param_count: int, frac: float) -> int:
    """Entries each partition ships per top-k sync (>= 1, <= param_count)."""
    return max(1, min(int(param_count), int(param_count * frac)))


def grad_sync_wire_bytes(mode: str, num_parts: int, param_count: int,
                         itemsize: int = 4, topk_frac: float = 0.01) -> int:
    """Bytes ONE phase-0 gradient synchronisation puts on the wire, summed
    over every partition (the per-step cost the pipeline accounts):

      none      the all_gather spelling ships each partition's full gradient
                to every peer: ``P * (P-1) * B``.
      bucketed  ring all-reduce (reduce-scatter + all-gather over static
                buckets): each rank moves ``2 * (P-1)/P * B``, fleet total
                ``2 * (P-1) * B`` — ``2/P`` of the all_gather spelling.
      topk      each partition all_gathers only its k largest entries as
                (value, int32 index) pairs: ``P * (P-1) * k * (itemsize+4)``.

    ``B = param_count * itemsize`` derives from the PAYLOAD dtype's itemsize
    (no hardcoded fp32 assumption).
    """
    P = int(num_parts)
    if P <= 1:
        return 0
    B = int(param_count) * int(itemsize)
    if mode == "none":
        return P * (P - 1) * B
    if mode == "bucketed":
        return 2 * (P - 1) * B
    if mode == "topk":
        k = grad_topk_size(param_count, topk_frac)
        return P * (P - 1) * k * (int(itemsize) + 4)
    raise ValueError(f"unknown grad compression mode {mode!r} "
                     f"(expected one of {GRAD_COMPRESS_MODES})")


def _flat_stacked(grads_stacked):
    """``(P, ...)`` gradients in ``parameters()`` order -> ``((P, N) flat
    matrix, unravel)``, ``unravel`` mapping an ``(N,)`` vector back to one
    partition's shapes.  A ``GraphSAGE``'s parameters run layer by layer,
    ``w_self``, ``w_neigh``, ``b``, each row-major: ``ravel_pytree``'s leaf
    order over the reference's ``SAGEParams``, which fixes the residual's
    layout and top-k's tie order."""
    P = grads_stacked[0].shape[0]
    shapes = [tuple(g.shape[1:]) for g in grads_stacked]
    sizes = [int(np.prod(s, dtype=np.int64)) for s in shapes]
    flat = torch.cat([g.reshape(P, -1) for g in grads_stacked], dim=1)

    def unravel(v: torch.Tensor) -> list[torch.Tensor]:
        return [c.reshape(s) for c, s in zip(torch.split(v, sizes), shapes)]

    return flat, unravel


def _bucket_slices(n: int, bucket_bytes: int, itemsize: int):
    be = max(1, int(bucket_bytes) // max(1, int(itemsize)))
    return [(lo, min(lo + be, n)) for lo in range(0, n, be)]


def make_bucketed_reduce_stacked(num_parts: int, bucket_bytes: int):
    """Bucketed mean over stacked ``(P, ...)`` gradients.  Elementwise this
    IS the plain ``sum(axis=0) / P`` (bucketing a per-element reduction
    changes nothing), so the stacked bucketed mode stays bitwise with mode
    none's stack-and-sum."""

    def reduce(grads_stacked):
        flat, unravel = _flat_stacked(grads_stacked)
        chunks = [flat[:, lo:hi].sum(dim=0)
                  for lo, hi in _bucket_slices(flat.shape[1], bucket_bytes,
                                               flat.element_size())]
        total = chunks[0] if len(chunks) == 1 else torch.cat(chunks)
        return unravel(total / num_parts)

    return reduce


def _flat(grads):
    """One partition's gradients in ``parameters()`` order -> ``((N,) flat
    vector, unravel)``, ``ravel_pytree``'s layout (:func:`_flat_stacked`
    without the partition axis)."""
    flat, unravel = _flat_stacked([g[None] for g in grads])
    return flat[0], unravel


def make_bucketed_reduce_shard(num_parts: int, mesh, bucket_bytes: int):
    """Per-shard bucketed all-reduce on the partition mesh: the rank's
    gradients flattened once and each :func:`_bucket_slices` slice reduced
    as a ring all-reduce is, in two collectives.  The slice, zero-padded to
    a multiple of P, is cut into P pieces; ONE ``all_to_all`` hands piece q
    of every rank to rank q (the reduce-scatter), which sums its ``(P, n/P)``
    rows in partition order (the stacked reducer's ``sum(dim=0)``); ONE
    ``all_gather`` of the summed pieces rebuilds the slice; then ``/ P``.
    That is the stacked bucketed mean, bitwise where the ranks' gradients
    are the stacked engine's (a ``psum`` sums in the collective's order,
    and phase 1's AdamW grows that rounding into a 4-epoch params drift
    past the reference's 1e-5).  Each rank sends ``2 (P-1)/P`` of the
    padded slice, the ring's closed form of :func:`grad_sync_wire_bytes`
    plus fewer than P padding entries a slice."""
    from ...engine.compat import all_gather, all_to_all

    P = int(num_parts)

    def reduce_slice(v):
        n = v.shape[0]
        piece = -(-n // P)
        sent = v.new_zeros(P * piece)
        sent[:n] = v
        mine = all_to_all(sent.view(P, piece), mesh).sum(dim=0)
        return all_gather([mine], mesh)[0].reshape(-1)[:n]

    def reduce(grads):
        flat, unravel = _flat(grads)
        chunks = [reduce_slice(flat[lo:hi])
                  for lo, hi in _bucket_slices(flat.shape[0], bucket_bytes,
                                               flat.element_size())]
        total = chunks[0] if len(chunks) == 1 else torch.cat(chunks)
        return unravel(total / num_parts)

    return reduce


def make_topk_reduce_shard(num_parts: int, mesh, topk_frac: float):
    """Per-shard top-k reducer with error feedback on the partition mesh:
    ``reduce(grads, residual) -> (mean grads, new residual)``, ``residual``
    the rank's ``(N,)`` error.  The rank keeps its k largest
    error-compensated entries (:func:`_topk_sent`), ONE ``all_gather``
    brings every rank's ``(N,)`` vector, and the ``(P, N)`` stack is summed
    in partition order, ``/ P``: the stacked reducer's sum over the same
    rows."""
    from ...engine.compat import all_gather

    def reduce(grads, residual):
        flat, unravel = _flat(grads)
        k = grad_topk_size(flat.shape[0], topk_frac)
        g_ef = flat + residual.to(flat.dtype)
        sent = _topk_sent(g_ef, k)
        new_res = (g_ef - sent).to(residual.dtype)
        every = all_gather([sent], mesh)[0]                # (P, N)
        return unravel(every.sum(dim=0) / num_parts), new_res

    return reduce


def _topk_sent(g_ef: torch.Tensor, k: int) -> torch.Tensor:
    """Keep each row's k largest-|.| entries, zero elsewhere.  Ties go to
    the lower index, as ``lax.top_k`` breaks them: a stable descending
    sort keeps equal magnitudes in index order (``torch.topk`` leaves the
    order of ties unspecified)."""
    idx = torch.sort(g_ef.abs(), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    return torch.zeros_like(g_ef).scatter(-1, idx, g_ef.gather(-1, idx))


def make_topk_reduce_stacked(num_parts: int, topk_frac: float):
    """Top-k sparsified mean with error feedback over stacked ``(P, ...)``
    gradients: ``reduce(grads_stacked, residual) -> (mean grads, new
    residual)``, ``residual`` the carried ``(P, N)`` per-partition error.
    k comes from the flat length, and the selection is deterministic, so
    the compressed step is bit-reproducible."""

    def reduce(grads_stacked, residual):
        flat, unravel = _flat_stacked(grads_stacked)
        k = grad_topk_size(flat.shape[1], topk_frac)
        g_ef = flat + residual.to(flat.dtype)
        sent = _topk_sent(g_ef, k)
        new_res = (g_ef - sent).to(residual.dtype)
        return unravel(sent.sum(dim=0) / num_parts), new_res

    return reduce


def make_grad_reduce_stacked(mode: str, num_parts: int,
                             topk_frac: float = 0.01,
                             bucket_kb: int = 512):
    """The stacked reducer of ``mode``: the plain mean (``sum / P``), the
    bucketed mean over ``bucket_kb`` KiB slices, or the top-k reducer
    (which also takes and returns the residual)."""
    if mode == "bucketed":
        return make_bucketed_reduce_stacked(num_parts, bucket_kb * 1024)
    if mode == "topk":
        return make_topk_reduce_stacked(num_parts, topk_frac)
    if mode == "none":
        return lambda grads: [g.sum(dim=0) / num_parts for g in grads]
    raise ValueError(f"unknown grad_compress {mode!r} "
                     f"(expected one of {GRAD_COMPRESS_MODES})")


def make_reduce_generalize_step(loss_fn: Callable, optimizer, num_parts: int,
                                reduce: Callable, topk: bool) -> Callable:
    """Phase-0 step through a reducer of the P per-partition gradients:
    ``(params, opt_state, batch[, residual]) -> (params, opt_state,
    losses[, residual])`` (the residual with ``topk``).

    One forward and one backward over per-partition copies of the shared
    weights (``broadcast_to_partitions``) give the ``(P, ...)`` gradients
    ``reduce`` turns into the mean gradient the optimizer applies.  On a
    sampled batch row p is ``d loss_p / d W``, the reference's per-shard
    ``value_and_grad``.  On a full-graph batch a halo row carries its
    sender's weights, so row q is the gradient reaching copy q (its own
    loss's and its peers' through the rows it sent); the rows still sum to
    ``d (sum_p loss_p) / d W``, which is all the bucketed mean reads (the
    reference refuses top-k there)."""

    def step(params, opt_state, batch, residual=None):
        weights = [w.detach() for w in params.parameters()]
        per_part = broadcast_to_partitions(params, num_parts)
        losses = loss_fn(per_part, batch)
        grads = torch.autograd.grad(losses.sum(), list(per_part.parameters()))
        if topk:
            grads, residual = reduce(grads, residual)
        else:
            grads = reduce(grads)
        updates, opt_state = optimizer.update(grads, opt_state, weights)
        _assign(params, apply_updates(weights, updates))
        if topk:
            return params, opt_state, losses.detach(), residual
        return params, opt_state, losses.detach()

    return step

