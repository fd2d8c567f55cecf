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

Steps update the params module in place (its tensors get the new values)
and return it with the new optimizer state; the reference returns new
pytrees.  A caller that keeps an earlier model takes a copy
(``graph.sage.clone_params``).  The single-partition phase-1 step
(:func:`make_personalize_partition_step`) serves the sequential oracle
(``engine.sequential.SequentialReference``), which runs it one partition
at a time.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ...graph.sage import broadcast_to_partitions
from ...train.losses import cross_entropy_loss, focal_loss, prox_penalty
from ...train.optim import apply_updates

__all__ = ["GPHyperParams", "make_generalize_step", "make_fullgraph_loss_fn",
           "make_personalize_step", "make_personalize_partition_step",
           "broadcast_to_partitions",
           "grad_sync_wire_bytes"]


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
    ones."""

    def loss_fn(params, batch) -> torch.Tensor:
        logits = fwd(params, batch["shard"])
        out = []
        for p in range(logits.shape[0]):
            lab, m = batch["labels"][p], batch["train_mask"][p]
            if loss == "focal":
                out.append(focal_loss(logits[p], lab, gamma=focal_gamma,
                                      mask=m))
            else:
                out.append(cross_entropy_loss(logits[p], lab, mask=m))
        return torch.stack(out)

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
                                    hp: GPHyperParams = GPHyperParams()
                                    ) -> Callable:
    """SINGLE-partition phase-1 step, no leading partition axis anywhere:
    ``(params, opt_state, batch, global_params, active) -> (params,
    opt_state, loss)``.  ``params`` is a shared-form ``GraphSAGE`` (one
    partition's weights), ``opt_state`` comes from ``AdamW.init``, ``batch``
    is one partition's batch and ``active`` a bool (or 0-d bool tensor).
    The loss adds the Eq. 4 prox pull toward ``global_params``, which
    enters detached.  An inactive partition's params and optimizer state
    come back bitwise unchanged: the new values are selected with
    ``torch.where``, never multiplied by a gate (``p + 0.0`` flips the sign
    of ``-0.0``)."""

    def step(params, opt_state, batch, global_params, active):
        weights = list(params.parameters())
        loss = loss_fn(params, batch)
        if hp.use_prox:
            gw = [g.detach() for g in global_params.parameters()]
            loss = loss + hp.lambda_prox * prox_penalty(weights, gw)
        grads = torch.autograd.grad(loss, weights)
        old = [w.detach() for w in weights]
        updates, new_state = optimizer.update(grads, opt_state, old)
        act = torch.as_tensor(active, dtype=torch.bool, device=old[0].device)
        sel = lambda new, prev: torch.where(act, new, prev)
        _assign(params, [sel(w + u, w) for w, u in zip(old, updates)])
        kept = type(opt_state)(
            step=sel(new_state.step, opt_state.step),
            mu=[sel(n, o) for n, o in zip(new_state.mu, opt_state.mu)],
            nu=[sel(n, o) for n, o in zip(new_state.nu, opt_state.nu)])
        return params, kept, loss.detach()

    return step


def grad_sync_wire_bytes(mode: str, num_parts: int, param_count: int,
                         itemsize: int = 4) -> int:
    """Bytes one phase-0 gradient synchronisation puts on the wire, summed
    over every partition: the all_gather spelling ships each partition's
    full gradient to every peer, ``P * (P-1) * param_count * itemsize``.
    Only ``mode="none"`` is ported (compressed syncs: ROADMAP item 10)."""
    if mode != "none":
        raise NotImplementedError(
            f"gradient compression {mode!r} is not ported yet (ROADMAP "
            "item 10)")
    P = int(num_parts)
    if P <= 1:
        return 0
    return P * (P - 1) * int(param_count) * int(itemsize)
