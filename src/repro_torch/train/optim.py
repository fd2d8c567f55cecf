"""AdamW, hand-ported as functions on lists of tensors (counterpart of
``repro/train/optim.py``; not ``torch.optim.AdamW``, whose spelling
differs).

``init(params) -> OptState`` and ``update(grads, state, params) ->
(updates, state)`` keep the reference's contract: ``updates`` are deltas to
add to the params, the step counter is int32, and the update is spelled
``-lr·(m·mu_hat)/(sqrt(v·nu_hat)+eps)`` with a linear warmup.  Every list
follows ``module.parameters()`` order.

The per-partition form (phase 1) works on params with a leading partition
axis: :meth:`AdamW.init_stacked` gives a ``(P,)`` step counter and
:meth:`AdamW.step_stacked` clips each partition by its own global norm and
advances only the active partitions; inactive ones are selected with
``torch.where`` (``p + 0.0`` would flip a ``-0.0``), so they come back
bitwise unchanged, optimizer state included.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["OptState", "AdamW", "global_norm", "sum_of_squares",
           "clip_by_global_norm",
           "apply_updates", "opt_state_from_numpy"]


class OptState(NamedTuple):
    step: torch.Tensor          # int32, () or (P,) in the per-partition form
    mu: list[torch.Tensor]      # first moment, float32
    nu: list[torch.Tensor]      # second moment, float32


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum_of_squares(tensors))


def _is_dtensor(t) -> bool:
    return type(t).__name__ == "DTensor"


def sum_of_squares(tensors) -> torch.Tensor:
    """``Σ_t Σ t²`` in float32 over the tensors, in their order.  For
    DTensors (the sharded LLM steps' gradients and weights) the full
    tensors' sum, never a shard's: each tensor's local sum of squares is
    its part of a sum over the mesh dims that shard it; those of one set of
    sharded dims are all-reduced together (one collective a set), then
    summed in the tensors' order; a plain scalar, the same on every rank,
    differentiable in the tensors."""
    tensors = list(tensors)
    if not (tensors and _is_dtensor(tensors[0])):
        return sum(torch.sum(torch.square(t.to(torch.float32)))
                   for t in tensors)
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = tensors[0].device_mesh
    sq = [torch.sum(torch.square(t.to_local().to(torch.float32)))
          for t in tensors]
    groups: dict[tuple, list[int]] = {}
    for i, t in enumerate(tensors):
        key = tuple(not p.is_replicate() and mesh.size(d) > 1
                    for d, p in enumerate(t.placements))
        groups.setdefault(key, []).append(i)
    full = list(sq)
    for key, idx in groups.items():
        if not any(key):
            continue
        part = DTensor.from_local(
            torch.stack([sq[i] for i in idx]), mesh,
            [Partial() if k else Replicate() for k in key], run_check=False)
        tot = part.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
        for j, i in enumerate(idx):
            full[i] = tot[j]
    return sum(full)


def clip_by_global_norm(tensors, max_norm: float) -> list[torch.Tensor]:
    tensors = list(tensors)
    scale = torch.clamp_max(max_norm / (global_norm(tensors) + 1e-9), 1.0)
    return [t * scale for t in tensors]


def apply_updates(params, updates) -> list[torch.Tensor]:
    return [p + u for p, u in zip(params, updates, strict=True)]


def _per_part(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A ``(P,)`` vector shaped to broadcast against ``(P, ...)``."""
    return v.view(v.shape[0], *(1,) * (like.dim() - 1))


@dataclass(frozen=True)
class AdamW:
    """AdamW with decoupled weight decay and linear-warmup-constant LR."""

    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    warmup_steps: int = 0
    grad_clip: float | None = None

    def init(self, params) -> OptState:
        params = list(params)
        zeros = lambda: [torch.zeros_like(p, dtype=torch.float32)
                         for p in params]
        return OptState(step=torch.zeros((), dtype=torch.int32,
                                         device=params[0].device),
                        mu=zeros(), nu=zeros())

    def init_stacked(self, params) -> OptState:
        """State of per-partition params (leading axis P on every leaf)."""
        params = list(params)
        st = self.init(params)
        P = params[0].shape[0]
        return st._replace(step=torch.zeros((P,), dtype=torch.int32,
                                            device=st.step.device))

    def _lr_at(self, step: torch.Tensor) -> torch.Tensor:
        lr = torch.full(step.shape, self.lr, dtype=torch.float32,
                        device=step.device)
        if self.warmup_steps <= 0:
            return lr
        frac = torch.clamp_max((step + 1) / self.warmup_steps, 1.0)
        return lr * frac

    def _moments(self, grads, state: OptState, step, lr, params, shape):
        b1, b2 = self.b1, self.b2
        mu = [b1 * m + (1 - b1) * g.to(torch.float32)
              for m, g in zip(state.mu, grads, strict=True)]
        nu = [b2 * v + (1 - b2) * torch.square(g.to(torch.float32))
              for v, g in zip(state.nu, grads, strict=True)]
        mu_hat_scale, nu_hat_scale = self._bias_scales(step)

        def upd(m, v, p):
            return self._delta(m, v, p, shape(lr, p), shape(mu_hat_scale, p),
                               shape(nu_hat_scale, p))

        return [upd(m, v, p) for m, v, p in zip(mu, nu, params)], mu, nu

    def _bias_scales(self, step):
        t = step.to(torch.float32)
        return 1.0 / (1.0 - self.b1 ** t), 1.0 / (1.0 - self.b2 ** t)

    def _delta(self, m, v, p, lr, muh, nuh):
        """One leaf's update from its new moments, in p's dtype."""
        u = -lr * (m * muh) / (torch.sqrt(v * nuh) + self.eps)
        if self.weight_decay:
            u = u - lr * self.weight_decay * p.to(torch.float32)
        return u.to(p.dtype)

    def update(self, grads, state: OptState, params):
        """One step on shared params: ``(updates, new_state)``."""
        grads, params = list(grads), list(params)
        if self.grad_clip is not None:
            grads = clip_by_global_norm(grads, self.grad_clip)
        step = state.step + 1
        updates, mu, nu = self._moments(grads, state, step,
                                        self._lr_at(state.step), params,
                                        lambda s, p: s)
        return updates, OptState(step=step, mu=mu, nu=nu)

    def update_(self, grads: list, state: OptState, params) -> OptState:
        """:meth:`update` followed by ``p += u``, done in place leaf by leaf:
        each moment and each parameter is overwritten, and each entry of
        ``grads`` (a list the caller gives up) is dropped once its leaf is
        done, so the step holds one leaf's temporaries beside the state
        where :meth:`update` holds a second set of moments and the updates.
        Bitwise the same values.  Returns the new state, which holds
        ``state``'s moment tensors: the old state is gone."""
        params = list(params)
        scale = None
        if self.grad_clip is not None:
            scale = torch.clamp_max(
                self.grad_clip / (global_norm(grads) + 1e-9), 1.0)
        step = state.step + 1
        lr = self._lr_at(state.step)
        muh, nuh = self._bias_scales(step)
        b1, b2 = self.b1, self.b2
        with torch.no_grad():
            for i, (m, v, p) in enumerate(zip(state.mu, state.nu, params,
                                              strict=True)):
                g, grads[i] = grads[i], None
                if scale is not None:
                    g = g * scale
                g = g.to(torch.float32)
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * torch.square(g))
                del g
                p.add_(self._delta(m, v, p, lr, muh, nuh))
        return OptState(step=step, mu=state.mu, nu=state.nu)

    def step_stacked(self, grads, state: OptState, params,
                     active: torch.Tensor):
        """One step on per-partition params (leading axis P), each partition
        clipped by its own global norm: ``(new_params, new_state)``, with
        the partitions where ``active`` (bool ``(P,)``) is False returned
        unchanged, bit for bit."""
        grads, params = list(grads), list(params)
        if self.grad_clip is not None:
            norm = torch.sqrt(sum(
                torch.square(g.to(torch.float32)).reshape(g.shape[0], -1).sum(1)
                for g in grads))
            scale = torch.clamp_max(self.grad_clip / (norm + 1e-9), 1.0)
            grads = [g * _per_part(scale, g) for g in grads]
        step = state.step + 1
        updates, mu, nu = self._moments(grads, state, step,
                                        self._lr_at(state.step), params,
                                        _per_part)
        sel = lambda new, old: torch.where(_per_part(active, new), new, old)
        new_params = [sel(p + u, p) for p, u in zip(params, updates)]
        new_state = OptState(step=torch.where(active, step, state.step),
                             mu=[sel(n, o) for n, o in zip(mu, state.mu)],
                             nu=[sel(n, o) for n, o in zip(nu, state.nu)])
        return new_params, new_state


def opt_state_from_numpy(state, model) -> OptState:
    """The reference's ``OptState(step, mu, nu)`` (moments shaped like its
    ``SAGEParams``, shared or per-partition) as this module's
    :class:`OptState` for ``model`` (a ``GraphSAGE``), so the port and the
    reference can start from one mid-run state."""
    dev = next(model.parameters()).device
    return OptState(
        step=torch.as_tensor(np.array(state.step), dtype=torch.int32,
                             device=dev),
        mu=[t.to(torch.float32) for t in model.tensors_from_numpy(
            state.mu.layers)],
        nu=[t.to(torch.float32) for t in model.tensors_from_numpy(
            state.nu.layers)])
