"""The transformer's steps and their shardings (counterpart of
``repro/launch/steps.py``).

Given (config, input shape, mesh) :func:`build_step` returns the step a
launch runs:

  train_4k     -> train_step   (phase-0 generalize; phase-1 also buildable)
  prefill_32k  -> prefill_step
  decode_32k   -> serve_step        (one token, cache of seq_len)
  long_500k    -> serve_step

Steps take the model (an ``nn.Module``) where the reference takes the
params pytree, and update it in place.  With ``mesh=None`` they run on one
device.  With a mesh (a named ``DeviceMesh`` of ``torch.distributed``
ranks, ``launch/mesh.py::make_mesh_compat``) every rank calls the same
step: the parameters are DTensors placed by the sharding policy's
``param_specs`` (``models/sharding.py``), the AdamW moments mirror them,
the batch is sharded over the data axes and the outputs are placed as the
reference's ``out_shardings`` say.  :class:`BuiltStep` carries those
placements, in the reference's argument order, as ``in_shardings`` and
``out_shardings``.  All placements are *sanitized* against the mesh: an
axis is only applied to a dim it divides evenly (e.g. whisper's vocab
51865 stays replicated; qwen2's 14 heads skip the head constraint on a
model axis of 4 while its packed 896-wide projections still shard).  A
mesh runs every family of the zoo: the dense decoders, the
encoder-decoder (whisper: the encoder, cross-attention and its ``"cross"``
cache), the prefix-LM (paligemma: the patch embeddings, batch leaves like
the tokens), the MoE FFN and the Mamba2 mixer (a hybrid's caches mix KV
and SSM entries in one list, each placed by ``cache_spec_for``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from ..configs import InputShape, decode_cache_width, input_specs
from ..core.gp.trainer import GPHyperParams, make_personalize_partition_step
from ..models.config import ModelConfig
from ..models.sharding import (NO_SHARDING, P, ShardingPolicy,
                               cache_spec_for, placements)
from ..models.sharding import sanitize_spec as _sanitize
from ..train.optim import AdamW, OptState, sum_of_squares
from .mesh import data_axes_of, model_axis_of

__all__ = ["BuiltStep", "build_step", "sanitize_spec"]


def _axis_sizes(mesh) -> dict[str, int]:
    """Axis name -> size of a ``DeviceMesh``, or of any object whose
    ``shape`` maps names to sizes (the reference tests' ``FakeMesh``)."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def sanitize_spec(spec, shape: tuple[int, ...], mesh) -> P:
    """Drop mesh axes from dims they do not divide evenly."""
    return _sanitize(P(*spec), shape, _axis_sizes(mesh))


def _tree_shardings(specs: dict, structs: dict, mesh) -> dict:
    return {k: placements(sanitize_spec(specs[k], tuple(structs[k].shape),
                                        mesh), mesh) for k in specs}


def _batch_specs(batch_struct: dict, dax: tuple[str, ...]) -> dict:
    return {k: P(dax, *([None] * (len(v.shape) - 1)))
            for k, v in batch_struct.items()}


def _cache_spec_for(path: str, shape: tuple[int, ...], dax, mesh) -> P:
    """(B, H, W, Dh) KV / (B, H, N, P) ssm / (B, K, C) conv."""
    return cache_spec_for(path, shape, dax, _axis_sizes(mesh))


def _cache_tree_shardings(caches_struct, dax, mesh) -> list:
    """The caches' placements, a list of dicts in the caches' layout."""
    out = []
    for i, layer in enumerate(caches_struct):
        d = {}
        for key, leaf in layer.items():
            if isinstance(leaf, dict):
                d[key] = {k: placements(_cache_spec_for(
                    f"{i}/{key}/{k}", tuple(v.shape), dax, mesh), mesh)
                    for k, v in leaf.items()}
            else:
                d[key] = placements(_cache_spec_for(
                    f"{i}/{key}", tuple(leaf.shape), dax, mesh), mesh)
        out.append(d)
    return out


@dataclass
class BuiltStep:
    name: str
    step: Callable
    arg_specs: Any        # meta-tensor stand-ins of the step's data inputs
    cfg: ModelConfig
    in_shardings: Any = None      # placements, the reference's arg order
    out_shardings: Any = None
    policy: ShardingPolicy = NO_SHARDING
    mesh: Any = None
    _replicas: Any = field(default=None, repr=False)

    def shard_model(self, model):
        """Place ``model`` (the same weights on every rank) on the step's
        mesh by the policy; returns it.  Nothing without a mesh."""
        if self.mesh is None:
            return model
        model.policy = self.policy
        return model.distribute(self.mesh)

    def shard_replicas(self, models: list) -> list:
        """The personalize step's replicas this rank owns, of the P full
        models ``models`` (every rank passes all P): replica p lives on the
        data coordinate that owns it, sharded over ``"model"``."""
        if self.mesh is None:
            return models
        lo, hi, sub, policy = self._replicas
        mine = models[lo:hi]
        if sub is None:
            return mine
        for m in mine:
            m.policy = policy
            m.distribute(sub)
        return mine


def _train_loss(model, batch):
    return model.train_loss(batch)


def _make_policy(mesh, *, seq_shard_residual: bool = True,
                 constrain_attn: bool = True) -> ShardingPolicy:
    return ShardingPolicy(
        data_axes=data_axes_of(mesh),
        model_axis=model_axis_of(mesh),
        seq_shard_residual=seq_shard_residual,
        constrain_attn=constrain_attn,
        enabled=True,
        axis_sizes=_axis_sizes(mesh),
    )


def build_step(cfg: ModelConfig, shape: InputShape, mesh=None, *,
               optimizer: AdamW | None = None,
               phase: str = "generalize",
               num_partitions: int | None = None,
               seq_shard_residual: bool = True,
               constrain_attn: bool = True) -> BuiltStep:
    """The step of ``shape``'s kind for models of ``cfg``:

    - train, ``phase="generalize"``: ``step(model, opt_state, batch) ->
      (model, opt_state, loss)``, one AdamW step on the global batch, its
      moments and the weights stepped in place (``AdamW.update_``, bitwise
      the functional step: the state passed in is consumed);
    - train, ``phase="personalize"``: ``step(models, opt_states, batch_p,
      global_model, active) -> (models, opt_states, losses (P,))``, the
      port's :func:`make_personalize_partition_step` on each of the P
      per-partition models (``batch_p`` has a leading partition axis of
      ``num_partitions``, ``active`` is a bool ``(P,)``); the reference
      vmaps the same single-partition step;
    - prefill: ``step(model, batch) -> (logits, caches, cache_len)``, the
      batch with its extra inputs (``patch_embeds``, ``enc_embeds``) where
      the model takes them;
    - decode: ``step(model, token, caches, cache_len) -> (logits,
      caches)``, from the mod-W rolling cache where the shape's
      ``decode_cache_width`` says so; the encoder's keys and values ride in
      the caches (``"cross"``).

    ``seq_shard_residual`` and ``constrain_attn`` are the reference's
    policy options (``models/sharding.py::ShardingPolicy``): the residual's
    sequence over ``"model"`` between sub-layers, and the head constraint
    on training attention; without a mesh they change nothing.

    With a ``mesh`` the model is one placed by :meth:`BuiltStep.shard_model`
    (the personalize step's ``models`` are this rank's replicas, from
    :meth:`BuiltStep.shard_replicas`, and its ``opt_states`` theirs); the
    batch, token and caches may be the global tensors (each rank keeps its
    shard) or DTensors.  The loss comes back a replicated DTensor, the
    personalize losses ``(P,)`` sharded over the data axes, the logits
    ``P(data, "model")`` and the caches by ``_cache_spec_for``."""
    optimizer = optimizer or AdamW(lr=1e-3, weight_decay=0.01, grad_clip=1.0)
    if mesh is not None:
        return _build_sharded(cfg, shape, mesh, optimizer, phase,
                              num_partitions, dict(
                                  seq_shard_residual=seq_shard_residual,
                                  constrain_attn=constrain_attn))

    if shape.kind == "train" and phase == "generalize":
        return BuiltStep(f"train:{cfg.name}:{shape.name}",
                         _train_step(optimizer), input_specs(cfg, shape),
                         cfg)

    if shape.kind == "train" and phase == "personalize":
        npart = num_partitions or 1
        inner = make_personalize_partition_step(_train_loss, optimizer,
                                                GPHyperParams())
        specs = _partition_specs(cfg, shape, npart)

        def personalize_step(models, opt_states, batch_p, global_model,
                             active):
            losses = []
            for p, model in enumerate(models):
                batch = {k: v[p] for k, v in batch_p.items()}
                _, opt_states[p], loss = inner(model, opt_states[p], batch,
                                               global_model, active[p])
                losses.append(loss)
            return models, opt_states, torch.stack(losses)

        return BuiltStep(f"train-personalize:{cfg.name}:{shape.name}",
                         personalize_step, specs, cfg)

    if shape.kind == "prefill":
        def prefill_step(model, batch):
            return model.prefill(batch, cache_size=None)

        return BuiltStep(f"prefill:{cfg.name}:{shape.name}", prefill_step,
                         input_specs(cfg, shape), cfg)

    specs = input_specs(cfg, shape)
    _, rolling = decode_cache_width(cfg, shape)

    def serve_step(model, token, caches, cache_len):
        return model.decode_step(token, caches, cache_len, rolling=rolling)

    return BuiltStep(f"serve:{cfg.name}:{shape.name}", serve_step, specs, cfg)


def _train_step(optimizer, mesh=None):
    """The generalize step: the loss of the batch, its gradients (on a mesh
    summed into their parameters' placements), then AdamW in place, leaf by
    leaf (``AdamW.update_``), so the step holds one leaf's temporaries
    beside the moments where the functional update holds a second set of
    moments and the updates."""

    def train_step(model, opt_state, batch):
        weights = list(model.parameters())
        loss = model.train_loss({k: _global(v) for k, v in batch.items()})
        grads = torch.autograd.grad(loss.mean(), weights)
        if mesh is not None:
            grads = _sync(grads, weights)
        opt_state = optimizer.update_(list(grads), opt_state, weights)
        loss = loss.detach()
        return model, opt_state, (loss if mesh is None
                                  else _replicated(loss, mesh))

    return train_step


def _partition_specs(cfg, shape, npart) -> dict:
    return {k: torch.empty((npart, v.shape[0] // npart, *v.shape[1:]),
                           dtype=v.dtype, device=v.device)
            for k, v in input_specs(cfg, shape).items()}


# ---------------------------------------------------------------------------
# the steps on a mesh
# ---------------------------------------------------------------------------

def _replicated(t, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _sync(grads, weights) -> list:
    """Each gradient in its parameter's placements: the data-parallel sum
    (``Partial`` over the data axes) and the model-parallel one of the
    replicated weights (norm scales), explicit collectives, before AdamW
    sees any gradient."""
    return [g if tuple(g.placements) == tuple(w.placements)
            else g.redistribute(w.device_mesh, w.placements)
            for g, w in zip(grads, weights, strict=True)]


@torch.no_grad()
def _assign(weights, values) -> None:
    for w, v in zip(weights, values, strict=True):
        w.copy_(v)


def _global(v):
    """A batch leaf as a tensor (a DTensor or a global tensor as given)."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(np.asarray(v))


def _build_sharded(cfg, shape, mesh, optimizer, phase, num_partitions,
                   options) -> BuiltStep:
    from torch.distributed.tensor import Replicate

    from ..models.transformer import Transformer

    dax = data_axes_of(mesh)
    policy = _make_policy(mesh, **options)
    rep = [Replicate()] * mesh.ndim
    shapes = {n: tuple(p.shape) for n, p in Transformer(
        cfg, device="meta").named_parameters()}
    p_specs = policy.param_specs(shapes)
    p_shard = {n: placements(sanitize_spec(p_specs[n], shapes[n], mesh),
                             mesh) for n in shapes}
    built = dict(cfg=cfg, policy=policy, mesh=mesh)

    if shape.kind == "train" and phase == "generalize":
        o_shard = OptState(step=rep, mu=p_shard, nu=p_shard)
        batch_struct = input_specs(cfg, shape)
        b_shard = _tree_shardings(_batch_specs(batch_struct, dax),
                                  batch_struct, mesh)

        return BuiltStep(f"train:{cfg.name}:{shape.name}",
                         _train_step(optimizer, mesh),
                         batch_struct, in_shardings=(p_shard, o_shard,
                                                     b_shard),
                         out_shardings=(p_shard, o_shard, rep), **built)

    if shape.kind == "train" and phase == "personalize":
        return _build_personalize(cfg, shape, mesh, optimizer, dax, policy,
                                  p_specs, p_shard, shapes, rep,
                                  num_partitions, built)

    if shape.kind == "prefill":
        batch_struct = input_specs(cfg, shape)
        b_shard = _tree_shardings(_batch_specs(batch_struct, dax),
                                  batch_struct, mesh)
        # the caches hold the prefix too: the shape's whole sequence
        b, s = batch_struct["tokens"].shape[0], shape.seq_len
        from ..models.transformer import zero_layer_cache
        caches = [zero_layer_cache(cfg, sl.mixer, b, s, "meta",
                                   cfg.encoder_seq if sl.cross_attention
                                   else None)
                  for _ in range(cfg.num_repeats) for sl in cfg.super_block]
        logits_sh = placements(sanitize_spec(P(dax, "model"),
                                             (b, cfg.vocab_size), mesh), mesh)

        def prefill_step(model, batch):
            return model.prefill({k: _global(v) for k, v in batch.items()},
                                 cache_size=None)

        return BuiltStep(f"prefill:{cfg.name}:{shape.name}", prefill_step,
                         batch_struct, in_shardings=(p_shard, b_shard),
                         out_shardings=(logits_sh, _cache_tree_shardings(
                             caches, dax, mesh), rep), **built)

    specs = input_specs(cfg, shape)
    token, rolling = specs["token"], specs["rolling"]
    t_shard = placements(sanitize_spec(P(dax, None), tuple(token.shape),
                                       mesh), mesh)
    c_shard = _cache_tree_shardings(specs["caches"], dax, mesh)
    logits_sh = placements(sanitize_spec(
        P(dax, "model"), (token.shape[0], cfg.vocab_size), mesh), mesh)

    def serve_step(model, token, caches, cache_len):
        from ..models.sharded import shard_tensor

        def place(v, pls):
            if isinstance(v, dict):          # a layer's "cross" entry
                return {k: place(x, pls[k]) for k, x in v.items()}
            if type(v).__name__ == "DTensor":
                return v
            return shard_tensor(_global(v).to(model.device), mesh, pls)

        caches = [place(layer, c_shard[i]) for i, layer in enumerate(caches)]
        return model.decode_step(_global(token), caches, cache_len,
                                 rolling=rolling)

    return BuiltStep(f"serve:{cfg.name}:{shape.name}", serve_step, specs,
                     in_shardings=(p_shard, t_shard, c_shard, rep),
                     out_shardings=(logits_sh, c_shard), **built)


def _build_personalize(cfg, shape, mesh, optimizer, dax, policy, p_specs,
                       p_shard, shapes, rep, num_partitions, built):
    """Per-partition replicas: the leading axis sharded over the data axes
    (the reference's ``P(dax, *spec)``), each replica sharded over
    ``"model"``; the rank runs the single-partition step on the replicas
    its data coordinate owns, on the mesh's model dimension."""
    from torch.distributed.tensor import DTensor

    names = list(mesh.mesh_dim_names)
    ddims = [names.index(a) for a in dax]
    n_data = math.prod(mesh.size(d) for d in ddims)
    npart = num_partitions or n_data
    if npart % n_data:
        raise ValueError(f"{npart} replicas do not split over the {n_data} "
                         "data coordinates of the mesh")
    coord = mesh.get_coordinate()
    c = 0
    for d in ddims:
        c = c * mesh.size(d) + coord[d]
    per = npart // n_data
    model_ax = model_axis_of(mesh)
    sub = mesh[model_ax] if model_ax else None
    sub_policy = ShardingPolicy(
        data_axes=(), model_axis=model_ax,
        seq_shard_residual=policy.seq_shard_residual,
        constrain_attn=policy.constrain_attn, enabled=True,
        axis_sizes={model_ax: mesh.size(names.index(model_ax))}
        if model_ax else {})
    pp_shard = {n: placements(sanitize_spec(P(dax, *p_specs[n]),
                                            (npart, *shapes[n]), mesh), mesh)
                for n in shapes}
    oo_shard = OptState(step=rep, mu=pp_shard, nu=pp_shard)
    batch_struct = _partition_specs(cfg, shape, npart)
    bb_shard = _tree_shardings(_batch_specs(batch_struct, dax), batch_struct,
                               mesh)
    a_shard = placements(sanitize_spec(P(dax), (npart,), mesh), mesh)
    hp = GPHyperParams()
    mdim = names.index(model_ax) if model_ax else None

    def inner(model, opt_state, batch, global_weights, active):
        weights = list(model.parameters())
        loss = model.train_loss(batch)
        if hp.use_prox:
            loss = loss + hp.lambda_prox * sum_of_squares(
                [w.to(torch.float32) - g.detach().to(torch.float32)
                 for w, g in zip(weights, global_weights, strict=True)])
        grads = torch.autograd.grad(loss, weights)
        if sub is not None:
            grads = _sync(grads, weights)
        old = [w.detach() for w in weights]
        updates, new_state = optimizer.update(grads, opt_state, old)
        if not bool(active):
            return model, opt_state, loss.detach()
        _assign(weights, [w + u for w, u in zip(old, updates)])
        return model, new_state, loss.detach()

    def personalize_step(models, opt_states, batch_p, global_model, active):
        if sub is None:
            gw = [g.to_local() for g in global_model.parameters()]
        else:
            gw = [DTensor.from_local(g.to_local(), sub, [g.placements[mdim]],
                                     run_check=False)
                  for g in global_model.parameters()]
        active = _global(active)
        losses = []
        for j, model in enumerate(models):
            p = c * per + j
            batch = {k: _global(v)[p] for k, v in batch_p.items()}
            _, opt_states[j], loss = inner(model, opt_states[j], batch, gw,
                                           active[p])
            losses.append(loss)
        return models, opt_states, DTensor.from_local(
            torch.stack(losses), mesh, a_shard, run_check=False)

    return BuiltStep(f"train-personalize:{cfg.name}:{shape.name}",
                     personalize_step, batch_struct,
                     in_shardings=(pp_shard, oo_shard, bb_shard, p_shard,
                                   a_shard),
                     out_shardings=(pp_shard, oo_shard, a_shard),
                     _replicas=(c * per, (c + 1) * per, sub, sub_policy),
                     **built)
