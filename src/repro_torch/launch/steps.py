"""Step builders for the transformer (counterpart of
``repro/launch/steps.py``), on one card.

Given (config, input shape) :func:`build_step` returns the step a launch
runs:

  train_4k     -> train_step   (phase-0 generalize; phase-1 also buildable)
  prefill_32k  -> prefill_step
  decode_32k   -> serve_step        (one token, cache of seq_len)
  long_500k    -> serve_step

The reference builds its steps for a device mesh, with every input and
output sharding spelled out and ``sanitize_spec`` dropping mesh axes that do
not divide a dimension.  One card has no shardings: those wait for the
sharding policy (``models/sharding.py``, ROADMAP item 15.7), and
:class:`BuiltStep` keeps the step, its input stand-ins and the config.
Steps take the model (an ``nn.Module``) where the reference takes the
params pytree, and update it in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..configs import InputShape, decode_cache_width, input_specs
from ..core.gp.trainer import (GPHyperParams, make_generalize_step,
                               make_personalize_partition_step)
from ..models.config import ModelConfig
from ..train.optim import AdamW

__all__ = ["BuiltStep", "build_step"]


@dataclass
class BuiltStep:
    name: str
    step: Callable
    arg_specs: Any        # meta-tensor stand-ins of the step's data inputs
    cfg: ModelConfig


def _train_loss(model, batch):
    return model.train_loss(batch)


def build_step(cfg: ModelConfig, shape: InputShape, *,
               optimizer: AdamW | None = None,
               phase: str = "generalize",
               num_partitions: int | None = None) -> BuiltStep:
    """The step of ``shape``'s kind for models of ``cfg``:

    - train, ``phase="generalize"``: ``step(model, opt_state, batch) ->
      (model, opt_state, loss)``, one AdamW step on the global batch;
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
    """
    optimizer = optimizer or AdamW(lr=1e-3, weight_decay=0.01, grad_clip=1.0)

    if shape.kind == "train" and phase == "generalize":
        return BuiltStep(f"train:{cfg.name}:{shape.name}",
                         make_generalize_step(_train_loss, optimizer),
                         input_specs(cfg, shape), cfg)

    if shape.kind == "train" and phase == "personalize":
        npart = num_partitions or 1
        inner = make_personalize_partition_step(_train_loss, optimizer,
                                                GPHyperParams())
        specs = {k: torch.empty((npart, v.shape[0] // npart, *v.shape[1:]),
                                dtype=v.dtype, device=v.device)
                 for k, v in input_specs(cfg, shape).items()}

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
