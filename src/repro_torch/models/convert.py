"""Carry the reference's weights into the port: the parity tests' bridge
between ``repro.models.Transformer.init(seed)`` and :class:`Transformer`.

Nothing here imports JAX: the caller hands over the parameter pytree as
nested dicts of arrays (``jax.device_get`` of it, or the jax arrays
themselves, which ``np.asarray`` reads).
"""
from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig
from .transformer import Transformer

__all__ = ["params_from_jax"]


def _leaf(a) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 has no torch counterpart in from_numpy: widen
        # to f32 (exact) and the caller narrows back to bf16 (exact)
        arr = arr.astype(np.float32)
    return torch.tensor(arr)


def _copy(dst: torch.Tensor, src, name: str) -> None:
    t = _leaf(src)
    if tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: reference shape {tuple(t.shape)}, port "
                         f"shape {tuple(dst.shape)}")
    dst.copy_(t.to(dst.dtype))


def _keys(have, want, name: str) -> None:
    if set(have) != set(want):
        raise ValueError(f"{name} has {sorted(have)}, the port expects "
                         f"{sorted(want)}")


def _copy_norm(pd, src, name: str) -> None:
    _keys(src, pd.keys(), name)
    for k, p in pd.items():
        _copy(p, src[k], f"{name}.{k}")


def _copy_blocks(blocks: dict, layers, nsub: int, repeats: int,
                 name: str) -> None:
    """Slice r of ``blocks.sub<i>`` into ``layers[r · nsub + i]``."""
    _keys(blocks, [f"sub{i}" for i in range(nsub)], name)
    for i in range(nsub):
        sub = blocks[f"sub{i}"]
        for r in range(repeats):
            groups = dict(layers[r * nsub + i].named_children())
            _keys(sub, groups, f"{name}.sub{i}")
            for g, pd in groups.items():
                _keys(sub[g], pd.keys(), f"{name}.sub{i}.{g}")
                for k, p in pd.items():
                    _copy(p, np.asarray(sub[g][k])[r],
                          f"{name}.sub{i}.{g}.{k}[{r}]")


def params_from_jax(tree: dict, cfg: ModelConfig, *,
                    device="cuda") -> Transformer:
    """A :class:`Transformer` of ``cfg`` on ``device`` holding the
    reference's parameters ``tree``.  ``blocks.sub<i>`` leaves (the groups
    ``norm_mix``, ``attn`` or ``mamba``, ``norm_cross`` and ``cross`` where
    the sub-layer has cross-attention, ``norm_ffn``, ``mlp`` or ``moe``)
    carry a leading repeat axis, so an expert tensor is ``(R, E, d, ff)``;
    slice r goes to layer ``r · len(super_block) + i``.  An
    encoder-decoder's ``encoder`` subtree holds ``blocks.sub0``, stacked
    over ``encoder_layers`` (slice r to ``encoder[r]``), and
    ``final_norm`` (to ``encoder_norm``).  Raises on a missing, extra or
    misshapen leaf."""
    model = Transformer(cfg, device=device)
    expected = {"embed", "final_norm", "blocks"}
    if not cfg.tie_embeddings:
        expected.add("lm_head")
    if cfg.is_encoder_decoder:
        expected.add("encoder")
    _keys(tree, expected, "reference params")
    with torch.no_grad():
        _copy(model.embed, tree["embed"], "embed")
        if not cfg.tie_embeddings:
            _copy(model.lm_head, tree["lm_head"], "lm_head")
        _copy_norm(model.final_norm, tree["final_norm"], "final_norm")
        _copy_blocks(tree["blocks"], model.layers, len(cfg.super_block),
                     cfg.num_repeats, "blocks")
        if cfg.is_encoder_decoder:
            enc = tree["encoder"]
            _keys(enc, ("blocks", "final_norm"), "encoder")
            _copy_blocks(enc["blocks"], model.encoder, 1,
                         cfg.encoder_layers, "encoder.blocks")
            _copy_norm(model.encoder_norm, enc["final_norm"],
                       "encoder.final_norm")
    return model
