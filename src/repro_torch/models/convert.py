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


def params_from_jax(tree: dict, cfg: ModelConfig, *,
                    device="cuda") -> Transformer:
    """A :class:`Transformer` of ``cfg`` on ``device`` holding the
    reference's parameters ``tree``.  ``blocks.sub<i>`` leaves (the groups
    ``norm_mix``, ``attn`` or ``mamba``, ``norm_ffn``, ``mlp`` or ``moe``)
    carry a leading repeat axis, so an expert tensor is ``(R, E, d, ff)``;
    slice r goes to layer ``r · len(super_block) + i``.  Raises on a
    missing, extra or misshapen leaf."""
    model = Transformer(cfg, device=device)
    expected = {"embed", "final_norm", "blocks"}
    if not cfg.tie_embeddings:
        expected.add("lm_head")
    if set(tree) != expected:
        raise ValueError(f"reference params have {sorted(tree)}, the port "
                         f"expects {sorted(expected)}")
    nsub = len(cfg.super_block)
    with torch.no_grad():
        _copy(model.embed, tree["embed"], "embed")
        if not cfg.tie_embeddings:
            _copy(model.lm_head, tree["lm_head"], "lm_head")
        for k, p in model.final_norm.items():
            _copy(p, tree["final_norm"][k], f"final_norm.{k}")
        if set(tree["blocks"]) != {f"sub{i}" for i in range(nsub)}:
            raise ValueError(f"reference blocks have {sorted(tree['blocks'])}")
        for i in range(nsub):
            sub = tree["blocks"][f"sub{i}"]
            for r in range(cfg.num_repeats):
                layer = model.layers[r * nsub + i]
                groups = dict(layer.named_children())
                if set(sub) != set(groups):
                    raise ValueError(f"blocks.sub{i} has {sorted(sub)}, the "
                                     f"port expects {sorted(groups)}")
                for g, pd in groups.items():
                    if set(sub[g]) != set(pd.keys()):
                        raise ValueError(f"blocks.sub{i}.{g} has "
                                         f"{sorted(sub[g])}, the port "
                                         f"expects {sorted(pd.keys())}")
                    for k, p in pd.items():
                        _copy(p, np.asarray(sub[g][k])[r],
                              f"blocks.sub{i}.{g}.{k}[{r}]")
    return model
