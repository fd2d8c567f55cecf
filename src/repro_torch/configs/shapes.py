"""The four assigned input shapes and their stand-in inputs (counterpart of
``repro/configs/shapes.py``).

Decode shapes drive ``serve_step`` (ONE token, KV cache of seq_len);
``long_500k`` additionally needs a sub-quadratic path (native for the
sliding-window archs).  Where the reference returns ``jax.ShapeDtypeStruct``
stand-ins, :func:`input_specs` returns tensors on ``torch.device("meta")``:
shapes and dtypes, no storage.  A decode spec's caches take the port's
layout, a list with one dict per layer (``{"k", "v"}`` of ``(B, Hkv, W,
Dh)`` for attention, ``{"conv", "ssm"}`` for Mamba2, and beside them
``"cross"``, ``{"k", "v"}`` of ``(B, Hkv, encoder_seq, Dh)``, where a layer
has cross-attention), where the reference stacks the layers of a sub-layer
on a leading repeat axis.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.config import ModelConfig

__all__ = ["InputShape", "SHAPES", "input_specs", "decode_cache_width"]


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

_META = torch.device("meta")


def decode_cache_width(cfg: ModelConfig, shape: InputShape) -> tuple[int, bool]:
    """(cache width, rolling?) for a decode shape under this config.

    Archs with a sliding window keep a mod-W rolling cache of W slots;
    full-attention archs keep the whole context.
    """
    if cfg.sliding_window is not None and cfg.sliding_window < shape.seq_len:
        return cfg.sliding_window, True
    return shape.seq_len, False


def _tokens(b: int, s: int) -> torch.Tensor:
    return torch.empty((b, s), dtype=torch.int32, device=_META)


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Meta-tensor stand-ins for every model input (no allocation).

    For train/prefill: the batch dict.  For decode: ``token``, ``caches``
    (one dict per layer, as ``Transformer.make_decode_cache`` builds them,
    with the cross-attention caches of ``encoder_seq`` positions),
    ``cache_len`` and ``rolling``, matching ``Transformer.decode_step``.
    """
    b, s = shape.global_batch, shape.seq_len
    act_dt = getattr(torch, cfg.dtype)

    if shape.kind in ("train", "prefill"):
        s_text = s - cfg.prefix_tokens
        batch: dict = {"tokens": _tokens(b, s_text)}
        if shape.kind == "train":
            batch["labels"] = _tokens(b, s_text)
        if cfg.prefix_tokens:
            batch["patch_embeds"] = torch.empty(
                (b, cfg.prefix_tokens, cfg.d_model), dtype=act_dt,
                device=_META)
        if cfg.is_encoder_decoder:
            batch["enc_embeds"] = torch.empty(
                (b, cfg.encoder_seq, cfg.d_model), dtype=act_dt,
                device=_META)
        return batch

    # decode: one token against a cache of seq_len context
    from ..models.transformer import zero_layer_cache

    width, rolling = decode_cache_width(cfg, shape)
    caches = [zero_layer_cache(cfg, sl.mixer, b, width, _META,
                               cfg.encoder_seq if sl.cross_attention
                               else None)
              for _ in range(cfg.num_repeats) for sl in cfg.super_block]
    return {
        "token": _tokens(b, 1),
        "caches": caches,
        "cache_len": torch.empty((), dtype=torch.int32, device=_META),
        "rolling": rolling,
    }
