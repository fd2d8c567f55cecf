"""The dense decoder: init from a seed, prefill and one-token decode
(counterpart of ``repro/models/transformer.py`` for the dense family).

Where the reference scans one stacked block pytree with ``lax.scan``, the
port loops over an ``nn.ModuleList`` with one module per layer (layer
``r · len(super_block) + i`` is sub-layer i of repeat r).  Its KV caches are
a list with one ``{"k", "v"}`` dict per layer, ``(B, Hkv, W, Dh)``,
allocated by :meth:`Transformer.prefill` (or :meth:`make_decode_cache`) and
written in place by :meth:`decode_step`; ``cache_len`` is a host int, so a
decode step never waits for the device to learn where to write.

Supported: attention + MLP sub-layers, rmsnorm or layernorm, swiglu or
gelu, QKV bias, RoPE or sinusoidal positions, tied or untied head, a native
``sliding_window``.  Mamba2, MoE, cross-attention (whisper), a multimodal
prefix (paligemma) and the rolling cache (``cache_size`` below the prompt)
raise ``NotImplementedError``, as do training (``train_loss``,
``chunked_ce_loss``): ROADMAP item 15.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from . import layers as L
from .config import ModelConfig

__all__ = ["Transformer"]


def _check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port cannot run yet."""
    todo = []
    for sl in cfg.super_block:
        if sl.mixer != "attention":
            todo.append(f"the {sl.mixer} mixer")
        if sl.ffn != "mlp":
            todo.append(f"the {sl.ffn!r} ffn")
        if sl.cross_attention:
            todo.append("cross-attention")
    if cfg.is_encoder_decoder:
        todo.append("the encoder")
    if cfg.prefix_tokens:
        todo.append("the multimodal prefix")
    if todo:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(sorted(set(todo)))} not ported yet "
            "(ROADMAP item 15); the port serves dense decoders")


def _frozen(params: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in params.items()})


class _Layer(nn.Module):
    """One (attention, MLP) sub-layer with its two norms; parameter names
    are the reference's ``blocks.sub<i>`` keys.

    The residual add that ends a sub-layer is left to the norm after it,
    which fuses the add in front of the norm: :meth:`forward` takes the
    residual stream ``x`` and the previous layer's MLP output ``delta`` not
    yet added (None before the first layer), and returns the stream and its
    own MLP output for the next norm to add."""

    def __init__(self, cfg: ModelConfig, gen, device):
        super().__init__()
        self.norm_mix = _frozen(L.norm_init(cfg, device=device))
        self.attn = _frozen(L.attention_init(cfg, gen, device))
        self.norm_ffn = _frozen(L.norm_init(cfg, device=device))
        self.mlp = _frozen(L.mlp_init(cfg, gen, device))

    def forward(self, x, delta, cfg, *, kernels, cache=None, cache_len=None,
                cache_size=None):
        x, h = L.add_norm_apply(self.norm_mix, x, delta, cfg, kernels=kernels)
        if cache is None:
            mix, cache = L.attention_prefill(
                self.attn, h, cfg, window=cfg.sliding_window,
                cache_size=cache_size, kernels=kernels)
        else:
            mix, cache = L.attention_decode(
                self.attn, h, cache, cache_len, cfg,
                window=cfg.sliding_window, kernels=kernels)
        x, h = L.add_norm_apply(self.norm_ffn, x, mix, cfg, kernels=kernels)
        return x, L.mlp_apply(self.mlp, h, cfg), cache


class Transformer(nn.Module):
    """A dense decoder with random weights from ``seed`` on ``device`` (the
    CUDA card by default; raises without one unless ``device="cpu"``).

    ``use_kernels=False`` runs the plain versions of the flash attention and
    RMSNorm kernels instead, on any device; it exists so the kernels can be
    held against them on the card.
    """

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device="cuda",
                 use_kernels: bool = True):
        super().__init__()
        _check_supported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.use_kernels = use_kernels
        gen = torch.Generator(device=dev).manual_seed(seed)
        dt = getattr(torch, cfg.dtype)
        d = cfg.d_model
        embed = torch.empty((cfg.vocab_size, d), dtype=torch.float32,
                            device=dev).normal_(generator=gen)
        self.embed = nn.Parameter((0.02 * embed).to(dt), requires_grad=False)
        self.final_norm = _frozen(L.norm_init(cfg, device=dev))
        self.layers = nn.ModuleList(_Layer(cfg, gen, dev)
                                    for _ in range(cfg.num_layers))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                L._dense_init(gen, d, cfg.vocab_size, dt, dev),
                requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ============================================================== embed
    def _embed_tokens(self, tokens: torch.Tensor,
                      offset: int = 0) -> torch.Tensor:
        x = self.embed[tokens]
        if self.cfg.rope_theta is None:
            pos = L.sinusoidal_positions(tokens.shape[1], self.cfg.d_model,
                                         device=x.device, offset=offset)
            x = x + pos[None].to(x.dtype)
        return x

    def _head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def _logits(self, x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
        """Logits of the last position: the last layer's residual add and
        the final norm on that position alone (both are row-wise, so the
        values are those of normalising every position)."""
        _, h = L.add_norm_apply(self.final_norm, x[:, -1:].contiguous(),
                                delta[:, -1:].contiguous(), self.cfg,
                                kernels=self.use_kernels)
        return h[:, 0].float() @ self._head().float()

    def _tokens(self, tokens) -> torch.Tensor:
        if not isinstance(tokens, torch.Tensor):
            tokens = torch.as_tensor(np.asarray(tokens))
        return tokens.to(self.device).long()

    # ============================================================== prefill
    @torch.no_grad()
    def prefill(self, batch: dict, *, cache_size: int | None = None):
        """Run the prompt ``batch["tokens"]`` (B, S); returns
        ``(last_logits (B, V) float32, caches, cache_len)`` with caches of
        width ``cache_size`` (default S) and ``cache_len == S``."""
        tokens = self._tokens(batch["tokens"])
        x, delta = self._embed_tokens(tokens), None
        caches = []
        for layer in self.layers:
            x, delta, c = layer(x, delta, self.cfg, kernels=self.use_kernels,
                                cache_size=cache_size)
            caches.append(c)
        return self._logits(x, delta), caches, int(tokens.shape[1])

    # =============================================================== decode
    @torch.no_grad()
    def decode_step(self, token, caches: list, cache_len: int):
        """One-token step.  ``token`` (B, 1); writes each layer's cache at
        slot ``cache_len`` in place.  Returns ``(logits, caches)``."""
        cfg = self.cfg
        cache_len = int(cache_len)
        x = self._embed_tokens(self._tokens(token), offset=cache_len)
        delta = None
        for layer, cache in zip(self.layers, caches):
            x, delta, _ = layer(x, delta, cfg, kernels=self.use_kernels,
                                cache=cache, cache_len=cache_len)
        return self._logits(x, delta), caches

    # ======================================================== cache structs
    def make_decode_cache(self, batch: int, cache_width: int) -> list:
        """Zero caches, one ``{"k", "v"}`` per layer."""
        cfg = self.cfg
        shape = (batch, cfg.num_kv_heads, cache_width, cfg.resolved_head_dim)
        dt = getattr(torch, cfg.dtype)
        return [{"k": torch.zeros(shape, dtype=dt, device=self.device),
                 "v": torch.zeros(shape, dtype=dt, device=self.device)}
                for _ in self.layers]

    # ============================================================== params N
    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())
