"""The decoder zoo: init from a seed, the training loss, prefill and
one-token decode (counterpart of ``repro/models/transformer.py`` without
the encoder-decoder and the multimodal prefix).

Where the reference scans one stacked block pytree with ``lax.scan``, the
port loops over an ``nn.ModuleList`` with one module per layer: layer
``r · len(super_block) + i`` is sub-layer i of repeat r, a mixer
(attention or Mamba2) and an FFN (MLP, mixture of experts or none).  Its
caches are a list with one dict per layer, ``{"k", "v"}`` ``(B, Hkv, W,
Dh)`` for attention and ``{"conv", "ssm"}`` (``(B, K-1, d_inner + 2N)`` in
the model's dtype, ``(B, H, N, P)`` f32) for Mamba2, allocated by
:meth:`Transformer.prefill` (or :meth:`make_decode_cache`) and written in
place by :meth:`decode_step`; ``cache_len`` is a host int, so a decode step
never waits for the device to learn where to write.  ``rolling=True``
decodes from a mod-W attention cache (the sliding-window serving of
``--swa``; a prefill into a cache narrower than the prompt fills it).

:meth:`Transformer.train_loss` runs the layers under autograd (each under
``torch.utils.checkpoint`` when ``cfg.remat``, as the reference checkpoints
its scan body) and :func:`chunked_ce_loss` over the vocabulary; on the card
the flash attention and RMSNorm kernels run forward and backward through
their autograd functions.  The parameters are trainable ``nn.Parameter``s;
serving runs under ``torch.no_grad``.

Supported: attention and Mamba2 mixers, MLP, MoE and no FFN, rmsnorm or
layernorm, swiglu or gelu, QKV bias, RoPE or sinusoidal positions, tied or
untied head, a native ``sliding_window`` and the rolling cache.
Cross-attention and the encoder (whisper; ROADMAP item 15.5) and a
multimodal prefix (paligemma; item 15.6) raise ``NotImplementedError``, and
so does training a model with a Mamba2 mixer or an MoE FFN (item 15.9).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from . import layers as L
from .config import ModelConfig

__all__ = ["Transformer", "chunked_ce_loss"]


def _chunks(t: int, chunk: int):
    return [(lo, min(lo + chunk, t)) for lo in range(0, t, chunk)]


def _chunk_nll(hx, w32, lx):
    """Summed masked NLL of one token chunk and its softmax: the chunk's
    f32 logits ``hx @ W`` exist only inside this call."""
    logp = torch.log_softmax(hx.float() @ w32, dim=-1)
    wgt = (lx >= 0).to(torch.float32)
    nll = -logp.gather(1, lx.clamp_min(0)[:, None])[:, 0]
    return (nll * wgt).sum(), wgt, logp


class _ChunkedCE(torch.autograd.Function):
    """Cross-entropy over the vocabulary, one token chunk at a time, whose
    backward recomputes each chunk's logits (the reference remats its scan
    body, ``jax.checkpoint``): peak memory holds one chunk's f32 logits and
    their softmax, never (T, V)."""

    @staticmethod
    def forward(ctx, h, w_head, labels, chunk):
        t = h.shape[0]
        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        cnt = torch.zeros((), dtype=torch.float32, device=h.device)
        for lo, hi in _chunks(t, chunk):
            # the head is cast to f32 per chunk, as the reference casts it
            part, wgt, _ = _chunk_nll(h[lo:hi], w_head.float(), labels[lo:hi])
            tot, cnt = tot + part, cnt + wgt.sum()
        denom = torch.clamp_min(cnt, 1.0)
        ctx.save_for_backward(h, w_head, labels, denom)
        ctx.chunk = chunk
        return tot / denom

    @staticmethod
    def backward(ctx, g):
        h, w_head, labels, denom = ctx.saved_tensors
        dh = torch.empty_like(h) if ctx.needs_input_grad[0] else None
        dw = (torch.zeros(w_head.shape, dtype=torch.float32,
                          device=w_head.device)
              if ctx.needs_input_grad[1] else None)
        scale = g / denom
        for lo, hi in _chunks(h.shape[0], ctx.chunk):
            hx, lx = h[lo:hi], labels[lo:hi]
            w32 = w_head.float()
            _, wgt, logp = _chunk_nll(hx, w32, lx)
            # d(sum nll * wgt)/dlogits = (softmax - onehot) * wgt
            dlog = torch.exp(logp)
            dlog.scatter_add_(1, lx.clamp_min(0)[:, None],
                              -torch.ones_like(wgt)[:, None])
            dlog *= (wgt * scale)[:, None]
            if dh is not None:
                dh[lo:hi] = (dlog @ w32.T).to(h.dtype)
            if dw is not None:
                dw += hx.float().T @ dlog
        return (dh, None if dw is None else dw.to(w_head.dtype), None, None)


def chunked_ce_loss(h: torch.Tensor, w_head: torch.Tensor,
                    labels: torch.Tensor, chunk: int = 4096) -> torch.Tensor:
    """Mean cross-entropy of ``h @ w_head`` (T, V) against ``labels`` (T,)
    without materialising the (T, V) logits: token chunks of ``chunk``
    (the reference's ``chunked_ce_loss``).  Labels < 0 are masked out, the
    mean is over the unmasked tokens, and none unmasked gives 0.  The
    logits, the log-softmax and the sums are f32.  The head's gradient
    sums the chunks in f32 and is cast to its dtype once (the reference's
    scan transposes each chunk's into its dtype)."""
    labels = labels.to(device=h.device, dtype=torch.long)
    return _ChunkedCE.apply(h, w_head, labels, max(1, min(chunk, h.shape[0])))


def _check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port cannot serve yet."""
    todo = {}
    if any(sl.cross_attention for sl in cfg.super_block):
        todo["cross-attention"] = "15.5"
    if cfg.is_encoder_decoder:
        todo["the encoder"] = "15.5"
    if cfg.prefix_tokens:
        todo["the multimodal prefix"] = "15.6"
    if todo:
        raise NotImplementedError(
            f"{cfg.name}: " + ", ".join(
                f"{what} (ROADMAP item {item})" for what, item in todo.items())
            + " not ported yet; the port serves decoder-only models")


def _check_trainable(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a family the port only serves."""
    todo = sorted({f"the {sl.mixer} mixer" for sl in cfg.super_block
                   if sl.mixer != "attention"}
                  | {f"the {sl.ffn} ffn" for sl in cfg.super_block
                     if sl.ffn == "moe"})
    if todo:
        raise NotImplementedError(
            f"{cfg.name}: training {' and '.join(todo)} is not ported yet "
            "(ROADMAP item 15.9, training the zoo's MoE and Mamba2 "
            "families); the port serves them")


def _params(params: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in params.items()})


class _Layer(nn.Module):
    """One sub-layer ``sl`` of the super-block: its mixer (attention or
    Mamba2) and FFN (MLP, MoE or none) with their norms; parameter names are
    the reference's ``blocks.sub<i>`` keys (``norm_mix``, ``attn`` |
    ``mamba``, ``norm_ffn``, ``mlp`` | ``moe``).

    The residual add that ends a sub-layer is left to the norm after it,
    which fuses the add in front of the norm: :meth:`forward` takes the
    residual stream ``x`` and the previous layer's output ``delta`` not yet
    added (None before the first layer), and returns the stream and its own
    last output (the FFN's, or the mixer's where there is no FFN) for the
    next norm to add."""

    def __init__(self, cfg: ModelConfig, sl, gen, device):
        super().__init__()
        self.mixer, self.ffn = sl.mixer, sl.ffn
        self.norm_mix = _params(L.norm_init(cfg, device=device))
        if sl.mixer == "attention":
            self.attn = _params(L.attention_init(cfg, gen, device))
        else:
            self.mamba = _params(L.mamba2_init(cfg, gen, device))
        if sl.ffn != "none":
            self.norm_ffn = _params(L.norm_init(cfg, device=device))
        if sl.ffn == "mlp":
            self.mlp = _params(L.mlp_init(cfg, gen, device))
        elif sl.ffn == "moe":
            self.moe = _params(L.moe_init(cfg, gen, device))

    def _mix(self, h, cfg, kernels, cache, cache_len, cache_size, rolling):
        if self.mixer == "mamba2":
            if cache is None:
                return L.mamba2_apply(self.mamba, h, cfg)
            return L.mamba2_decode(self.mamba, h, cache, cfg)
        if cache is None:
            return L.attention_prefill(
                self.attn, h, cfg, window=cfg.sliding_window,
                cache_size=cache_size, kernels=kernels)
        return L.attention_decode(
            self.attn, h, cache, cache_len, cfg, window=cfg.sliding_window,
            rolling=rolling, kernels=kernels)

    def forward(self, x, delta, cfg, *, kernels, cache=None, cache_len=None,
                cache_size=None, rolling=False):
        x, h = L.add_norm_apply(self.norm_mix, x, delta, cfg, kernels=kernels)
        mix, cache = self._mix(h, cfg, kernels, cache, cache_len, cache_size,
                               rolling)
        if self.ffn == "none":
            return x, mix, cache
        x, h = L.add_norm_apply(self.norm_ffn, x, mix, cfg, kernels=kernels)
        if self.ffn == "moe":
            return x, L.moe_apply(self.moe, h, cfg)[0], cache
        return x, L.mlp_apply(self.mlp, h, cfg), cache

    def train_forward(self, x, delta, cfg, kernels):
        """The training form of :meth:`forward` for an attention + MLP
        sub-layer: causal attention over the whole sequence, no cache;
        returns ``(x, mlp_out)``."""
        x, h = L.add_norm_apply(self.norm_mix, x, delta, cfg, kernels=kernels)
        mix = L.attention_apply(self.attn, h, cfg, window=cfg.sliding_window,
                                kernels=kernels)
        x, h = L.add_norm_apply(self.norm_ffn, x, mix, cfg, kernels=kernels)
        return x, L.mlp_apply(self.mlp, h, cfg)


def zero_layer_cache(cfg: ModelConfig, mixer: str, batch: int, width: int,
                     device) -> dict:
    """One layer's zero decode cache (tensors on ``device``, which may be
    ``meta``)."""
    dt = getattr(torch, cfg.dtype)
    if mixer == "attention":
        kv = (batch, cfg.num_kv_heads, width, cfg.resolved_head_dim)
        return {"k": torch.zeros(kv, dtype=dt, device=device),
                "v": torch.zeros(kv, dtype=dt, device=device)}
    conv = (batch, cfg.ssm_conv - 1, cfg.ssm_d_inner + 2 * cfg.ssm_state)
    ssm = (batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim)
    return {"conv": torch.zeros(conv, dtype=dt, device=device),
            "ssm": torch.zeros(ssm, dtype=torch.float32, device=device)}


class Transformer(nn.Module):
    """A decoder of the zoo with random weights from ``seed`` on ``device``
    (the CUDA card by default; raises without one unless ``device="cpu"``).

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
        self.embed = nn.Parameter((0.02 * embed).to(dt))
        self.final_norm = _params(L.norm_init(cfg, device=dev))
        self.layers = nn.ModuleList(_Layer(cfg, sl, gen, dev)
                                    for _ in range(cfg.num_repeats)
                                    for sl in cfg.super_block)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                L._dense_init(gen, d, cfg.vocab_size, dt, dev))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ============================================================== embed
    def _embed_tokens(self, tokens: torch.Tensor,
                      offset: int = 0) -> torch.Tensor:
        # F.embedding, not self.embed[tokens]: the same rows, and its
        # backward sums repeated tokens in a fixed order on the CPU, where
        # indexing's backward does not
        x = F.embedding(tokens, self.embed)
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

    # ================================================================ train
    def train_loss(self, batch: dict) -> torch.Tensor:
        """The mean next-token loss of ``batch["tokens"]`` (B, S) against
        ``batch["labels"]`` (B, S; < 0 masked), differentiable in every
        parameter: the embedding, the layers (each checkpointed when
        ``cfg.remat``), the final norm over every position, then
        :func:`chunked_ce_loss` over the head.  The dense family has no
        auxiliary loss (the reference adds MoE's); a model with a Mamba2
        mixer or an MoE FFN raises ``NotImplementedError`` (ROADMAP item
        15.9)."""
        cfg = self.cfg
        _check_trainable(cfg)
        tokens = self._tokens(batch["tokens"])
        labels = self._tokens(batch["labels"])
        x, delta = self._embed_tokens(tokens), None
        for layer in self.layers:
            if cfg.remat:
                x, delta = checkpoint(layer.train_forward, x, delta, cfg,
                                      self.use_kernels, use_reentrant=False)
            else:
                x, delta = layer.train_forward(x, delta, cfg,
                                               self.use_kernels)
        _, h = L.add_norm_apply(self.final_norm, x, delta, cfg,
                                kernels=self.use_kernels)
        b, s, d = h.shape
        # the reference's measurement mode: one chunk of every token
        chunk = b * s if cfg.scan_unroll else 4096
        return chunked_ce_loss(h.reshape(b * s, d), self._head(),
                               labels.reshape(-1), chunk=chunk)

    # ============================================================== prefill
    @torch.no_grad()
    def prefill(self, batch: dict, *, cache_size: int | None = None):
        """Run the prompt ``batch["tokens"]`` (B, S); returns
        ``(last_logits (B, V) float32, caches, cache_len)`` with attention
        caches of width ``cache_size`` (default S; narrower than S: the
        rolling cache of the last ``cache_size`` positions), Mamba2 caches
        of the state after the prompt, and ``cache_len == S``."""
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
    def decode_step(self, token, caches: list, cache_len: int, *,
                    rolling: bool = False):
        """One-token step.  ``token`` (B, 1); writes each layer's cache in
        place: attention at slot ``cache_len`` (``cache_len mod W`` with
        ``rolling``, the mod-W cache), Mamba2's conv tail and state.
        Returns ``(logits, caches)``."""
        cfg = self.cfg
        cache_len = int(cache_len)
        x = self._embed_tokens(self._tokens(token), offset=cache_len)
        delta = None
        for layer, cache in zip(self.layers, caches):
            x, delta, _ = layer(x, delta, cfg, kernels=self.use_kernels,
                                cache=cache, cache_len=cache_len,
                                rolling=rolling)
        return self._logits(x, delta), caches

    # ======================================================== cache structs
    def make_decode_cache(self, batch: int, cache_width: int) -> list:
        """Zero caches, one per layer: ``{"k", "v"}`` of ``cache_width``
        slots for attention, ``{"conv", "ssm"}`` for Mamba2."""
        return [zero_layer_cache(self.cfg, layer.mixer, batch, cache_width,
                                 self.device) for layer in self.layers]

    # ============================================================== params N
    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())
