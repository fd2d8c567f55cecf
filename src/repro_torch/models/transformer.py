"""The architecture zoo: init from a seed, the training loss, prefill and
one-token decode (counterpart of ``repro/models/transformer.py``).

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
untied head, a native ``sliding_window`` and the rolling cache; the
encoder-decoder (whisper: :meth:`Transformer.encode`, cross-attention after
each decoder layer's self-attention, whose decode reads the encoder's keys
and values from the layer cache's ``"cross"`` entry) and the prefix-LM
(paligemma: ``patch_embeds`` prepended to the tokens, seen by every query).
Training runs every family: attention or Mamba2 mixers, MLP, MoE or no
FFN, with MoE's Switch auxiliary loss summed over the layers into the loss;
the encoder-decoder (the encoder under autograd, not checkpointed, and each
decoder layer's cross-attention over its output) and the prefix-LM (the
patch embeddings prepended, their labels masked).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from . import layers as L
from .config import ModelConfig, SubLayer
from .sharding import NO_SHARDING

__all__ = ["Transformer", "chunked_ce_loss", "chunked_ce_sum",
           "check_shardable"]


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
    def forward(ctx, h, w_head, labels, chunk, mean=True):
        t = h.shape[0]
        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        cnt = torch.zeros((), dtype=torch.float32, device=h.device)
        for lo, hi in _chunks(t, chunk):
            # the head is cast to f32 per chunk, as the reference casts it
            part, wgt, _ = _chunk_nll(h[lo:hi], w_head.float(), labels[lo:hi])
            tot, cnt = tot + part, cnt + wgt.sum()
        denom = torch.clamp_min(cnt, 1.0)
        ctx.save_for_backward(h, w_head, labels, denom)
        ctx.chunk, ctx.mean = chunk, mean
        return tot / denom if mean else tot

    @staticmethod
    def backward(ctx, g):
        h, w_head, labels, denom = ctx.saved_tensors
        dh = torch.empty_like(h) if ctx.needs_input_grad[0] else None
        dw = (torch.zeros(w_head.shape, dtype=torch.float32,
                          device=w_head.device)
              if ctx.needs_input_grad[1] else None)
        scale = g / denom if ctx.mean else g
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
        return (dh, None if dw is None else dw.to(w_head.dtype), None, None,
                None)


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


def chunked_ce_sum(h: torch.Tensor, w_head: torch.Tensor,
                   labels: torch.Tensor, chunk: int = 4096):
    """:func:`chunked_ce_loss` before its mean: ``(sum, count)``, the
    summed nll of the unmasked tokens (differentiable) and their count
    (float32).  Rows of one shard give its part of both, so a mean over
    shards holding different counts divides the summed sums by the summed
    counts."""
    labels = labels.to(device=h.device, dtype=torch.long)
    tot = _ChunkedCE.apply(h, w_head, labels,
                           max(1, min(chunk, h.shape[0])), False)
    return tot, (labels >= 0).to(torch.float32).sum()


def check_shardable(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a family the sharded steps do not
    run yet: a mesh runs the dense decoders (attention + MLP)."""
    todo = sorted({f"the {sl.mixer} mixer" for sl in cfg.super_block
                   if sl.mixer != "attention"}
                  | {f"the {sl.ffn} ffn" for sl in cfg.super_block
                     if sl.ffn not in ("mlp", "none")})
    todo += [what for what, has in (
        ("cross-attention", any(sl.cross_attention for sl in cfg.super_block)),
        ("the encoder", cfg.is_encoder_decoder),
        ("the multimodal prefix", bool(cfg.prefix_tokens)),
        ("sinusoidal positions", cfg.rope_theta is None)) if has]
    if todo:
        raise NotImplementedError(
            f"{cfg.name}: running {' and '.join(todo)} on a mesh is not "
            "ported yet (ROADMAP item 15.7b, the sharded MoE, Mamba2, "
            "encoder-decoder and prefix-LM families); the port runs them on "
            "one card")


def _params(params: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in params.items()})


class _Layer(nn.Module):
    """One sub-layer ``sl`` of the super-block: its mixer (attention or
    Mamba2), cross-attention where ``sl`` has it (whisper's decoder), and
    FFN (MLP, MoE or none) with their norms; parameter names are the
    reference's ``blocks.sub<i>`` keys (``norm_mix``, ``attn`` | ``mamba``,
    ``norm_cross``, ``cross``, ``norm_ffn``, ``mlp`` | ``moe``).  An
    encoder layer is one of attention + MLP (``encoder.blocks.sub0``).

    The residual add that ends a sub-layer is left to the norm after it,
    which fuses the add in front of the norm: :meth:`forward` takes the
    residual stream ``x`` and the previous layer's output ``delta`` not yet
    added (None before the first layer), and returns the stream and its own
    last output (the FFN's, or the mixer's where there is no FFN) for the
    next norm to add."""

    def __init__(self, cfg: ModelConfig, sl, gen, device):
        super().__init__()
        self.mixer, self.ffn = sl.mixer, sl.ffn
        self.cross_attention = sl.cross_attention
        self.norm_mix = _params(L.norm_init(cfg, device=device))
        if sl.mixer == "attention":
            self.attn = _params(L.attention_init(cfg, gen, device))
        else:
            self.mamba = _params(L.mamba2_init(cfg, gen, device))
        if sl.cross_attention:
            self.norm_cross = _params(L.norm_init(cfg, device=device))
            self.cross = _params(L.attention_init(cfg, gen, device))
        if sl.ffn != "none":
            self.norm_ffn = _params(L.norm_init(cfg, device=device))
        if sl.ffn == "mlp":
            self.mlp = _params(L.mlp_init(cfg, gen, device))
        elif sl.ffn == "moe":
            self.moe = _params(L.moe_init(cfg, gen, device))

    def _mix(self, h, ops, cache, cache_len, cache_size, rolling,
             prefix_len):
        cfg = ops.cfg
        if self.mixer == "mamba2":
            if cache is None:
                return L.mamba2_apply(self.mamba, h, cfg)
            return L.mamba2_decode(self.mamba, h, cache, cfg)
        if cache is None:
            return ops.attention_prefill(
                self.attn, h, window=cfg.sliding_window,
                prefix_len=prefix_len, cache_size=cache_size)
        return ops.attention_decode(
            self.attn, h, cache, cache_len, window=cfg.sliding_window,
            rolling=rolling)

    def forward(self, x, delta, ops, *, cache=None, cache_len=None,
                cache_size=None, rolling=False, prefix_len=0, enc_out=None):
        """A prefill (``cache`` None: returns the new cache) or a decode
        step (writes ``cache``); ``enc_out`` is the encoder's output a
        prefill's cross-attention reads, and whose keys and values it
        stashes as the cache's ``"cross"`` entry for the decode.  ``ops``
        runs the sub-layers (:class:`_LocalOps`, or on a mesh
        ``models/sharded.py::ShardedOps``)."""
        cfg, kernels = ops.cfg, ops.kernels
        x, h = ops.add_norm(self.norm_mix, x, delta)
        prefill = cache is None
        mix, cache = self._mix(h, ops, cache, cache_len, cache_size, rolling,
                               prefix_len)
        mix = ops.residual(mix)
        if self.cross_attention:
            x, h = ops.add_norm(self.norm_cross, x, mix)
            if prefill:
                mix, cache["cross"] = L.cross_attention_prefill(
                    self.cross, h, enc_out, cfg, kernels=kernels)
            else:
                mix, _ = L.attention_decode(
                    self.cross, h, None, cache_len, cfg,
                    enc_cache=cache["cross"], kernels=kernels)
        if self.ffn == "none":
            return x, mix, cache
        x, h = ops.add_norm(self.norm_ffn, x, mix)
        if self.ffn == "moe":
            return x, L.moe_apply(self.moe, h, cfg)[0], cache
        return x, ops.residual(ops.mlp(self.mlp, h)), cache

    def train_forward(self, x, delta, ops, causal=True, prefix_len=0,
                      enc_out=None):
        """The whole-sequence form of :meth:`forward`, no cache: the
        training form (causal, under the config's window, its first
        ``prefix_len`` positions seen by every query, cross-attention over
        ``enc_out`` where the layer has it) or, ``causal=False``, an
        encoder layer (bidirectional, no window).  Returns ``(x, out,
        aux)``: the stream, the layer's last output not yet added (the
        FFN's, or the mixer's where there is no FFN) and MoE's Switch
        auxiliary loss (None without an MoE FFN)."""
        cfg = ops.cfg
        x, h = ops.add_norm(self.norm_mix, x, delta)
        if self.mixer == "mamba2":
            mix = L.mamba2_apply(self.mamba, h, cfg)[0]
        else:
            mix = ops.attention(self.attn, h, causal=causal,
                                window=cfg.sliding_window if causal else None,
                                prefix_len=prefix_len)
        mix = ops.residual(mix)
        if self.cross_attention:
            x, h = ops.add_norm(self.norm_cross, x, mix)
            mix = ops.residual(L.attention_apply(self.cross, h, cfg,
                                                 enc_out=enc_out,
                                                 kernels=ops.kernels))
        if self.ffn == "none":
            return x, mix, None
        x, h = ops.add_norm(self.norm_ffn, x, mix)
        if self.ffn == "moe":
            y, aux = L.moe_apply(self.moe, h, cfg)
            return x, ops.residual(y), aux
        return x, ops.residual(ops.mlp(self.mlp, h)), None


class _LocalOps:
    """The sub-layers and the model's ends on one device: the plain layers
    of ``models/layers.py`` with the model's kernels (``use_kernels`` read
    at each call).  :meth:`Transformer.distribute` puts
    ``models/sharded.py::ShardedOps`` in its place, the same calls on a
    mesh; ``residual`` is where the reference constrains the residual
    stream, nothing here."""

    def __init__(self, model):
        self.model, self.cfg = model, model.cfg

    @property
    def kernels(self) -> bool:
        return self.model.use_kernels

    def residual(self, x):
        return x

    def tokens(self, tokens):
        return self.model._tokens(tokens)

    def embed(self, tokens, offset: int = 0):
        return self.model._embed_tokens(tokens, offset)

    def add_norm(self, p, x, delta):
        return L.add_norm_apply(p, x, delta, self.cfg, kernels=self.kernels)

    def attention(self, p, h, *, causal=True, window=None, prefix_len=0):
        return L.attention_apply(p, h, self.cfg, causal=causal, window=window,
                                 prefix_len=prefix_len, kernels=self.kernels)

    def attention_prefill(self, p, h, *, window=None, cache_size=None,
                          prefix_len=0):
        return L.attention_prefill(p, h, self.cfg, window=window,
                                   prefix_len=prefix_len,
                                   cache_size=cache_size,
                                   kernels=self.kernels)

    def attention_decode(self, p, h, cache, cache_len, *, window=None,
                         rolling=False):
        return L.attention_decode(p, h, cache, cache_len, self.cfg,
                                  window=window, rolling=rolling,
                                  kernels=self.kernels)

    def mlp(self, p, h):
        return L.mlp_apply(p, h, self.cfg)

    def loss(self, h, labels):
        b, s, d = h.shape
        # the reference's measurement mode: one chunk of every token
        chunk = b * s if self.cfg.scan_unroll else 4096
        return chunked_ce_loss(h.reshape(b * s, d), self.model._head(),
                               labels.reshape(-1), chunk=chunk)

    def logits(self, x, delta):
        return self.model._logits(x, delta)


def zero_layer_cache(cfg: ModelConfig, mixer: str, batch: int, width: int,
                     device, enc_seq: int | None = None) -> dict:
    """One layer's zero decode cache (tensors on ``device``, which may be
    ``meta``); ``enc_seq`` adds the cross-attention's ``"cross"`` entry,
    ``{"k", "v"}`` of ``(batch, Hkv, enc_seq, Dh)``."""
    dt = getattr(torch, cfg.dtype)
    if mixer == "attention":
        kv = (batch, cfg.num_kv_heads, width, cfg.resolved_head_dim)
        cache = {"k": torch.zeros(kv, dtype=dt, device=device),
                 "v": torch.zeros(kv, dtype=dt, device=device)}
    else:
        conv = (batch, cfg.ssm_conv - 1, cfg.ssm_d_inner + 2 * cfg.ssm_state)
        ssm = (batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim)
        cache = {"conv": torch.zeros(conv, dtype=dt, device=device),
                 "ssm": torch.zeros(ssm, dtype=torch.float32, device=device)}
    if enc_seq is not None:
        kv = (batch, cfg.num_kv_heads, enc_seq, cfg.resolved_head_dim)
        cache["cross"] = {"k": torch.zeros(kv, dtype=dt, device=device),
                          "v": torch.zeros(kv, dtype=dt, device=device)}
    return cache


class Transformer(nn.Module):
    """A model of the zoo with random weights from ``seed`` on ``device``
    (the CUDA card by default; raises without one unless ``device="cpu"``).
    An encoder-decoder also holds ``encoder`` (its layers) and
    ``encoder_norm`` (the reference's ``encoder.blocks`` and
    ``encoder.final_norm``).

    ``use_kernels=False`` runs the plain versions of the flash attention and
    RMSNorm kernels instead, on any device; it exists so the kernels can be
    held against them on the card.  ``device="meta"`` gives the parameters'
    names and shapes with no storage.

    ``policy`` (``models/sharding.py``) is how the model maps onto a mesh;
    :meth:`distribute` places the parameters on one as DTensors, after
    which the same layer loop of :meth:`train_loss`, :meth:`prefill` and
    :meth:`decode_step` runs its sub-layers through
    ``models/sharded.py::ShardedOps`` in place of :class:`_LocalOps`, the
    dense decoders only.
    """

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device="cuda",
                 use_kernels: bool = True, policy=NO_SHARDING):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.use_kernels = use_kernels
        self.policy = policy
        self._mesh = None
        # a meta tensor draws nothing: no generator there
        gen = (None if dev.type == "meta"
               else torch.Generator(device=dev).manual_seed(seed))
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
        if cfg.is_encoder_decoder:
            enc = SubLayer(mixer="attention", ffn="mlp")
            self.encoder = nn.ModuleList(_Layer(cfg, enc, gen, dev)
                                         for _ in range(cfg.encoder_layers))
            self.encoder_norm = _params(L.norm_init(cfg, device=dev))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def _ops(self):
        """What runs the sub-layers: made per call, so the model holds no
        reference to it (a cycle would keep a deleted model's card memory
        until the cycle collector runs)."""
        if self._mesh is None:
            return _LocalOps(self)
        from .sharded import ShardedOps
        return ShardedOps(self, self._mesh)

    # ============================================================= the mesh
    def distribute(self, mesh) -> "Transformer":
        """Place every parameter on ``mesh`` (a named ``DeviceMesh``) as a
        DTensor: the rank keeps its shard of each, as ``self.policy``'s
        ``param_specs`` sanitized against its shape place it.  Every rank
        must hold the same weights before the call.  Returns the model."""
        from . import sharded

        if not self.policy.enabled:
            raise ValueError("distribute needs an enabled ShardingPolicy")
        check_shardable(self.cfg)
        for name, pl in sharded.param_placements(self, mesh).items():
            owner, _, key = name.rpartition(".")
            mod = self.get_submodule(owner) if owner else self
            old = getattr(mod, key) if not isinstance(
                mod, nn.ParameterDict) else mod[key]
            new = nn.Parameter(sharded.shard_tensor(old.detach(), mesh, pl))
            if isinstance(mod, nn.ParameterDict):
                mod[key] = new
            else:
                setattr(mod, key, new)
        self._mesh = mesh
        return self

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

    def _embeds(self, x, name: str, seq: int | None = None) -> torch.Tensor:
        """The input embeddings ``x`` (B, seq, d_model) on the model's device
        in its dtype (the reference CLI feeds f32: ROADMAP §3)."""
        if x is None:
            raise ValueError(f"{self.cfg.name} takes batch[{name!r}]")
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        if x.dim() != 3 or x.shape[2] != self.cfg.d_model or (
                seq is not None and x.shape[1] != seq):
            raise ValueError(f"{name} must be (B, {seq or 'S'}, "
                             f"{self.cfg.d_model}), got {tuple(x.shape)}")
        return x.to(device=self.device, dtype=self.embed.dtype)

    # ============================================================ encoder
    def encode(self, enc_embeds) -> torch.Tensor:
        """The encoder over the (stub) frame embeddings ``enc_embeds`` (B,
        Se, d_model): sinusoidal positions, ``encoder_layers`` layers of
        bidirectional attention + MLP, the final norm (the reference's
        ``encode``).  Differentiable (the training loss runs it under
        autograd); serving calls it under ``torch.no_grad``."""
        x = self._embeds(enc_embeds, "enc_embeds")
        pos = L.sinusoidal_positions(x.shape[1], self.cfg.d_model,
                                     device=x.device)
        x, delta = x + pos[None].to(x.dtype), None
        for layer in self.encoder:
            x, delta, _ = layer.train_forward(x, delta, self._ops,
                                              causal=False)
        return L.add_norm_apply(self.encoder_norm, x, delta, self.cfg,
                                kernels=self.use_kernels)[1]

    # ================================================================ train
    def train_loss(self, batch: dict) -> torch.Tensor:
        """The mean next-token loss of ``batch["tokens"]`` (B, S) against
        ``batch["labels"]`` (B, S; < 0 masked), differentiable in every
        parameter: the embedding, the layers (each checkpointed when
        ``cfg.remat``), the final norm over every position, then
        :func:`chunked_ce_loss` over the head, plus MoE's Switch auxiliary
        loss summed over the layers in layer order (the reference's
        ``loss + aux``; a model without MoE adds nothing).  A prefix-LM
        prepends ``batch["patch_embeds"]`` (B, P, d_model), seen by every
        query, whose P positions take label -1 (no loss); an
        encoder-decoder encodes ``batch["enc_embeds"]`` (B, Se, d_model)
        under autograd, not checkpointed (the reference checkpoints only its
        decoder's scan body), and every decoder layer's cross-attention
        reads the encoder's output (an input of each layer's checkpoint).
        A missing input raises ``ValueError`` naming it."""
        cfg, ops = self.cfg, self._ops
        tokens, labels = ops.tokens(batch["tokens"]), ops.tokens(
            batch["labels"])
        x = ops.embed(tokens)
        prefix_len = cfg.prefix_tokens
        if prefix_len:
            x = torch.cat([self._embeds(batch.get("patch_embeds"),
                                        "patch_embeds", prefix_len), x],
                          dim=1)
            labels = torch.cat([labels.new_full((labels.shape[0],
                                                 prefix_len), -1), labels],
                               dim=1)
        enc_out = (self.encode(batch.get("enc_embeds"))
                   if cfg.is_encoder_decoder else None)
        x, delta, aux = ops.residual(x), None, None
        for layer in self.layers:
            if cfg.remat:
                x, delta, a = checkpoint(layer.train_forward, x, delta, ops,
                                         prefix_len=prefix_len,
                                         enc_out=enc_out, use_reentrant=False)
            else:
                x, delta, a = layer.train_forward(x, delta, ops,
                                                  prefix_len=prefix_len,
                                                  enc_out=enc_out)
            if a is not None:
                aux = a if aux is None else aux + a
        _, h = ops.add_norm(self.final_norm, x, delta)
        loss = ops.loss(h, labels)
        return loss if aux is None else loss + aux

    # ============================================================== prefill
    @torch.no_grad()
    def prefill(self, batch: dict, *, cache_size: int | None = None):
        """Run the prompt ``batch["tokens"]`` (B, S); returns
        ``(last_logits (B, V) float32, caches, cache_len)`` with attention
        caches of width ``cache_size`` (default the sequence; narrower: the
        rolling cache of the last ``cache_size`` positions), Mamba2 caches
        of the state after the prompt, and ``cache_len`` the sequence's
        length.  A prefix-LM prepends ``batch["patch_embeds"]`` (B, P,
        d_model) to the tokens, seen by every query, so the sequence is P +
        S; an encoder-decoder encodes ``batch["enc_embeds"]`` (B, Se,
        d_model) and its cross-attention layers add the encoder's keys and
        values to their caches (``"cross"``)."""
        cfg, ops = self.cfg, self._ops
        x = ops.embed(ops.tokens(batch["tokens"]))
        prefix_len = cfg.prefix_tokens
        if prefix_len:
            x = torch.cat([self._embeds(batch.get("patch_embeds"),
                                        "patch_embeds", prefix_len), x],
                          dim=1)
        enc_out = (self.encode(batch.get("enc_embeds"))
                   if cfg.is_encoder_decoder else None)
        x, delta = ops.residual(x), None
        caches = []
        for layer in self.layers:
            x, delta, c = layer(x, delta, ops, cache_size=cache_size,
                                prefix_len=prefix_len, enc_out=enc_out)
            caches.append(c)
        return ops.logits(x, delta), caches, int(x.shape[1])

    # =============================================================== decode
    @torch.no_grad()
    def decode_step(self, token, caches: list, cache_len: int, *,
                    rolling: bool = False):
        """One-token step.  ``token`` (B, 1); writes each layer's cache in
        place: attention at slot ``cache_len`` (``cache_len mod W`` with
        ``rolling``, the mod-W cache), Mamba2's conv tail and state;
        cross-attention reads its ``"cross"`` entry and leaves it as it
        is.  Returns ``(logits, caches)``."""
        ops = self._ops
        cache_len = int(cache_len)
        x = ops.residual(ops.embed(ops.tokens(token), offset=cache_len))
        delta = None
        for layer, cache in zip(self.layers, caches):
            x, delta, _ = layer(x, delta, ops, cache=cache,
                                cache_len=cache_len, rolling=rolling)
        return ops.logits(x, delta), caches

    # ======================================================== cache structs
    def make_decode_cache(self, batch: int, cache_width: int,
                          enc_seq: int | None = None) -> list:
        """Zero caches, one per layer: ``{"k", "v"}`` of ``cache_width``
        slots for attention, ``{"conv", "ssm"}`` for Mamba2, and beside
        them, in a layer with cross-attention, ``"cross"``: ``{"k", "v"}``
        of ``enc_seq`` (default ``cfg.encoder_seq``) encoder positions."""
        se = enc_seq or self.cfg.encoder_seq
        return [zero_layer_cache(self.cfg, layer.mixer, batch, cache_width,
                                 self.device,
                                 se if layer.cross_attention else None)
                for layer in self.layers]

    # ============================================================== params N
    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())
