"""Layers of the dense decoder (counterpart of the dense subset of
``repro/models/layers.py``).

Functional, as in the reference: ``*_init(cfg, gen, device) -> params``
(dicts of tensors) and ``*_apply(params, x, ...) -> y``, differentiable
for training (:func:`attention_apply` is the training form).  Attention runs
through :func:`ops.flash_attention` (the hand-written kernel on the card)
where the reference runs its pure-JAX twin ``chunked_attention``; rmsnorm
runs through :func:`ops.rmsnorm`, or :func:`ops.add_rmsnorm` where the
residual add in front of it is fused in (:func:`add_norm_apply`).
``kernels=False`` takes the kernels' plain versions on any device, so the
kernels can be held against them on the card.  Initialisation draws from an
explicit ``torch.Generator`` with the reference's distributions; it cannot
give ``jax.random``'s bits, so parity with the reference goes through
weights carried across (``models/convert.py``).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.flash_attention import flash_attention_plain
from ..kernels.rmsnorm import add_rmsnorm_plain, rmsnorm_plain
from .config import ModelConfig

__all__ = ["norm_init", "norm_apply", "add_norm_apply", "apply_rope",
           "sinusoidal_positions", "attention_init", "attention_apply",
           "attention_prefill", "attention_decode", "mlp_init", "mlp_apply"]

Params = dict[str, torch.Tensor]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _uniform(gen, shape, scale, dtype, device) -> torch.Tensor:
    out = torch.empty(shape, dtype=torch.float32, device=device)
    return out.uniform_(-scale, scale, generator=gen).to(dtype)


def _dense_init(gen, d_in, d_out, dtype, device) -> torch.Tensor:
    return _uniform(gen, (d_in, d_out), math.sqrt(6.0 / (d_in + d_out)),
                    dtype, device)


# ---------------------------------------------------------------------------
# norms & positions
# ---------------------------------------------------------------------------

def norm_init(cfg: ModelConfig, device=None) -> Params:
    d = cfg.d_model
    p = {"scale": torch.ones(d, dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(d, dtype=torch.float32, device=device)
    return p


def norm_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
               eps: float = 1e-6, *, kernels: bool = True) -> torch.Tensor:
    if cfg.norm == "layernorm":
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
        return out.to(x.dtype)
    if kernels:
        return ops.rmsnorm(x, p["scale"], eps=eps)
    return rmsnorm_plain(x, p["scale"], eps=eps)


def add_norm_apply(p: Params, x: torch.Tensor, delta: torch.Tensor | None,
                   cfg: ModelConfig, eps: float = 1e-6, *,
                   kernels: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """The residual add ``x + delta`` and the norm of the sum: returns
    ``(x + delta, norm(x + delta))``, the sum in x's dtype and the norm taken
    from it.  RMSNorm runs both in one :func:`ops.add_rmsnorm` pass;
    layernorm is a plain add, then :func:`norm_apply`.  ``delta`` None means
    nothing to add: ``(x, norm(x))``."""
    if delta is None:
        return x, norm_apply(p, x, cfg, eps, kernels=kernels)
    if cfg.norm == "layernorm":
        x = x + delta
        return x, norm_apply(p, x, cfg, eps, kernels=kernels)
    if kernels:
        return ops.add_rmsnorm(x, delta, p["scale"], eps=eps)
    return add_rmsnorm_plain(x, delta, p["scale"], eps=eps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, H, S, Dh), positions: (S,)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = (positions[:, None].float() * freq[None, :])[None, None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d: int, device=None, *,
                         offset: int = 0) -> torch.Tensor:
    """Absolute encodings of positions ``offset .. offset + seq - 1``."""
    pos = np.arange(offset, offset + seq)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    out = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.as_tensor(out, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# attention sub-layer
# ---------------------------------------------------------------------------

def attention_init(cfg: ModelConfig, gen, device=None) -> Params:
    d, h, hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    dh, dt = cfg.resolved_head_dim, _dtype(cfg)
    p = {
        "wq": _dense_init(gen, d, h * dh, dt, device),
        "wk": _dense_init(gen, d, hkv * dh, dt, device),
        "wv": _dense_init(gen, d, hkv * dh, dt, device),
        "wo": _dense_init(gen, h * dh, d, dt, device),
    }
    if cfg.qkv_bias:
        p["b_q"] = torch.zeros(h * dh, dtype=dt, device=device)
        p["b_k"] = torch.zeros(hkv * dh, dtype=dt, device=device)
        p["b_v"] = torch.zeros(hkv * dh, dtype=dt, device=device)
    return p


def _project_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig):
    b, s, _ = x.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["b_q"], k + p["b_k"], v + p["b_v"]
    q = q.reshape(b, s, h, dh).transpose(1, 2)
    k = k.reshape(b, s, hkv, dh).transpose(1, 2)
    v = v.reshape(b, s, hkv, dh).transpose(1, 2)
    return q, k, v


def _attend(q, k, v, *, window, q_offset, kernels):
    if kernels:
        return ops.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=True, window=window,
                                   q_offset=q_offset)
    return flash_attention_plain(q, k, v, causal=True, window=window,
                                 q_offset=q_offset)


def attention_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                    window: int | None = None,
                    kernels: bool = True) -> torch.Tensor:
    """Full-sequence causal attention, the training form of the reference's
    ``attention_apply`` (no cache; the multimodal prefix is not ported).
    Differentiable: on the card the kernels go through their autograd
    functions (the flash forward with the log-sum-exp and its backward
    kernel), on the CPU and with ``kernels=False`` the plain version runs
    under autograd."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg)
    if cfg.rope_theta is not None:
        pos = torch.arange(s, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    out = _attend(q, k, v, window=window, q_offset=0, kernels=kernels)
    return out.transpose(1, 2).reshape(b, s, -1) @ p["wo"]


def attention_prefill(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                      window: int | None = None,
                      cache_size: int | None = None, kernels: bool = True):
    """Prefill: run causal attention over the prompt AND return its KV cache,
    ``{"k", "v"}`` of width ``cache_size`` (default: the prompt length) with
    the prompt's keys in the first slots and zeros after them."""
    b, s, _ = x.shape
    if cache_size is not None and cache_size < s:
        raise NotImplementedError(
            "a cache narrower than the prompt (the rolling sliding-window "
            "cache) is not ported yet (ROADMAP item 15)")
    q, k, v = _project_qkv(p, x, cfg)
    if cfg.rope_theta is not None:
        pos = torch.arange(s, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    out = _attend(q, k, v, window=window, q_offset=0, kernels=kernels)
    out = out.transpose(1, 2).reshape(b, s, -1)
    size = cache_size or s
    shape = (b, cfg.num_kv_heads, size, cfg.resolved_head_dim)
    k_c = torch.zeros(shape, dtype=k.dtype, device=x.device)
    v_c = torch.zeros(shape, dtype=v.dtype, device=x.device)
    k_c[:, :, :s] = k
    v_c[:, :, :s] = v
    return out @ p["wo"], {"k": k_c, "v": v_c}


def attention_decode(p: Params, x: torch.Tensor, cache: Params,
                     cache_len: int, cfg: ModelConfig, *,
                     window: int | None = None, kernels: bool = True):
    """One-token decode; ``cache_len`` = tokens already in the cache.  Writes
    the new key and value at slot ``cache_len`` IN PLACE (the reference
    returns updated copies) and attends over the whole cache width with the
    query at position ``cache_len``: the causal mask hides the empty slots
    and the window the old ones, the reference's ``valid`` mask."""
    b = x.shape[0]
    width = cache["k"].shape[2]
    if not 0 <= cache_len < width:
        raise ValueError(f"cache_len {cache_len} outside the cache's "
                         f"{width} slots")
    q, k_new, v_new = _project_qkv(p, x, cfg)
    if cfg.rope_theta is not None:
        pos = torch.full((1,), cache_len, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k_new = apply_rope(k_new, pos, cfg.rope_theta)
    cache["k"][:, :, cache_len] = k_new[:, :, 0].to(cache["k"].dtype)
    cache["v"][:, :, cache_len] = v_new[:, :, 0].to(cache["v"].dtype)
    out = _attend(q, cache["k"], cache["v"], window=window,
                  q_offset=cache_len, kernels=kernels)
    out = out.to(x.dtype).transpose(1, 2).reshape(b, 1, -1)
    return out @ p["wo"], cache


# ---------------------------------------------------------------------------
# dense MLP
# ---------------------------------------------------------------------------

def mlp_init(cfg: ModelConfig, gen, device=None) -> Params:
    d, ff, dt = cfg.d_model, cfg.d_ff, _dtype(cfg)
    if cfg.activation == "swiglu":
        return {
            "w_gate": _dense_init(gen, d, ff, dt, device),
            "w_up": _dense_init(gen, d, ff, dt, device),
            "w_down": _dense_init(gen, ff, d, dt, device),
        }
    return {
        "w_in": _dense_init(gen, d, ff, dt, device),
        "b_in": torch.zeros(ff, dtype=dt, device=device),
        "w_out": _dense_init(gen, ff, d, dt, device),
        "b_out": torch.zeros(d, dtype=dt, device=device),
    }


def mlp_apply(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.activation == "swiglu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    # jax.nn.gelu's default is the tanh approximation
    return (F.gelu(x @ p["w_in"] + p["b_in"], approximate="tanh")
            @ p["w_out"] + p["b_out"])
