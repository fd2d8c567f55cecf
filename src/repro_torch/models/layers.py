"""Layers of the architecture zoo (counterpart of
``repro/models/layers.py``).

Functional, as in the reference: ``*_init(cfg, gen, device) -> params``
(dicts of tensors) and ``*_apply(params, x, ...) -> y``.  Attention runs
through :func:`ops.flash_attention` (the hand-written kernel on the card)
where the reference runs its pure-JAX twin ``chunked_attention``: causal
or bidirectional (whisper's encoder), with the prefix-LM mask of a
multimodal prefix (paligemma's ``prefix_len``), and as whisper's
cross-attention over the encoder's output (:func:`attention_apply` with
``enc_out``, :func:`cross_attention_prefill`, and :func:`attention_decode`
with ``enc_cache``); its decode also serves the rolling mod-W cache;
rmsnorm runs through :func:`ops.rmsnorm`, or :func:`ops.add_rmsnorm` where
the residual add in front of it is fused in (:func:`add_norm_apply`).
``kernels=False`` takes the kernels' plain versions on any device, so the
kernels can be held against them on the card.  The mixture-of-experts FFN
(:func:`moe_apply`) and the Mamba2 / SSD mixer (:func:`mamba2_apply`,
:func:`mamba2_decode`) are plain PyTorch, as the reference computes them in
plain ``jnp``; their large products are ``torch.bmm``.  Every layer is
differentiable for training (:func:`attention_apply` is attention's
training form).  MoE and Mamba2 come in pieces a mesh rank can run on its
rows, experts and heads (:func:`moe_route` with a slot offset,
:func:`moe_dispatch`, :func:`mamba2_mix` on some heads,
:func:`_gated_norm` with the mean square from outside), which the
single-card path composes as one call.  Initialisation draws from an explicit
``torch.Generator`` with the reference's distributions; it cannot give
``jax.random``'s bits, so parity with the reference goes through weights
carried across (``models/convert.py``).
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
           "cross_attention_prefill", "attention_prefill", "prefill_cache",
           "attention_decode", "cross_decode_heads", "decode_slot",
           "rolling_slot_positions",
           "mlp_init", "mlp_apply", "moe_init", "moe_capacity", "moe_route",
           "moe_expert_counts", "moe_dispatch", "moe_experts", "moe_combine",
           "moe_aux", "moe_apply", "mamba2_init", "mamba2_mix", "mamba2_ssd",
           "mamba2_apply", "mamba2_decode_mix", "mamba2_step",
           "mamba2_decode"]

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
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
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


def _project_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 kv_input: torch.Tensor | None = None):
    """q from ``x``, k and v from ``kv_input`` (the encoder's output for
    cross-attention) or from ``x``."""
    b, s, _ = x.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    kv_x = x if kv_input is None else kv_input
    skv = kv_x.shape[1]
    q, k, v = x @ p["wq"], kv_x @ p["wk"], kv_x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["b_q"], k + p["b_k"], v + p["b_v"]
    q = q.reshape(b, s, h, dh).transpose(1, 2)
    k = k.reshape(b, skv, hkv, dh).transpose(1, 2)
    v = v.reshape(b, skv, hkv, dh).transpose(1, 2)
    return q, k, v


def _attend(q, k, v, *, window, q_offset, kernels, causal=True,
            prefix_len=0):
    if kernels:
        return ops.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal,
                                   window=window, q_offset=q_offset,
                                   prefix_len=prefix_len)
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, prefix_len=prefix_len)


def _merge_heads(out: torch.Tensor, p: Params) -> torch.Tensor:
    b, _, s, _ = out.shape
    return out.transpose(1, 2).reshape(b, s, -1) @ p["wo"]


def _cross(p: Params, x: torch.Tensor, enc_out: torch.Tensor,
           cfg: ModelConfig, kernels: bool):
    """Cross-attention of ``x`` over ``enc_out``: bidirectional, no RoPE
    (the reference's ``attention_apply(enc_out=)``); returns the output and
    the encoder's k and v."""
    q, k, v = _project_qkv(p, x, cfg, kv_input=enc_out)
    out = _attend(q, k, v, causal=False, window=None, q_offset=0,
                  kernels=kernels)
    return _merge_heads(out, p), k, v


def attention_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                    causal: bool = True, window: int | None = None,
                    prefix_len: int = 0, enc_out: torch.Tensor | None = None,
                    kernels: bool = True) -> torch.Tensor:
    """Full-sequence attention with no cache: the training form, the
    encoder's bidirectional self-attention (``causal=False``) and, with
    ``enc_out``, cross-attention over the encoder's output (bidirectional,
    no RoPE), as the reference's ``attention_apply``; ``prefix_len`` keys
    are seen by every query (the prefix-LM mask).  Differentiable: on the
    card the kernels go through their autograd functions (the flash forward
    with the log-sum-exp and its backward kernel, with the prefix, at every
    head size, and at ``Sq != Sk`` for cross-attention), on the CPU and
    with ``kernels=False`` the plain version runs under autograd."""
    if enc_out is not None:
        return _cross(p, x, enc_out, cfg, kernels)[0]
    s = x.shape[1]
    q, k, v = _project_qkv(p, x, cfg)
    if cfg.rope_theta is not None:
        pos = torch.arange(s, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    out = _attend(q, k, v, causal=causal, window=window, q_offset=0,
                  prefix_len=prefix_len, kernels=kernels)
    return _merge_heads(out, p)


def cross_attention_prefill(p: Params, x: torch.Tensor,
                            enc_out: torch.Tensor, cfg: ModelConfig, *,
                            kernels: bool = True):
    """Cross-attention over ``enc_out`` (B, Se, d) AND the decode's cross
    cache ``{"k", "v"}`` of ``(B, Hkv, Se, Dh)``: the encoder's keys and
    values, projected once for both (the reference projects them a second
    time for the cache, to the same values)."""
    out, k, v = _cross(p, x, enc_out, cfg, kernels)
    return out, {"k": k.contiguous(), "v": v.contiguous()}


def rolling_slot_positions(length: int, width: int) -> np.ndarray:
    """The absolute position held by each of the ``width`` slots of a mod-W
    rolling cache after ``length`` tokens: slot j holds ``(length-1) -
    ((length-1-j) mod W)``, the reference's map (negative: empty)."""
    last = length - 1
    return last - np.mod(last - np.arange(width), width)


def attention_prefill(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                      window: int | None = None, prefix_len: int = 0,
                      cache_size: int | None = None, kernels: bool = True):
    """Prefill: run causal attention over the prompt (its first
    ``prefix_len`` positions seen by every query: the prefix-LM mask) AND
    return its KV cache,
    ``{"k", "v"}`` of width ``cache_size`` (default: the prompt length).  A
    cache at least as wide as the prompt holds its keys in the first slots
    and zeros after them.  A narrower one is the mod-W rolling cache: slot j
    holds the key of position :func:`rolling_slot_positions` ``(S, W)[j]``,
    the last W positions each at ``p mod W``, gathered from the prompt's
    keys (an exact copy, so the cache is bitwise those keys)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg)
    if cfg.rope_theta is not None:
        pos = torch.arange(s, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    out = _attend(q, k, v, window=window, q_offset=0, prefix_len=prefix_len,
                  kernels=kernels)
    out = out.transpose(1, 2).reshape(b, s, -1)
    return out @ p["wo"], prefill_cache(k, v, cache_size)


def prefill_cache(k: torch.Tensor, v: torch.Tensor,
                  cache_size: int | None) -> Params:
    """The prompt's keys and values ``(B, Hkv, S, Dh)`` as a decode cache
    of ``cache_size`` slots (default S): the prompt in the first slots and
    zeros after them, or, narrower than the prompt, the mod-W rolling cache
    (slot j holds position :func:`rolling_slot_positions` ``(S, W)[j]``)."""
    s = k.shape[2]
    if cache_size is not None and cache_size < s:
        src = torch.as_tensor(rolling_slot_positions(s, cache_size),
                              device=k.device)
        return {"k": k[:, :, src].contiguous(), "v": v[:, :, src].contiguous()}
    shape = (*k.shape[:2], cache_size or s, k.shape[3])
    k_c = torch.zeros(shape, dtype=k.dtype, device=k.device)
    v_c = torch.zeros(shape, dtype=v.dtype, device=v.device)
    k_c[:, :, :s] = k
    v_c[:, :, :s] = v
    return {"k": k_c, "v": v_c}


def decode_slot(cache_len: int, width: int, window: int | None,
                rolling: bool) -> tuple[int, int, int | None]:
    """Where a decode step at ``cache_len`` writes its key in a cache of
    ``width`` slots, and the query's ``(q_offset, window)`` for the kernel:
    ``(slot, q_offset, window)`` (see :func:`attention_decode`)."""
    if rolling:
        if cache_len < 0:
            raise ValueError(f"cache_len {cache_len} is negative")
        return cache_len % width, min(cache_len, width - 1), None
    if not 0 <= cache_len < width:
        raise ValueError(f"cache_len {cache_len} outside the cache's "
                         f"{width} slots")
    return cache_len, cache_len, window


def cross_decode_heads(p: Params, x: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor, cfg: ModelConfig,
                       kernels: bool) -> torch.Tensor:
    """One decode step's cross-attention up to ``wo``: a query-only
    projection of ``x`` (B, 1, d) over the encoder's ``k``, ``v``, no RoPE;
    returns the merged heads (B, 1, H * Dh) in ``x``'s dtype.  ``cfg``
    gives the head count (a mesh rank passes its local one)."""
    b, h, dh = x.shape[0], cfg.num_heads, cfg.resolved_head_dim
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["b_q"]
    q = q.reshape(b, 1, h, dh).transpose(1, 2)
    out = _attend(q, k, v, causal=False, window=None, q_offset=0,
                  kernels=kernels)
    return out.to(x.dtype).transpose(1, 2).reshape(b, 1, -1)


def attention_decode(p: Params, x: torch.Tensor, cache: Params | None,
                     cache_len: int, cfg: ModelConfig, *,
                     window: int | None = None, rolling: bool = False,
                     enc_cache: Params | None = None, kernels: bool = True):
    """One-token decode; ``cache_len`` = tokens already in the cache.  Writes
    the new key and value IN PLACE (the reference returns updated copies),
    at slot ``cache_len``, or ``cache_len mod W`` with ``rolling`` (the
    mod-W cache of W = its width slots).

    ``enc_cache`` (the encoder's ``{"k", "v"}`` of
    :func:`cross_attention_prefill`) makes it cross-attention: a query-only
    projection attending over every encoder position, no RoPE, ``cache``
    returned untouched.  No decode rescues a prefix (the reference's
    ``valid`` mask has none), so a prefix-LM decodes causally.

    Without ``rolling`` the query sits at position ``cache_len`` and attends
    over the whole width: the causal mask hides the empty slots and the
    window the old ones, the reference's ``valid`` mask; ``cache_len`` must
    be a slot.  With ``rolling`` any ``cache_len >= 0`` is taken, the window
    is the cache's own width, and the call is the same kernel with other
    arguments: after the write the live slots are exactly ``[0, min(len, W))``
    (len = ``cache_len + 1``; the reference's ``p_j >= 0``), and they hold a
    permutation of the last ``min(len, W)`` positions, every one inside the
    window, with its RoPE angle already applied to its key.  Softmax over a
    set of keys does not depend on their order, so causal attention with
    the query at ``q_offset = min(cache_len, W - 1)`` and no window, which
    sees exactly slots ``0 .. q_offset``, is the reference's
    ``rolling_window_attention`` (which also sums in slot order)."""
    b = x.shape[0]
    if enc_cache is not None:
        return cross_decode_heads(p, x, enc_cache["k"], enc_cache["v"], cfg,
                                  kernels) @ p["wo"], cache
    slot, q_offset, window = decode_slot(cache_len, cache["k"].shape[2],
                                         window, rolling)
    q, k_new, v_new = _project_qkv(p, x, cfg)
    if cfg.rope_theta is not None:
        pos = torch.full((1,), cache_len, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k_new = apply_rope(k_new, pos, cfg.rope_theta)
    cache["k"][:, :, slot] = k_new[:, :, 0].to(cache["k"].dtype)
    cache["v"][:, :, slot] = v_new[:, :, 0].to(cache["v"].dtype)
    out = _attend(q, cache["k"], cache["v"], window=window,
                  q_offset=q_offset, kernels=kernels)
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


# ---------------------------------------------------------------------------
# mixture of experts (capacity-bounded dispatch)
# ---------------------------------------------------------------------------

def moe_init(cfg: ModelConfig, gen, device=None) -> Params:
    d, ff, e, dt = cfg.d_model, cfg.d_ff, cfg.num_experts, _dtype(cfg)
    scale = math.sqrt(6.0 / (d + ff))
    return {
        "router": _dense_init(gen, d, e, torch.float32, device),
        "expert_gate": _uniform(gen, (e, d, ff), scale, dt, device),
        "expert_up": _uniform(gen, (e, d, ff), scale, dt, device),
        "expert_down": _uniform(gen, (e, ff, d), scale, dt, device),
    }


def moe_capacity(tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for ``tokens`` tokens (a host int)."""
    return max(8, int(math.ceil(tokens * cfg.top_k * cfg.capacity_factor
                                / cfg.num_experts)))


def moe_route(p: Params, xf: torch.Tensor, cfg: ModelConfig,
              offset: torch.Tensor | None = None, tokens: int | None = None):
    """The router of ``xf`` (T, d): f32 logits against the f32 router,
    softmax, top-k with ties to the lower expert (a stable descending sort,
    as ``lax.top_k`` breaks them; ``torch.topk`` leaves their order
    unspecified), the top weights renormalised by their sum floored at 1e-9.
    Each (token, choice) takes the next slot of its expert in token-major
    order (the reference's cumsum over the one-hot) and is kept when the
    slot is below :func:`moe_capacity` of ``tokens`` (default T).  The rows
    may be one data rank's block of a global batch of ``tokens`` tokens:
    ``offset`` (E,) then holds the slots of each expert that the earlier
    ranks' tokens take, and a choice's global slot is its slot among the
    block's plus its expert's offset.  Returns ``(probs (T, E), top_w (T,
    K), top_i (T, K), slot (T·K,), keep (T·K,))``, ``slot`` the slot among
    the block's (the global one without ``offset``), 0 where dropped."""
    e, k = cfg.num_experts, cfg.top_k
    acc = torch.promote_types(xf.dtype, torch.float32)
    probs = torch.softmax(xf.to(acc) @ p["router"].to(acc), dim=-1)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :k], top_i[:, :k]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e = top_i.reshape(-1)
    onehot = F.one_hot(flat_e, e)
    slot = (onehot.cumsum(0) - 1).gather(1, flat_e[:, None])[:, 0]
    glob = slot if offset is None else slot + offset[flat_e]
    keep = glob < moe_capacity(tokens or xf.shape[0], cfg)
    return probs, top_w, top_i, torch.where(keep, slot, 0), keep


def moe_expert_counts(p: Params, xf: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    """How many (token, choice) pairs of the rows ``xf`` each expert is
    routed, (E,) int64: the slots the rows take (no gradient)."""
    top_i = moe_route(p, xf, cfg)[2]
    return F.one_hot(top_i.reshape(-1), cfg.num_experts).sum(0)


def moe_dispatch(xf: torch.Tensor, top_i: torch.Tensor, slot: torch.Tensor,
                 keep: torch.Tensor, lo: int, n: int, cap: int):
    """The ``(n, cap, d)`` buffer of experts ``lo .. lo + n - 1``: row
    ``slot`` of expert e holds the token of each kept (token, choice)
    routed to it.  Every other choice (dropped, or another expert's) is
    written to one row past the buffer's end and never read, so no shape
    depends on the routing (it runs on ``meta``) and a choice written
    there gets a zero gradient.  Returns ``(buf, mine (T·K,) bool)``."""
    t, k = top_i.shape
    flat_e = top_i.reshape(-1)
    mine = keep & (flat_e >= lo) & (flat_e < lo + n)
    idx = torch.where(mine, (flat_e - lo) * cap + slot, n * cap)
    tok = torch.arange(t, device=xf.device).repeat_interleave(k)
    buf = xf.new_zeros((n * cap + 1, xf.shape[1]))
    buf[idx] = xf[tok]
    return buf[:-1].view(n, cap, xf.shape[1]), mine


def moe_experts(p: Params, buf: torch.Tensor) -> torch.Tensor:
    """The experts ``p`` holds over their ``(E, C, d)`` buffer: three
    ``torch.bmm``, SiLU(gate) · up, then down."""
    h = F.silu(torch.bmm(buf, p["expert_gate"])) * torch.bmm(
        buf, p["expert_up"])
    return torch.bmm(h, p["expert_down"])


def moe_combine(out_buf: torch.Tensor, top_i: torch.Tensor,
                slot: torch.Tensor, mask: torch.Tensor, top_w: torch.Tensor,
                lo: int = 0) -> torch.Tensor:
    """Each token's output (T, d): its choices' rows of ``out_buf`` (the
    buffer of experts ``lo ..``) weighted by ``top_w`` and summed over K, a
    choice outside ``mask`` adding 0."""
    t, k = top_i.shape
    d = out_buf.shape[-1]
    e_idx = (top_i.reshape(-1) - lo).clamp(0, out_buf.shape[0] - 1)
    y_tok = out_buf[e_idx, slot] * mask[:, None].to(out_buf.dtype)
    return (y_tok.reshape(t, k, d)
            * top_w[..., None].to(out_buf.dtype)).sum(1)


def moe_aux(frac_tokens: torch.Tensor, frac_probs: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """The Switch load-balance term: E · Σ_e (share of the tokens whose
    first choice is e) · (mean router probability of e) ·
    ``router_aux_weight``."""
    return (cfg.num_experts * (frac_tokens * frac_probs).sum()
            * cfg.router_aux_weight)


def moe_apply(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """Top-k routing (:func:`moe_route`) with capacity-bounded dispatch over
    ``x`` (B, S, d); returns ``(y, aux)``.

    The kept (token, choice) rows are written into a zero ``(E, C, d)``
    buffer at their (expert, slot) (:func:`moe_dispatch` over every expert),
    each pair unique, so a plain ``index_put_`` gives the reference's
    scatter-add (``mode="drop"``) without atomics, the same bits on every
    run.  The experts are three
    ``torch.bmm`` over ``(E, C, ·)``, SiLU(gate) · up (:func:`moe_experts`);
    the kept rows are gathered back, weighted by ``top_w`` and summed over K
    (:func:`moe_combine`; a dropped choice adds 0).  ``aux`` is the Switch
    load-balance term (:func:`moe_aux`): training adds it to the loss,
    serving drops it.  Under autograd the gradient reaches the router
    through the top-k weights and ``aux``'s mean probabilities, and the kept
    rows through the ``index_put_`` and the gather back (a dropped choice
    gets none), as the reference's scatter-add and gather differentiate.
    A mesh runs the same pieces on a data rank's rows and a model rank's
    experts (``models/sharded.py::ShardedOps.moe``)."""
    b, s, d = x.shape
    e = cfg.num_experts
    t = b * s
    xf = x.reshape(t, d)
    probs, top_w, top_i, slot, keep = moe_route(p, xf, cfg)
    buf, _ = moe_dispatch(xf, top_i, slot, keep, 0, e, moe_capacity(t, cfg))
    y = moe_combine(moe_experts(p, buf), top_i, slot, keep, top_w)
    aux = moe_aux(F.one_hot(top_i[:, 0], e).float().mean(0), probs.mean(0),
                  cfg)
    return y.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# Mamba2 (SSD, state-space duality, arXiv:2405.21060)
# ---------------------------------------------------------------------------

def mamba2_init(cfg: ModelConfig, gen, device=None) -> Params:
    d, di, n, h = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim, dt = di + 2 * n, _dtype(cfg)

    def f32_uniform(lo, hi):
        return torch.empty(h, dtype=torch.float32, device=device).uniform_(
            lo, hi, generator=gen)

    return {
        "in_proj": _dense_init(gen, d, 2 * di + 2 * n + h, dt, device),
        "conv_w": _uniform(gen, (cfg.ssm_conv, conv_dim),
                           1.0 / math.sqrt(cfg.ssm_conv), dt, device),
        "conv_b": torch.zeros(conv_dim, dtype=dt, device=device),
        "a_log": torch.log(f32_uniform(1.0, 16.0)),
        "dt_bias": torch.log(torch.expm1(f32_uniform(1e-3, 0.1))),
        "d_skip": torch.ones(h, dtype=torch.float32, device=device),
        "ssm_norm": torch.ones(di, dtype=torch.float32, device=device),
        "out_proj": _dense_init(gen, di, d, dt, device),
    }


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor, state: torch.Tensor | None = None):
    """x (B, S, C), w (K, C): the causal depthwise convolution in x's dtype,
    over zeros (or ``state``, the previous K-1 inputs) in front of x.
    Returns ``(y, new_state)``, the new state the last K-1 inputs."""
    k = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    y = xp[:, 0:s] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i]
    return y + b, (xp[:, -(k - 1):] if k > 1 else None)


def _ssd_chunked(xh, dt, a, bmat, cmat, chunk, init_state=None):
    """The SSD chunked scan: xh (B, S, H, P), dt (B, S, H), a (H,), bmat /
    cmat (B, S, N), all f32.  Returns ``(y (B, S, H, P), final_state (B, H,
    N, P))``: a Python loop over the S / chunk chunks carrying the f32
    state (the reference's ``lax.scan``); per-chunk buffers never exceed one
    chunk's.  The intra-chunk product runs as ``M = scores · L · dt``, (B, L,
    L, H), then one batched product with x: never the (B, L, L, H, P)
    tensor a four-operand einsum contracted left to right would build.
    Differentiable (training runs it under autograd and remat)."""
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the SSD "
                         f"chunk {chunk}")
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=xh.device))[None, :, :, None]
    state = (torch.zeros((b, h, n, p), dtype=xh.dtype, device=xh.device)
             if init_state is None else init_state.to(xh.dtype))
    ys = []
    for lo in range(0, s, chunk):
        xk, dtk = xh[:, lo:lo + chunk], dt[:, lo:lo + chunk]
        bk, ck = bmat[:, lo:lo + chunk], cmat[:, lo:lo + chunk]
        da_cum = torch.cumsum(dtk * a, dim=1)                 # (b, L, h)
        da_sum = da_cum[:, -1]                                # (b, h)
        # the upper triangle's raw diff is positive and can overflow exp():
        # zero it first so the unselected branch stays finite (0 · inf would
        # be NaN under autodiff), as the reference's double where
        diff = da_cum[:, :, None, :] - da_cum[:, None, :, :]  # (b, i, j, h)
        lmat = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)), 0.0)
        scores = torch.bmm(ck, bk.transpose(1, 2))            # (b, i, j)
        m = scores[..., None] * lmat * dtk[:, None]           # (b, i, j, h)
        y_diag = torch.matmul(m.permute(0, 3, 1, 2),
                              xk.permute(0, 2, 1, 3))         # (b, h, i, p)
        y_off = torch.einsum("bin,bhnp->bihp", ck, state) \
            * torch.exp(da_cum)[..., None]
        w = torch.exp(da_sum[:, None, :] - da_cum) * dtk      # (b, L, h)
        states = torch.einsum("bjn,bjhp->bhnp", bk, w[..., None] * xk)
        state = torch.exp(da_sum)[:, :, None, None] * state + states
        ys.append(y_diag.permute(0, 2, 1, 3) + y_off)
    return torch.cat(ys, dim=1), state


def _mamba2_split(p: Params, x: torch.Tensor, cfg: ModelConfig, di: int):
    """``x @ in_proj`` split into z (di), the conv input [x, B, C] (di + 2N)
    and dt: the layout of the whole ``in_proj`` with ``di`` channels."""
    n = cfg.ssm_state
    zxbcdt = x @ p["in_proj"]
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n],
            zxbcdt[..., 2 * di + 2 * n:])


def _gate(y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``y · silu(z)`` in y's dtype (f32; f64 for a float64 model)."""
    return y * F.silu(z.to(y.dtype))


def _gated_norm(g: torch.Tensor, p: Params,
                ms: torch.Tensor | None = None) -> torch.Tensor:
    """The gated output ``g`` (:func:`_gate`) normalised by its root mean
    square over the last dim and scaled by ``ssm_norm``, all f32.  ``ms``,
    the rows' mean square (..., 1), comes from outside where ``g`` holds
    only some of d_inner's channels (a model rank's heads)."""
    if ms is None:
        ms = (g * g).mean(-1, keepdim=True)
    return g * torch.rsqrt(ms + 1e-6) * p["ssm_norm"]


def mamba2_mix(p: Params, x: torch.Tensor, cfg: ModelConfig,
               heads: int | None = None, state: Params | None = None):
    """The SSD mixer of x (B, S, d) up to the gated norm on ``heads`` of the
    SSM heads (default all), S a multiple of ``cfg.ssm_chunk``.  ``p`` holds
    those heads' pieces laid out as the whole layer's with d_inner = heads ·
    P: ``in_proj``'s columns [z | x, B, C | dt] (B and C every head's),
    the conv channels [x, B, C], ``a_log``, ``dt_bias`` and ``d_skip``.
    Returns ``(g, cache)``: ``g = y · silu(z)`` (B, S, heads · P) f32 and the
    cache ``{"conv": the last K-1 conv inputs (B, K-1, heads · P + 2N) in
    x's dtype, "ssm": the final state (B, heads, N, P) f32}`` to continue
    from; ``state`` (such a cache) continues an earlier call."""
    h = heads or cfg.ssm_heads
    z, xbc, dt_raw = _mamba2_split(p, x, cfg, h * cfg.ssm_headdim)
    xbc, conv_tail = _causal_depthwise_conv(
        xbc, p["conv_w"], p["conv_b"], None if state is None
        else state.get("conv"))
    g, final = mamba2_ssd(p, z, F.silu(xbc), dt_raw, cfg, h,
                          None if state is None else state.get("ssm"))
    return g, {"conv": conv_tail, "ssm": final}


def mamba2_ssd(p: Params, z: torch.Tensor, xbc: torch.Tensor,
               dt_raw: torch.Tensor, cfg: ModelConfig, heads: int,
               ssm: torch.Tensor | None = None):
    """:func:`mamba2_mix` from the conv's SiLU'd output on: ``z`` (B, S,
    heads · P), ``xbc`` (B, S, heads · P + 2N: the heads' x, then B and C)
    and ``dt_raw`` (B, S, heads) through the chunked scan (from the state
    ``ssm``, default zeros), the skip and the gate.  ``p`` holds the heads'
    ``a_log``, ``dt_bias``, ``d_skip``.  Returns ``(g, final state)``."""
    b, s, _ = z.shape
    n, pd = cfg.ssm_state, cfg.ssm_headdim
    di = heads * pd
    acc = torch.promote_types(xbc.dtype, torch.float32)
    xi = xbc[..., :di].reshape(b, s, heads, pd).to(acc)
    dt = F.softplus(dt_raw.to(acc) + p["dt_bias"])
    y, final = _ssd_chunked(xi, dt, -torch.exp(p["a_log"]),
                            xbc[..., di:di + n].to(acc),
                            xbc[..., di + n:].to(acc), cfg.ssm_chunk, ssm)
    y = (y + xi * p["d_skip"][None, None, :, None]).reshape(b, s, di)
    return _gate(y, z), final


def mamba2_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 state: Params | None = None):
    """The full-sequence SSD forward of x (B, S, d), S a multiple of
    ``cfg.ssm_chunk``.  Returns ``(y, cache)``, the cache ``{"conv": the
    last K-1 conv inputs (B, K-1, d_inner + 2N) in x's dtype, "ssm": the
    final state (B, H, N, P) f32}`` to continue from; ``state`` (such a
    cache) continues an earlier call."""
    g, cache = mamba2_mix(p, x, cfg, state=state)
    return _gated_norm(g, p).to(x.dtype) @ p["out_proj"], cache


def mamba2_decode_mix(p: Params, x: torch.Tensor, cache: Params,
                      cfg: ModelConfig, heads: int | None = None):
    """One token x (B, 1, d) through the O(1) SSD recurrence from ``cache``
    on ``heads`` of the SSM heads (default all; ``p`` and the cache hold
    those heads' pieces, as :func:`mamba2_mix` takes them).  Returns ``(g,
    conv, ssm)``: the gated output (B, 1, heads · P) f32, the new conv tail
    and the new state."""
    h = heads or cfg.ssm_heads
    z, xbc, dt_raw = _mamba2_split(p, x, cfg, h * cfg.ssm_headdim)
    xbc, conv_tail = _causal_depthwise_conv(xbc, p["conv_w"], p["conv_b"],
                                            cache["conv"])
    g, ssm = mamba2_step(p, z, F.silu(xbc), dt_raw, cache["ssm"], cfg, h)
    return g, conv_tail, ssm


def mamba2_step(p: Params, z: torch.Tensor, xbc: torch.Tensor,
                dt_raw: torch.Tensor, ssm: torch.Tensor, cfg: ModelConfig,
                heads: int):
    """:func:`mamba2_decode_mix` from the conv's SiLU'd output on (one
    token, the pieces laid out as :func:`mamba2_ssd` takes them): the
    recurrence from the state ``ssm`` (B, heads, N, P), the skip and the
    gate.  Returns ``(g, new state)``."""
    b = z.shape[0]
    n, pd = cfg.ssm_state, cfg.ssm_headdim
    di = heads * pd
    acc = torch.promote_types(xbc.dtype, torch.float32)
    xi = xbc[:, 0, :di].reshape(b, heads, pd).to(acc)
    bmat, cmat = xbc[:, 0, di:di + n].to(acc), xbc[:, 0, di + n:].to(acc)
    dt = F.softplus(dt_raw[:, 0].to(acc) + p["dt_bias"])      # (B, H)
    da = torch.exp(dt * -torch.exp(p["a_log"]))
    upd = (dt[:, :, None, None] * bmat[:, None, :, None]) * xi[:, :, None, :]
    ssm = da[:, :, None, None] * ssm + upd                    # (B, H, N, P)
    y = torch.einsum("bn,bhnp->bhp", cmat, ssm)
    y = (y + xi * p["d_skip"][None, :, None]).reshape(b, 1, di)
    return _gate(y, z), ssm


def mamba2_decode(p: Params, x: torch.Tensor, cache: Params,
                  cfg: ModelConfig):
    """One token x (B, 1, d) through the O(1) SSD recurrence from ``cache``
    (:func:`mamba2_apply`'s); writes the new conv tail and state into the
    ``cache`` dict and returns ``(y, cache)``."""
    g, cache["conv"], cache["ssm"] = mamba2_decode_mix(p, x, cache, cfg)
    return _gated_norm(g, p).to(x.dtype) @ p["out_proj"], cache
