"""The rest of the decoder zoo in the port against the JAX reference: the
rolling sliding-window decode, mixture-of-experts FFNs and Mamba2 (SSD)
mixers.

Model cases, float32, the reference's ``Transformer.init(seed)`` weights
carried across by ``params_from_jax``: reduced mamba2-370m, jamba-v0.1-52b,
phi3.5-moe and qwen3-moe, and the rolling mod-W decode of reduced
starcoder2-7b (native window 64) and qwen2-0.5b's ``swa`` variant (window
64) with prompts longer than the window.  Each checks the prefill logits
and every cache leaf (``k``/``v`` in slot order, ``conv``, ``ssm``),
teacher-forced decode logits (2W + 3 steps in the rolling cases, so the
cache wraps twice) and the caches after them, decode from an empty cache,
and greedy ``generate`` tokens.  Unit tests hold ``moe_apply`` (a capacity
overflow and a tied router row included), ``_ssd_chunked``,
``_causal_depthwise_conv``, ``mamba2_decode`` and the rolling prefill's slot
map against the reference's, and the CLI's ``--swa``.  Everything runs on
the CPU, where the kernel wrappers take their plain versions."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import Transformer as JTransformer
from repro.models import layers as JL
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.models import Transformer, params_from_jax
from repro_torch.models import layers as L
from repro_torch.serve import ServeEngine

# f32 through a few layers: the port's dense attention, torch's GEMMs and
# cumsum sum in another order than the reference's chunked online softmax,
# XLA's dots and its scan (the transformer tests' tolerance)
ATOL, RTOL = 1e-5, 1e-4
B = 2
# (arch, variant, rolling, prompt): the Mamba2 prompts are multiples of the
# reduced ssm_chunk (32), the rolling ones longer than the window (64)
ZOO_CASES = [("mamba2-370m", None, False, 64),
             ("jamba-v0.1-52b", None, False, 64),
             ("phi3.5-moe-42b-a6.6b", None, False, 40),
             ("qwen3-moe-235b-a22b", None, False, 40),
             ("starcoder2-7b", None, True, 80),
             ("qwen2-0.5b", "swa", True, 80)]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _case_id(case):
    arch, variant, rolling, _ = case
    return arch + (f"+{variant}" if variant else "") + ("-rolling" if rolling
                                                        else "")


@pytest.fixture(scope="module", params=ZOO_CASES, ids=_case_id)
def zoo(request):
    """(cfg, JAX model, JAX params, port model, prompt, forced tokens,
    cache width, rolling) for one reduced arch."""
    arch, variant, rolling, s = request.param
    cfg = get_config(arch, variant).reduced()
    jm = JTransformer(j_get_config(arch, variant).reduced())
    jp = jm.init(0)
    model = params_from_jax(_np_tree(jp), cfg, device="cpu")
    rng = np.random.default_rng(len(arch) + s)
    steps = 2 * cfg.sliding_window + 3 if rolling else 4
    prompt = rng.integers(0, cfg.vocab_size, (B, s))
    forced = rng.integers(0, cfg.vocab_size, (B, steps))
    width = cfg.sliding_window if rolling else s + steps + 4
    return cfg, jm, jp, model, prompt, forced, width, rolling


@pytest.fixture(scope="module")
def zoo_reference(zoo):
    """The reference's prefill and teacher-forced decode logits and
    caches."""
    _, jm, jp, _, prompt, forced, width, rolling = zoo
    prefill = jax.jit(partial(jm.prefill, cache_size=width))
    decode = jax.jit(partial(jm.decode_step, rolling=rolling))
    logits, caches, cache_len = prefill(jp, {"tokens": jnp.asarray(
        prompt, jnp.int32)})
    out = {"prefill": np.asarray(logits), "prefill_caches": _np_tree(caches)}
    steps = []
    for t in range(forced.shape[1]):
        logits, caches = decode(jp, jnp.asarray(forced[:, t:t + 1],
                                                jnp.int32), caches, cache_len)
        cache_len = cache_len + 1
        steps.append(np.asarray(logits))
    out["decode"], out["decode_caches"] = steps, _np_tree(caches)
    return out


def _assert_caches(cfg, caches, want):
    """Every leaf of the port's per-layer caches against the reference's
    stacked ``blocks.sub<i>`` caches (repeat r, sub-layer i is layer
    ``r · len(super_block) + i``)."""
    nsub = len(cfg.super_block)
    assert len(caches) == cfg.num_layers
    for j, c in enumerate(caches):
        r, i = divmod(j, nsub)
        group = "attn" if cfg.super_block[i].mixer == "attention" else "mamba"
        ref = want[f"sub{i}"][group]
        assert set(c) == set(ref), (j, sorted(c), sorted(ref))
        for key, leaf in c.items():
            w = ref[key][r]
            assert tuple(leaf.shape) == w.shape, (j, key)
            assert leaf.dtype == getattr(torch, str(w.dtype)), (j, key)
            np.testing.assert_allclose(leaf.numpy(), w, atol=ATOL, rtol=RTOL,
                                       err_msg=f"layer {j} {group}.{key}")


def test_zoo_prefill_and_decode_match_reference(zoo, zoo_reference):
    cfg, _, _, model, prompt, forced, width, rolling = zoo
    logits, caches, cache_len = model.prefill({"tokens": prompt},
                                              cache_size=width)
    assert cache_len == prompt.shape[1] and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), zoo_reference["prefill"],
                               atol=ATOL, rtol=RTOL)
    _assert_caches(cfg, caches, zoo_reference["prefill_caches"])
    for t in range(forced.shape[1]):
        logits, caches = model.decode_step(
            torch.as_tensor(forced[:, t:t + 1]), caches, cache_len + t,
            rolling=rolling)
        np.testing.assert_allclose(logits.numpy(), zoo_reference["decode"][t],
                                   atol=ATOL, rtol=RTOL,
                                   err_msg=f"decode step {t}")
    _assert_caches(cfg, caches, zoo_reference["decode_caches"])


def test_zoo_decode_from_empty_cache_matches_reference(zoo):
    cfg, jm, jp, model, _, forced, width, rolling = zoo
    jc = jm.make_decode_cache(B, width)
    caches = model.make_decode_cache(B, width)
    _assert_caches(cfg, caches, _np_tree(jc))
    decode = jax.jit(partial(jm.decode_step, rolling=rolling))
    for t in range(3):
        j_logits, jc = decode(jp, jnp.asarray(forced[:, t:t + 1], jnp.int32),
                              jc, jnp.asarray(t, jnp.int32))
        logits, caches = model.decode_step(forced[:, t:t + 1], caches, t,
                                           rolling=rolling)
        np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                                   atol=ATOL, rtol=RTOL)
    _assert_caches(cfg, caches, _np_tree(jc))
    assert model.param_count() == jm.param_count(jp)


def test_zoo_generate_greedy_matches_reference(zoo):
    cfg, jm, jp, model, prompt, _, width, rolling = zoo
    want = JServeEngine(jm, jp, cache_size=width, rolling=rolling).generate(
        {"tokens": jnp.asarray(prompt, jnp.int32)}, max_new_tokens=6)
    got = ServeEngine(model, cache_size=width, rolling=rolling).generate(
        {"tokens": prompt}, max_new_tokens=6)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _unfused_zoo_pass(model, x, caches=None, cache_len=None, cache_size=None,
                      rolling=False):
    """The decoder pass in the order before the residual adds were fused
    into the norms: every add a separate op (a sub-layer without an FFN
    adds its mixer's output alone), the final norm over every position,
    then the last position kept."""
    cfg, kern = model.cfg, model.use_kernels
    out = []
    for i, layer in enumerate(model.layers):
        h = L.norm_apply(layer.norm_mix, x, cfg, kernels=kern)
        if layer.mixer == "mamba2":
            mix, c = (L.mamba2_apply(layer.mamba, h, cfg) if caches is None
                      else L.mamba2_decode(layer.mamba, h, caches[i], cfg))
        elif caches is None:
            mix, c = L.attention_prefill(layer.attn, h, cfg,
                                         window=cfg.sliding_window,
                                         cache_size=cache_size, kernels=kern)
        else:
            mix, c = L.attention_decode(layer.attn, h, caches[i], cache_len,
                                        cfg, window=cfg.sliding_window,
                                        rolling=rolling, kernels=kern)
        x = x + mix
        if layer.ffn != "none":
            h = L.norm_apply(layer.norm_ffn, x, cfg, kernels=kern)
            x = x + (L.moe_apply(layer.moe, h, cfg)[0] if layer.ffn == "moe"
                     else L.mlp_apply(layer.mlp, h, cfg))
        out.append(c)
    x = L.norm_apply(model.final_norm, x, cfg, kernels=kern)
    return x[:, -1].float() @ model._head().float(), out


@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba-v0.1-52b",
                                  "phi3.5-moe-42b-a6.6b", "starcoder2-7b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_zoo_layer_loop_matches_unfused_order(arch, dtype):
    """The layer loop with the adds fused into the norms gives bitwise the
    logits and caches of the unfused order, at prefill and decode (rolling
    for starcoder2, whose prompt is longer than its window)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    model = Transformer(cfg, seed=0, device="cpu")
    rolling = cfg.sliding_window is not None
    rng = np.random.default_rng(7)
    s = 80 if rolling else 64
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, s)))
    forced = rng.integers(0, cfg.vocab_size, (B, 3))
    width = cfg.sliding_window if rolling else s + 3
    logits, caches, n = model.prefill({"tokens": prompt}, cache_size=width)
    with torch.no_grad():
        want, want_caches = _unfused_zoo_pass(
            model, model._embed_tokens(prompt), cache_size=width)
    assert torch.equal(logits, want)

    def same(a, b):
        assert all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)

    same(caches, want_caches)
    for t in range(forced.shape[1]):
        tok = torch.as_tensor(forced[:, t:t + 1])
        logits, caches = model.decode_step(tok, caches, n + t,
                                           rolling=rolling)
        with torch.no_grad():
            want, want_caches = _unfused_zoo_pass(
                model, model._embed_tokens(tok, offset=n + t), want_caches,
                n + t, rolling=rolling)
        assert torch.equal(logits, want)
    same(caches, want_caches)


# ------------------------------------------------------------------ rolling

@pytest.mark.parametrize("s,w", [(80, 64), (64, 64), (129, 64), (7, 3)])
def test_rolling_prefill_cache_is_the_reference_slot_map(s, w):
    """A prefill cache narrower than the prompt holds, in slot j, bitwise
    the key and value of the reference's position ``(s-1) - ((s-1-j) mod
    W)`` (as the full-width cache holds them); a cache of the prompt's
    width or wider is the full-width one, zero-padded."""
    cfg = get_config("starcoder2-7b").reduced()
    rng = np.random.default_rng(s + w)
    p = {k: torch.from_numpy(rng.normal(0, 0.2, v.shape).astype(np.float32))
         for k, v in L.attention_init(cfg, torch.Generator()).items()}
    x = torch.from_numpy(rng.normal(0, 1, (B, s, cfg.d_model))
                         .astype(np.float32))
    out_full, full = L.attention_prefill(p, x, cfg, window=w, cache_size=s)
    out, roll = L.attention_prefill(p, x, cfg, window=w, cache_size=w)
    assert torch.equal(out, out_full)
    last = s - 1
    src = np.asarray(last - jnp.mod(last - jnp.arange(w), w))
    assert (src == L.rolling_slot_positions(s, w)).all()
    if w < s:
        for key in ("k", "v"):
            assert torch.equal(roll[key], full[key][:, :, src])
    else:
        assert torch.equal(roll["k"], full["k"])
    _, wide = L.attention_prefill(p, x, cfg, window=w, cache_size=s + 5)
    assert torch.equal(wide["k"][:, :, :s], full["k"])
    assert not wide["k"][:, :, s:].any()


@pytest.mark.parametrize("cache_len", [0, 5, 63, 64, 65, 200])
def test_rolling_decode_attention_matches_reference(cache_len):
    """One rolling decode step's attention sublayer against the reference's
    ``attention_decode(rolling=True)`` on the same cache, below, at and
    past the cache width (the query at ``min(cache_len, W - 1)`` sees the
    valid slots in slot order)."""
    cfg = get_config("starcoder2-7b").reduced()
    w = cfg.sliding_window
    rng = np.random.default_rng(cache_len)
    p = {k: rng.normal(0, 0.2, v.shape).astype(np.float32)
         for k, v in L.attention_init(cfg, torch.Generator()).items()}
    shape = (B, cfg.num_kv_heads, w, cfg.resolved_head_dim)
    cache = {k: rng.normal(0, 1, shape).astype(np.float32) for k in "kv"}
    x = rng.normal(0, 1, (B, 1, cfg.d_model)).astype(np.float32)
    j_cfg = j_get_config("starcoder2-7b").reduced()
    want, want_cache = JL.attention_decode(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in cache.items()},
        jnp.asarray(cache_len, jnp.int32), j_cfg, rolling=True)
    got, got_cache = L.attention_decode(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        {k: torch.from_numpy(v.copy()) for k, v in cache.items()}, cache_len,
        cfg, window=cfg.sliding_window, rolling=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    for key in "kv":
        np.testing.assert_allclose(got_cache[key].numpy(),
                                   np.asarray(want_cache[key]), atol=ATOL,
                                   rtol=RTOL)


def test_rolling_decode_refuses_a_negative_length():
    model = Transformer(get_config("starcoder2-7b").reduced(), device="cpu")
    caches = model.make_decode_cache(1, 8)
    with pytest.raises(ValueError, match="negative"):
        model.decode_step(np.zeros((1, 1), np.int64), caches, -1,
                          rolling=True)
    # a rolling cache takes any length past its width
    logits, _ = model.decode_step(np.zeros((1, 1), np.int64), caches, 1000,
                                  rolling=True)
    assert torch.isfinite(logits).all()


# ---------------------------------------------------------------------- MoE

def _moe_params(cfg, rng, tie=False):
    p = {"router": rng.normal(0, 0.05, (cfg.d_model, cfg.num_experts)),
         "expert_gate": rng.normal(0, 0.1, (cfg.num_experts, cfg.d_model,
                                            cfg.d_ff)),
         "expert_up": rng.normal(0, 0.1, (cfg.num_experts, cfg.d_model,
                                          cfg.d_ff)),
         "expert_down": rng.normal(0, 0.1, (cfg.num_experts, cfg.d_ff,
                                            cfg.d_model))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    if tie:   # experts 1 and 2 get equal logits for every token
        p["router"][:, 2] = p["router"][:, 1]
    return p


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "qwen3-moe-235b-a22b"])
@pytest.mark.parametrize("case", ["plain", "overflow", "tied"])
def test_moe_apply_matches_reference(arch, case):
    """``(y, aux)`` against the reference's ``moe_apply``: a plain route, a
    capacity overflow (capacity_factor 0.2: 8 slots an expert for 144
    choices drop most of them) and a router whose experts 1 and 2 tie on every token
    (ties go to the lower expert, as ``lax.top_k``)."""
    cfg = get_config(arch).reduced()
    j_cfg = j_get_config(arch).reduced()
    if case == "overflow":
        cfg = dataclasses.replace(cfg, capacity_factor=0.2)
        j_cfg = dataclasses.replace(j_cfg, capacity_factor=0.2)
    rng = np.random.default_rng(len(case))
    p = _moe_params(cfg, rng, tie=case == "tied")
    x = rng.normal(0, 1, (3, 24, cfg.d_model)).astype(np.float32)
    want_y, want_aux = JL.moe_apply({k: jnp.asarray(v) for k, v in p.items()},
                                    jnp.asarray(x), j_cfg)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    y, aux = L.moe_apply(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    probs, top_w, top_i, slot, keep = L.moe_route(
        tp, torch.from_numpy(x.reshape(-1, cfg.d_model)), cfg)
    j_w, j_i = jax.lax.top_k(jnp.asarray(probs.numpy()), cfg.top_k)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(j_i))
    cap = L.moe_capacity(x.shape[0] * x.shape[1], cfg)
    kept = np.stack([top_i.reshape(-1)[keep].numpy(), slot[keep].numpy()], 1)
    assert len(np.unique(kept, axis=0)) == len(kept)   # (expert, slot) unique
    assert (slot.numpy() < cap).all()
    if case == "overflow":
        assert cap == 8 and (~keep).sum() > 0
    elif case == "plain":
        assert keep.all()
    if case == "tied":
        both = (top_i == 1).any(1) & (top_i == 2).any(1)
        assert both.any()
        assert (top_i[both, 0] == 1).all()


# ------------------------------------------------------------------- Mamba2

def _mamba_cfgs(arch="mamba2-370m"):
    return get_config(arch).reduced(), j_get_config(arch).reduced()


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(with_state):
    rng = np.random.default_rng(3)
    b, s, h, p, n, chunk = 2, 96, 4, 8, 16, 32
    xh = rng.normal(0, 1, (b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.001, 0.5, (b, s, h)).astype(np.float32)
    a = -rng.uniform(1, 16, h).astype(np.float32)
    bm, cm = (rng.normal(0, 1, (b, s, n)).astype(np.float32) for _ in range(2))
    st = (rng.normal(0, 1, (b, h, n, p)).astype(np.float32) if with_state
          else None)
    want_y, want_s = JL._ssd_chunked(
        *(jnp.asarray(v) for v in (xh, dt, a, bm, cm)), chunk,
        None if st is None else jnp.asarray(st))
    y, final = L._ssd_chunked(*(torch.from_numpy(v)
                                for v in (xh, dt, a, bm, cm)), chunk,
                              None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(final.numpy(), np.asarray(want_s), atol=ATOL,
                               rtol=RTOL)
    with pytest.raises(ValueError, match="95 is not a multiple .* 32"):
        L._ssd_chunked(*(torch.from_numpy(v[:, :95]) for v in (xh, dt)),
                       torch.from_numpy(a),
                       *(torch.from_numpy(v[:, :95]) for v in (bm, cm)), 32)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 2, 9])
def test_causal_depthwise_conv_matches_reference(with_state, s):
    rng = np.random.default_rng(s)
    k, c = 4, 24
    x = rng.normal(0, 1, (2, s, c)).astype(np.float32)
    w = rng.normal(0, 1, (k, c)).astype(np.float32)
    bias = rng.normal(0, 1, c).astype(np.float32)
    st = rng.normal(0, 1, (2, k - 1, c)).astype(np.float32) if with_state \
        else None
    want_y, want_s = JL._causal_depthwise_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
        None if st is None else jnp.asarray(st))
    y, new = L._causal_depthwise_conv(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
        None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-6,
                               rtol=1e-6)
    assert torch.equal(new, torch.from_numpy(np.asarray(want_s)))


@pytest.fixture(scope="module")
def mamba_params():
    cfg, j_cfg = _mamba_cfgs()
    jp = JL.mamba2_init(j_cfg, JL.KeyGen(1))
    tp = {k: torch.from_numpy(np.asarray(v)) for k, v in jp.items()}
    return cfg, j_cfg, jp, tp


def test_mamba2_apply_and_decode_match_reference(mamba_params):
    cfg, j_cfg, jp, tp = mamba_params
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (B, 64, cfg.d_model)).astype(np.float32)
    nxt = rng.normal(0, 1, (B, 1, cfg.d_model)).astype(np.float32)
    want, wc = JL.mamba2_apply(jp, jnp.asarray(x), j_cfg)
    got, gc = L.mamba2_apply(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    for key in ("conv", "ssm"):
        np.testing.assert_allclose(gc[key].numpy(), np.asarray(wc[key]),
                                   atol=ATOL, rtol=RTOL)
    want_d, wc = JL.mamba2_decode(jp, jnp.asarray(nxt), wc, j_cfg)
    got_d, gc = L.mamba2_decode(tp, torch.from_numpy(nxt), gc, cfg)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=ATOL,
                               rtol=RTOL)
    for key in ("conv", "ssm"):
        np.testing.assert_allclose(gc[key].numpy(), np.asarray(wc[key]),
                                   atol=ATOL, rtol=RTOL)


def test_mamba2_decode_continues_apply(mamba_params):
    """Decoding token S+1 from the cache of a full-sequence pass over S
    tokens equals the pass over S+1 tokens (run with a chunk of 1, so S+1
    is a multiple of it): output and cache; and an apply continuing from a
    state equals the pass over the concatenation."""
    cfg, _, _, tp = mamba_params
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(0, 1, (B, 65, cfg.d_model))
                         .astype(np.float32))
    one = dataclasses.replace(cfg, ssm_chunk=1)
    full, full_c = L.mamba2_apply(tp, x, one)
    _, cache = L.mamba2_apply(tp, x[:, :64], cfg)
    y, cache = L.mamba2_decode(tp, x[:, 64:], cache, cfg)
    np.testing.assert_allclose(y.numpy(), full[:, 64:].numpy(), atol=ATOL,
                               rtol=RTOL)
    for key in ("conv", "ssm"):
        np.testing.assert_allclose(cache[key].numpy(), full_c[key].numpy(),
                                   atol=ATOL, rtol=RTOL)
    _, first = L.mamba2_apply(tp, x[:, :32], cfg)
    rest, rest_c = L.mamba2_apply(tp, x[:, 32:64], cfg, state=first)
    whole, whole_c = L.mamba2_apply(tp, x[:, :64], cfg)
    np.testing.assert_allclose(rest.numpy(), whole[:, 32:].numpy(),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(rest_c["ssm"].numpy(),
                               whole_c["ssm"].numpy(), atol=ATOL, rtol=RTOL)


def test_mamba2_refuses_a_ragged_prompt():
    model = Transformer(get_config("mamba2-370m").reduced(), device="cpu")
    with pytest.raises(ValueError, match="multiple of the SSD chunk 32"):
        model.prefill({"tokens": np.zeros((1, 33), np.int64)})


# ---------------------------------------------------- layout and refusals

def test_jamba_layers_follow_the_super_block():
    cfg = get_config("jamba-v0.1-52b").reduced()
    model = Transformer(cfg, device="cpu")
    assert len(model.layers) == cfg.num_layers == 8
    for j, layer in enumerate(model.layers):
        sl = cfg.super_block[j % len(cfg.super_block)]
        groups = {n for n, _ in layer.named_children()}
        want = {"norm_mix", "attn" if sl.mixer == "attention" else "mamba"}
        if sl.ffn != "none":
            want |= {"norm_ffn", sl.ffn}
        assert groups == want, (j, groups)
    caches = model.make_decode_cache(2, 16)
    assert set(caches[0]) == {"k", "v"} and set(caches[1]) == {"conv", "ssm"}
    assert caches[1]["ssm"].dtype == torch.float32


@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba-v0.1-52b",
                                  "phi3.5-moe-42b-a6.6b",
                                  "qwen3-moe-235b-a22b"])
def test_train_loss_refuses_the_served_families(arch):
    model = Transformer(get_config(arch).reduced(), device="cpu")
    tokens = np.zeros((1, 32), np.int64)
    with pytest.raises(NotImplementedError, match=r"ROADMAP item 15\.9"):
        model.train_loss({"tokens": tokens, "labels": tokens})


def test_decode_specs_build_mamba_caches():
    from repro_torch.configs import SHAPES, input_specs
    cfg = get_config("jamba-v0.1-52b")
    spec = input_specs(cfg, SHAPES["decode_32k"])
    assert len(spec["caches"]) == cfg.num_layers
    assert spec["caches"][1]["ssm"].shape == (128, cfg.ssm_heads,
                                              cfg.ssm_state, cfg.ssm_headdim)
    assert spec["caches"][0]["k"].device.type == "meta"
    spec = input_specs(get_config("starcoder2-7b"), SHAPES["long_500k"])
    assert spec["rolling"] and spec["caches"][0]["k"].shape[2] == 4096
    spec = input_specs(get_config("whisper-small"), SHAPES["decode_32k"])
    assert spec["caches"][0]["cross"]["k"].shape == (128, 12, 1500, 64)
    assert spec["caches"][0]["k"].shape == (128, 12, 32768, 64)


def test_rolling_serve_step_runs():
    from repro_torch.configs import InputShape
    from repro_torch.launch.steps import build_step
    cfg = get_config("starcoder2-7b").reduced()
    shape = InputShape("long", 256, 1, "decode")
    built = build_step(cfg, shape)
    assert built.arg_specs["rolling"]
    model = Transformer(cfg, device="cpu")
    caches = model.make_decode_cache(1, cfg.sliding_window)
    logits, caches = built.step(model, np.zeros((1, 1), np.int64), caches,
                                200)
    assert torch.isfinite(logits).all()


# ---------------------------------------------------------------- the CLI

@pytest.mark.parametrize("arch", ["qwen2-0.5b", "starcoder2-7b",
                                  "mamba2-370m"])
def test_swa_cli_on_cpu_matches_reference(arch, monkeypatch):
    """``launch.serve --swa`` on the reference's weights: qwen2-0.5b and
    mamba2-370m take the ``swa`` variant (window 64 reduced; mamba2 has no
    attention cache to roll) and starcoder2-7b keeps its native window, all
    decoding with ``rolling`` from a cache of the window's width, with
    greedy tokens equal to the reference's rolling ``ServeEngine``."""
    import repro_torch.models as models
    from repro_torch.launch.serve import build_parser, llm_main
    native = j_get_config(arch).sliding_window is not None
    j_cfg = (j_get_config(arch) if native
             else j_get_config(arch, "swa")).reduced()
    jm = JTransformer(j_cfg)
    jp = jm.init(0)
    monkeypatch.setattr(models, "Transformer", lambda cfg, **kw:
                        params_from_jax(_np_tree(jp), cfg, device="cpu"))
    run = llm_main(build_parser().parse_args(
        ["--arch", arch, "--swa", "--device", "cpu", "--batch", "2",
         "--prompt-len", "96", "--new-tokens", "5"]))
    cfg = run["cfg"]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)
    width = cfg.sliding_window
    assert run["engine"].rolling and run["engine"].cache_size == width == 64
    want = JServeEngine(jm, jp, cache_size=width, rolling=True).generate(
        {"tokens": jnp.asarray(run["batch"]["tokens"], jnp.int32)},
        max_new_tokens=5)
    np.testing.assert_array_equal(run["tokens"], want)
