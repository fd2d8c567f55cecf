"""The encoder-decoder (whisper-small) and the prefix-LM (paligemma-3b) in
the port against the JAX reference.

Reduced configs in float32 with the reference's ``Transformer.init(seed)``
weights carried across by ``params_from_jax``, inputs made with numpy from
a seed: whisper's ``encode``; the prefill logits and every cache leaf (the
self-attention's ``k``/``v``, whisper's ``cross`` keys and values of the
encoder); 8 teacher-forced decode steps' logits and the caches after them
(the cross caches untouched); ``ServeEngine``'s greedy tokens; and the CLI
(``launch.serve --arch whisper-small | paligemma-3b --device cpu``) against
``repro.launch.serve``.  The plain attention with a prefix
(``attention_ref(prefix_len=)``) against the reference's pure-JAX
``chunked_attention(prefix_len=)`` at Dh 64 and 256, with and without a
window; a Python mirror of the flash prefill kernels' key-tile walk with a
prefix; whisper's decode input specs against the reference's;
``params_from_jax`` refusing a missing encoder leaf; and the training
refusals (ROADMAP item 15.10).  Everything runs on the CPU, where the
kernel wrappers take their plain versions."""
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as jserve
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import input_specs as j_input_specs
from repro.models import Transformer as JTransformer
from repro.models.layers import chunked_attention
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import SHAPES, get_config, input_specs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.models import Transformer, params_from_jax
from repro_torch.serve import ServeEngine

# f32 through a few layers: the port's dense attention and torch's GEMMs
# sum in another order than the reference's chunked online softmax and
# XLA's dots (the transformer tests' tolerance)
ATOL, RTOL = 1e-5, 1e-4
B, PROMPT, STEPS = 2, 12, 8
ARCHS = ["whisper-small", "paligemma-3b"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(cfg, rng, b, s):
    """The prompt and the arch's extra input, as the reference CLI draws
    them (tokens, then standard normal embeddings, f32)."""
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s))}
    if cfg.prefix_tokens:
        batch["patch_embeds"] = rng.normal(
            0, 1, (b, cfg.prefix_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = rng.normal(
            0, 1, (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def _jax_batch(batch):
    return {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
            for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(cfg, JAX model, JAX params, port model, batch, forced tokens, cache
    width) for one reduced arch."""
    arch = request.param
    cfg = get_config(arch).reduced()
    jm = JTransformer(j_get_config(arch).reduced())
    jp = jm.init(0)
    model = params_from_jax(_np_tree(jp), cfg, device="cpu")
    rng = np.random.default_rng(len(arch))
    batch = _inputs(cfg, rng, B, PROMPT)
    forced = rng.integers(0, cfg.vocab_size, (B, STEPS))
    width = cfg.prefix_tokens + PROMPT + STEPS + 4
    return cfg, jm, jp, model, batch, forced, width


@pytest.fixture(scope="module")
def reference_run(pair):
    """The reference's prefill and teacher-forced decode logits and
    caches."""
    _, jm, jp, _, batch, forced, width = pair
    prefill = jax.jit(partial(jm.prefill, cache_size=width))
    decode = jax.jit(jm.decode_step)
    logits, caches, cache_len = prefill(jp, _jax_batch(batch))
    out = {"prefill": np.asarray(logits), "prefill_caches": _np_tree(caches),
           "cache_len": int(cache_len)}
    steps = []
    for t in range(STEPS):
        logits, caches = decode(jp, jnp.asarray(forced[:, t:t + 1],
                                                jnp.int32), caches, cache_len)
        cache_len = cache_len + 1
        steps.append(np.asarray(logits))
    out["decode"], out["decode_caches"] = steps, _np_tree(caches)
    return out


def _assert_caches(cfg, caches, want):
    """Every leaf of the port's per-layer caches (``k``, ``v`` and, with
    cross-attention, ``cross.k``, ``cross.v``) against the reference's
    stacked ``blocks.sub0`` caches."""
    assert len(caches) == cfg.num_layers
    ref_sub = want["sub0"]
    for r, c in enumerate(caches):
        leaves = [(("attn", key), c[key]) for key in ("k", "v")]
        if cfg.super_block[0].cross_attention:
            assert set(c) == {"k", "v", "cross"}
            leaves += [(("cross", key), c["cross"][key]) for key in ("k", "v")]
        else:
            assert set(c) == {"k", "v"}
        for (group, key), leaf in leaves:
            w = ref_sub[group][key][r]
            assert tuple(leaf.shape) == w.shape, (r, group, key)
            np.testing.assert_allclose(leaf.numpy(), w, atol=ATOL, rtol=RTOL,
                                       err_msg=f"layer {r} {group}.{key}")


@pytest.mark.parametrize("pair", ["whisper-small"], indirect=True)
def test_encode_matches_reference(pair):
    cfg, jm, jp, model, batch, _, _ = pair
    want = np.asarray(jax.jit(jm.encode)(jp, jnp.asarray(
        batch["enc_embeds"], jnp.float32)))
    got = model.encode(batch["enc_embeds"])
    assert tuple(got.shape) == (B, cfg.encoder_seq, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_prefill_and_decode_match_reference(pair, reference_run):
    """Prefill logits and caches (self and cross), 8 teacher-forced decode
    steps and the caches after them; the cross caches come back as the
    prefill left them."""
    cfg, _, _, model, batch, forced, width = pair
    logits, caches, n = model.prefill(batch, cache_size=width)
    assert n == reference_run["cache_len"] == cfg.prefix_tokens + PROMPT
    np.testing.assert_allclose(logits.numpy(), reference_run["prefill"],
                               atol=ATOL, rtol=RTOL)
    _assert_caches(cfg, caches, reference_run["prefill_caches"])
    cross = [{k: c["cross"][k].clone() for k in ("k", "v")}
             for c in caches if "cross" in c]
    for t in range(STEPS):
        logits, caches = model.decode_step(forced[:, t:t + 1], caches, n + t)
        np.testing.assert_allclose(logits.numpy(),
                                   reference_run["decode"][t], atol=ATOL,
                                   rtol=RTOL, err_msg=f"decode step {t}")
    _assert_caches(cfg, caches, reference_run["decode_caches"])
    for before, c in zip(cross, [c for c in caches if "cross" in c]):
        assert all(torch.equal(before[k], c["cross"][k]) for k in before)


def test_decode_from_zero_caches_matches_prefilled(pair):
    """``make_decode_cache(enc_seq=)`` has the prefill's cache structure:
    filled with a prefill's leaves, a decode step gives the same logits."""
    cfg, _, _, model, batch, forced, width = pair
    _, caches, n = model.prefill(batch, cache_size=width)
    fresh = model.make_decode_cache(B, width)
    for c, f in zip(caches, fresh):
        assert set(c) == set(f)
        for key in c:
            if key == "cross":
                for kk in ("k", "v"):
                    assert f["cross"][kk].shape == c["cross"][kk].shape
                    f["cross"][kk].copy_(c["cross"][kk])
            else:
                assert f[key].shape == c[key].shape
                f[key].copy_(c[key])
    want, _ = model.decode_step(forced[:, :1], caches, n)
    got, _ = model.decode_step(forced[:, :1], fresh, n)
    assert torch.equal(got, want)


def test_generate_greedy_matches_reference(pair):
    cfg, jm, jp, model, batch, _, width = pair
    got = ServeEngine(model, cache_size=width).generate(batch, STEPS)
    want = JServeEngine(jm, jp, cache_size=width).generate(
        _jax_batch(batch), STEPS)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_on_cpu_matches_reference(arch, monkeypatch):
    """``launch.serve --arch <arch> --device cpu`` on the reference's
    weights against ``repro.launch.serve``'s own run: the same drawn batch
    (tokens, then the embeddings); whisper's tokens equal the reference
    CLI's.  The reference CLI's cache of prompt + new + 4 slots leaves no
    room for paligemma's prefix (its decode writes past the last slot,
    which JAX clamps; ROADMAP §3), so paligemma's tokens are held to the
    reference's engine over the drawn batch with the port's cache (the
    prefix too)."""
    import repro_torch.models as models
    from repro_torch.launch.serve import build_parser, llm_main

    argv = ["--arch", arch, "--batch", "2", "--prompt-len", "12",
            "--new-tokens", "6", "--seed", "0"]
    seen = {}

    class Recording(JServeEngine):
        def generate(self, batch, *a, **kw):
            out = super().generate(batch, *a, **kw)
            seen.update(batch=batch, tokens=out, cache=self.cache_size,
                        model=self.model, params=self.params)
            return out

    monkeypatch.setattr(jserve, "ServeEngine", Recording)
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    assert jserve.main() == 0
    jp = seen["params"]
    monkeypatch.setattr(models, "Transformer", lambda cfg, **kw:
                        params_from_jax(_np_tree(jp), cfg, device="cpu"))
    run = llm_main(build_parser().parse_args([*argv, "--device", "cpu"]))
    cfg = run["cfg"]
    assert set(run["batch"]) == set(seen["batch"])
    for key, val in run["batch"].items():
        np.testing.assert_array_equal(np.asarray(val),
                                      np.asarray(seen["batch"][key]))
    width = run["engine"].cache_size
    assert width == cfg.prefix_tokens + 12 + 6 + 4
    if width == seen["cache"]:
        want = seen["tokens"]
    else:
        assert cfg.prefix_tokens, arch
        want = JServeEngine(seen["model"], jp, cache_size=width).generate(
            seen["batch"], 6)
    np.testing.assert_array_equal(run["tokens"], want)


@pytest.mark.parametrize("causal,prefix,cross", [
    (False, 0, False), (True, 5, False), (False, 0, True)])
def test_attention_apply_matches_reference(causal, prefix, cross):
    """``attention_apply`` on the reference's weights: the encoder's
    bidirectional form, a prefix, and cross-attention over ``enc_out``
    (no RoPE; paligemma's config has RoPE, so the cross case shows it is
    skipped)."""
    from repro.models import layers as JL
    from repro_torch.models import layers as L

    cfg = get_config("paligemma-3b").reduced()
    j_cfg = j_get_config("paligemma-3b").reduced()
    jp = _np_tree(JL.attention_init(j_cfg, JL.KeyGen(3)))
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (2, 20, cfg.d_model)).astype(np.float32)
    enc = rng.normal(0, 1, (2, 33, cfg.d_model)).astype(np.float32)
    kw = dict(causal=causal, prefix_len=prefix)
    want = np.asarray(JL.attention_apply(
        jp, jnp.asarray(x), j_cfg, enc_out=jnp.asarray(enc) if cross
        else None, **kw))
    got = L.attention_apply({k: torch.tensor(v) for k, v in jp.items()},
                            torch.as_tensor(x), cfg,
                            enc_out=torch.as_tensor(enc) if cross else None,
                            **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


# ------------------------------------------------------- the prefix mask --

@pytest.mark.parametrize("dh", [64, 256])
@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("causal,q_offset,prefix", [
    (True, 0, 20), (True, 0, 48), (True, 0, 200), (True, 30, 17),
    (False, 0, 20)])
def test_attention_ref_prefix_matches_chunked(dh, window, causal, q_offset,
                                              prefix):
    """The plain attention's prefix-LM mask against the reference's
    ``chunked_attention`` (whose 16-key tiles skip dead tiles unless the
    prefix rescues them): GQA, a prefix inside a tile, on a tile edge, past
    Sk, at a q_offset, and bidirectional (where it changes nothing)."""
    rng = np.random.default_rng(dh + prefix)
    sq, sk = 80 - q_offset, 80
    q = rng.normal(0, 1, (2, 4, sq, dh)).astype(np.float32)
    k = rng.normal(0, 1, (2, 2, sk, dh)).astype(np.float32)
    v = rng.normal(0, 1, (2, 2, sk, dh)).astype(np.float32)
    want = np.asarray(chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, prefix_len=prefix, q_offset=q_offset, chunk_q=16,
        chunk_k=16))
    got = ref.attention_ref(torch.as_tensor(q), torch.as_tensor(k),
                            torch.as_tensor(v), causal=causal, window=window,
                            q_offset=q_offset, prefix_len=prefix)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    # the CPU wrapper is the plain version
    again = fa.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                               torch.as_tensor(v), causal=causal,
                               window=window, q_offset=q_offset,
                               prefix_len=prefix)
    assert torch.equal(again, got)


def _live(sq, sk, causal, window, q_offset, prefix):
    q_pos = np.arange(sq)[:, None] + q_offset
    k_pos = np.arange(sk)[None]
    live = np.ones((sq, sk), bool)
    if causal:
        live &= k_pos <= q_pos
    if window is not None:
        live &= k_pos > q_pos - window
    return live | (k_pos < prefix)


def tile_walk(tile, q_first, q_last, sk, causal, window, prefix):
    """The key tiles ``tile_walk`` in ``csrc/flash_attention.cu`` gives a
    block of query positions ``[q_first, q_last]``, in order."""
    k_hi = min(sk, q_last + 1) if causal else sk
    k_lo = 0 if window is None else max(0, q_first - window + 1)
    lo = k_lo // tile
    hi = -(-k_hi // tile) if k_hi > k_lo else lo
    if prefix <= 0:
        return list(range(lo, hi))
    tp = -(-min(prefix, sk) // tile)
    if lo <= tp:
        return list(range(max(hi, tp)))
    return list(range(tp)) + list(range(lo, hi))


def _edge(k0, tile, sk, causal, window, q_first, q_last, prefix):
    """The mask flag of the tensor-core prefill (a superset of the f32
    kernel's, which masks every tile)."""
    return k0 + tile > sk or (k0 + tile > prefix and (
        (causal and k0 + tile - 1 > q_first)
        or (window is not None and k0 <= q_last - window)))


# the tensor-core prefill's (rows, keys) of a block: 128 x 64 at Dh <= 64,
# 64 x 64 above; the f32 prefill's 64 x 32, and 32 x 16 at Dh 256
@pytest.mark.parametrize("bq,tile", [(64, 64), (128, 64), (64, 32),
                                     (32, 16)])
@pytest.mark.parametrize("sq,sk,causal,window,q_offset,prefix", [
    (200, 200, True, None, 0, 37), (96, 96, True, 16, 0, 64),
    (40, 40, True, None, 0, 64), (300, 300, True, 64, 0, 100),
    (300, 300, True, 50, 0, 70), (48, 170, True, 40, 122, 30),
    (64, 64, False, None, 0, 20), (1, 90, True, None, 50, 70),
    (512, 512, True, None, 0, 256), (512, 512, True, 100, 0, 256),
    (300, 300, True, 0, 0, 10), (70, 70, True, None, 0, 0)])
def test_prefill_tile_walk_covers_every_live_pair(bq, tile, sq, sk, causal,
                                                  window, q_offset, prefix):
    """Every live (query, key) pair of a block of ``bq`` rows lies in
    exactly one visited key tile (one run of tiles, or two with a gap), and
    a tile the tensor-core prefill leaves unmasked is whole and live for
    every row of the block."""
    live = _live(sq, sk, causal, window, q_offset, prefix)
    for q0 in range(0, sq, bq):
        rows = live[q0:q0 + bq]
        q_first, q_last = q_offset + q0, q_offset + min(q0 + bq, sq) - 1
        tiles = tile_walk(tile, q_first, q_last, sk, causal, window, prefix)
        assert len(set(tiles)) == len(tiles)
        seen = np.zeros(sk, bool)
        for t in tiles:
            seen[t * tile:(t + 1) * tile] = True
            if not _edge(t * tile, tile, sk, causal, window, q_first, q_last,
                         prefix):
                assert rows[:, t * tile:(t + 1) * tile].all(), (q0, t)
        assert not (rows & ~seen[None]).any(), q0


# ------------------------------------------------------- specs, refusals --

def test_whisper_decode_specs_match_reference():
    """The decode spec's self and cross caches on ``meta``, against the
    reference's stacked stand-ins."""
    cfg = get_config("whisper-small")
    spec = input_specs(cfg, SHAPES["decode_32k"])
    want = j_input_specs(j_get_config("whisper-small"),
                         J_SHAPES["decode_32k"])["caches"]["sub0"]
    assert len(spec["caches"]) == cfg.num_layers == 12
    for c in spec["caches"]:
        assert set(c) == {"k", "v", "cross"}
        for key in ("k", "v"):
            assert (cfg.num_layers, *c[key].shape) == want["attn"][key].shape
            assert (cfg.num_layers, *c["cross"][key].shape) == \
                want["cross"][key].shape == (12, 128, 12, 1500, 64)
            assert c["cross"][key].device.type == "meta"
    assert not spec["rolling"]


def test_params_from_jax_refuses_a_missing_encoder_leaf():
    cfg = get_config("whisper-small").reduced()
    tree = _np_tree(JTransformer(j_get_config("whisper-small").reduced())
                    .init(0))
    bias = tree["encoder"]["final_norm"].pop("bias")
    with pytest.raises(ValueError, match=r"encoder\.final_norm"):
        params_from_jax(tree, cfg, device="cpu")
    tree["encoder"]["final_norm"]["bias"] = bias
    tree["encoder"]["blocks"]["sub0"]["attn"].pop("b_k")
    with pytest.raises(ValueError, match=r"encoder\.blocks\.sub0\.attn"):
        params_from_jax(tree, cfg, device="cpu")
    del tree["encoder"]
    with pytest.raises(ValueError, match="encoder"):
        params_from_jax(tree, cfg, device="cpu")


@pytest.mark.parametrize("dh,prefix", [(256, 0), (64, 8), (256, 8)])
def test_flash_backward_refuses_dh256_and_a_prefix(dh, prefix):
    """The check ``FlashAttentionFn`` makes before a launch: the backward
    kernel takes Dh <= 128 and no prefix (ROADMAP item 15.10)."""
    with pytest.raises(NotImplementedError, match=r"item 15\.10"):
        fa._check_trainable(dh, prefix)
    fa._check_trainable(128, 0)
    fa._check_trainable(48, 0)     # the kernel inputs' check names it
