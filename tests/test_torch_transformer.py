"""The port's dense decoder and serving engine against the JAX reference.

Reduced ``qwen2-0.5b`` (GQA, QKV bias, tied head), ``llama3.2-1b`` and
``starcoder2-7b`` (layernorm, gelu, untied head, native window 64) in
float32, with the reference's ``Transformer.init(seed)`` weights carried
across by ``params_from_jax``: prefill logits and KV caches, teacher-forced
decode steps, decode from an empty cache and greedy ``generate`` tokens.
The layer loop with the residual adds fused into the norms against the
unfused order, bitwise.  Also the copied configs, the EOS rules of ``ServeEngine`` (mirrors of
``tests/test_system.py``'s scripted-model tests), the families that serve
but do not train (whisper, paligemma) and the CLI.  Everything runs on the CPU, where the kernel wrappers take
their plain versions."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.models import Transformer as JTransformer
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import ARCH_IDS, SWA_SERVE_WINDOW, get_config
from repro_torch.models import Transformer, params_from_jax
from repro_torch.models import layers as L
from repro_torch.serve import ServeEngine

# f32 through two layers: the port's dense attention and torch's GEMMs sum
# in another order than the reference's chunked online softmax and XLA's
ATOL, RTOL = 1e-5, 1e-4
# (arch, ModelConfig overrides): the last case swaps RoPE for the
# sinusoidal absolute positions no shipped dense config uses
PARITY_CASES = [("qwen2-0.5b", {}), ("llama3.2-1b", {}),
                ("starcoder2-7b", {}), ("qwen2-0.5b", {"rope_theta": None})]
B, DECODE_STEPS = 2, 4
# starcoder2's reduced window is 64: a longer prompt makes it bite
PROMPT = {"qwen2-0.5b": 24, "llama3.2-1b": 24, "starcoder2-7b": 80}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=PARITY_CASES,
                ids=lambda c: c[0] + "".join(f"-{k}={v}" for k, v in c[1].items()))
def pair(request):
    """(cfg, JAX model, JAX params, port model, prompt, forced tokens,
    cache width) for one reduced arch."""
    arch, overrides = request.param
    cfg = dataclasses.replace(get_config(arch).reduced(), **overrides)
    jm = JTransformer(dataclasses.replace(j_get_config(arch).reduced(),
                                          **overrides))
    jp = jm.init(0)
    model = params_from_jax(_np_tree(jp), cfg, device="cpu")
    rng = np.random.default_rng(len(arch))
    s = PROMPT[arch]
    prompt = rng.integers(0, cfg.vocab_size, (B, s))
    forced = rng.integers(0, cfg.vocab_size, (B, DECODE_STEPS))
    return cfg, jm, jp, model, prompt, forced, s + DECODE_STEPS + 4


@pytest.fixture(scope="module")
def reference_run(pair):
    """The reference's prefill and teacher-forced decode logits and
    caches."""
    _, jm, jp, _, prompt, forced, width = pair
    prefill = jax.jit(partial(jm.prefill, cache_size=width))
    decode = jax.jit(jm.decode_step)
    logits, caches, cache_len = prefill(jp, {"tokens": jnp.asarray(
        prompt, jnp.int32)})
    out = {"prefill": np.asarray(logits), "prefill_caches": _np_tree(caches)}
    steps = []
    for t in range(DECODE_STEPS):
        logits, caches = decode(jp, jnp.asarray(forced[:, t:t + 1], jnp.int32),
                                caches, cache_len)
        cache_len = cache_len + 1
        steps.append(np.asarray(logits))
    out["decode"], out["decode_caches"] = steps, _np_tree(caches)
    return out


def _stacked(caches, key):
    return torch.stack([c[key] for c in caches]).numpy()


def test_prefill_and_decode_match_reference(pair, reference_run):
    cfg, _, _, model, prompt, forced, width = pair
    logits, caches, cache_len = model.prefill({"tokens": prompt},
                                              cache_size=width)
    assert cache_len == prompt.shape[1] and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), reference_run["prefill"],
                               atol=ATOL, rtol=RTOL)
    for key in ("k", "v"):
        want = reference_run["prefill_caches"]["sub0"]["attn"][key]
        assert _stacked(caches, key).shape == want.shape
        np.testing.assert_allclose(_stacked(caches, key), want, atol=ATOL,
                                   rtol=RTOL)
    for t in range(DECODE_STEPS):
        logits, caches = model.decode_step(
            torch.as_tensor(forced[:, t:t + 1]), caches, cache_len + t)
        np.testing.assert_allclose(logits.numpy(), reference_run["decode"][t],
                                   atol=ATOL, rtol=RTOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(
            _stacked(caches, key),
            reference_run["decode_caches"]["sub0"]["attn"][key], atol=ATOL,
            rtol=RTOL)


def test_decode_from_empty_cache_matches_reference(pair):
    cfg, jm, jp, model, _, forced, width = pair
    jc = jm.make_decode_cache(B, width)
    caches = model.make_decode_cache(B, width)
    for t in range(2):
        j_logits, jc = jax.jit(jm.decode_step)(
            jp, jnp.asarray(forced[:, t:t + 1], jnp.int32), jc,
            jnp.asarray(t, jnp.int32))
        logits, caches = model.decode_step(forced[:, t:t + 1], caches, t)
        np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                                   atol=ATOL, rtol=RTOL)
    assert model.param_count() == jm.param_count(jp)


def test_generate_greedy_matches_reference(pair):
    cfg, jm, jp, model, prompt, _, width = pair
    want = JServeEngine(jm, jp, cache_size=width).generate(
        {"tokens": jnp.asarray(prompt, jnp.int32)}, max_new_tokens=6)
    got = ServeEngine(model, cache_size=width).generate(
        {"tokens": prompt}, max_new_tokens=6)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_temperature_sampling_is_seeded(pair):
    cfg, _, _, model, prompt, _, width = pair
    eng = ServeEngine(model, cache_size=width)
    a = eng.generate({"tokens": prompt}, 5, temperature=0.8, seed=3)
    b = eng.generate({"tokens": prompt}, 5, temperature=0.8, seed=3)
    np.testing.assert_array_equal(a, b)
    assert ((a >= 0) & (a < cfg.vocab_size)).all()


def _unfused_pass(model, x, caches=None, cache_len=None, cache_size=None):
    """The decoder pass in the order before the residual add was fused into
    the norms: every add a separate op, the final norm over every position,
    then the last position kept."""
    cfg = model.cfg
    out = []
    for i, layer in enumerate(model.layers):
        h = L.norm_apply(layer.norm_mix, x, cfg, kernels=model.use_kernels)
        if caches is None:
            mix, c = L.attention_prefill(layer.attn, h, cfg,
                                         window=cfg.sliding_window,
                                         cache_size=cache_size,
                                         kernels=model.use_kernels)
        else:
            mix, c = L.attention_decode(layer.attn, h, caches[i], cache_len,
                                        cfg, window=cfg.sliding_window,
                                        kernels=model.use_kernels)
        x = x + mix
        h = L.norm_apply(layer.norm_ffn, x, cfg, kernels=model.use_kernels)
        x = x + L.mlp_apply(layer.mlp, h, cfg)
        out.append(c)
    x = L.norm_apply(model.final_norm, x, cfg, kernels=model.use_kernels)
    return x[:, -1].float() @ model._head().float(), out


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "llama3.2-1b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_layer_loop_matches_unfused_order(arch, dtype):
    """The layer loop with the adds fused into the norms gives bitwise the
    logits and caches of the unfused order, at prefill and decode."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    model = Transformer(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(5)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, 24)))
    forced = rng.integers(0, cfg.vocab_size, (B, 3))
    width = 24 + 3
    logits, caches, n = model.prefill({"tokens": prompt}, cache_size=width)
    with torch.no_grad():
        want, want_caches = _unfused_pass(model, model._embed_tokens(prompt),
                                          cache_size=width)
    assert torch.equal(logits, want)
    for c, w in zip(caches, want_caches):
        assert torch.equal(c["k"], w["k"]) and torch.equal(c["v"], w["v"])
    for t in range(forced.shape[1]):
        tok = torch.as_tensor(forced[:, t:t + 1])
        logits, caches = model.decode_step(tok, caches, n + t)
        with torch.no_grad():
            want, want_caches = _unfused_pass(
                model, model._embed_tokens(tok, offset=n + t), want_caches,
                n + t)
        assert torch.equal(logits, want)
    for c, w in zip(caches, want_caches):
        assert torch.equal(c["k"], w["k"]) and torch.equal(c["v"], w["v"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_final_norm_on_last_position_is_bitwise(dtype, norm):
    """Adding and normalising the last position alone gives bitwise the last
    row of adding and normalising every position."""
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(), norm=norm)
    rng = np.random.default_rng(9)
    x, delta = (torch.from_numpy(rng.normal(0, 1, (B, 64, cfg.d_model))
                                 .astype(np.float32)).to(getattr(torch, dtype))
                for _ in range(2))
    p = {k: torch.from_numpy(rng.normal(1, 0.1, cfg.d_model)
                             .astype(np.float32))
         for k in L.norm_init(cfg)}
    s_all, h_all = L.add_norm_apply(p, x, delta, cfg)
    s_last, h_last = L.add_norm_apply(p, x[:, -1:].contiguous(),
                                      delta[:, -1:].contiguous(), cfg)
    assert torch.equal(s_last, s_all[:, -1:])
    assert torch.equal(h_last, h_all[:, -1:])


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_configs_equal_reference(arch):
    assert ARCH_IDS == J_ARCH_IDS
    pairs = [(get_config(arch), j_get_config(arch)),
             (get_config(arch).reduced(), j_get_config(arch).reduced())]
    if j_get_config(arch).sliding_window is None:
        pairs.append((get_config(arch, "swa"), j_get_config(arch, "swa")))
    else:   # a native window refuses the variant in both packages
        for get in (get_config, j_get_config):
            with pytest.raises(ValueError, match="unknown variant"):
                get(arch, "swa")
    for port, ref in pairs:
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert (port.resolved_head_dim, port.num_layers,
                port.supports_long_context) == (
            ref.resolved_head_dim, ref.num_layers, ref.supports_long_context)
    assert SWA_SERVE_WINDOW == 8192


@pytest.mark.parametrize("arch,item", [("whisper-small", "15.10"),
                                       ("paligemma-3b", "15.10")])
def test_unsupported_families_raise(arch, item):
    """The encoder-decoder and the multimodal prefix train since ROADMAP
    item 15.10 (their loss and gradients against the reference are
    ``tests/test_torch_encdec_train.py``'s): ``train_loss`` gives a finite
    scalar with a gradient.  ``launch.train llm``, which feeds only
    tokens and labels as the reference's ``run_llm`` does, fails naming
    the input the arch lacks, and no longer the item."""
    import repro_torch.launch.train as T

    cfg = get_config(arch).reduced()
    model = Transformer(cfg, device="cpu")
    tokens = np.zeros((1, 8), np.int64)
    extra = ("enc_embeds", cfg.encoder_seq) if cfg.is_encoder_decoder \
        else ("patch_embeds", cfg.prefix_tokens)
    batch = {"tokens": tokens, "labels": tokens,
             extra[0]: np.zeros((1, extra[1], cfg.d_model), np.float32)}
    loss = model.train_loss(batch)
    assert loss.dim() == 0 and torch.isfinite(loss) and loss.requires_grad
    with pytest.raises(ValueError, match=extra[0]) as err:
        T.run_llm(T.build_parser().parse_args(
            ["llm", "--arch", arch, "--shards", "2", "--d-model", "64",
             "--seq", "16", "--docs", "64", "--steps", "1", "--device",
             "cpu"]))
    assert item not in str(err.value)


def test_rolling_cache_and_swa_raise():
    """A decode outside a non-rolling cache's slots raises; the rolling
    cache and ``--swa`` serve (``tests/test_torch_zoo.py``)."""
    model = Transformer(get_config("starcoder2-7b").reduced(), device="cpu")
    caches = model.make_decode_cache(1, 4)
    with pytest.raises(ValueError, match="outside"):
        model.decode_step(np.zeros((1, 1), np.int64), caches, 4)
    with pytest.raises(ValueError, match="outside"):
        model.decode_step(np.zeros((1, 1), np.int64), caches, -1)


def test_llm_cli_on_cpu():
    from repro_torch.launch.serve import build_parser, main
    from repro_torch.launch.serve import llm_main
    run = llm_main(build_parser().parse_args(
        ["--device", "cpu", "--batch", "2", "--prompt-len", "8",
         "--new-tokens", "3"]))
    assert run["tokens"].shape == (2, 3)
    assert run["launches"] == {"prefill": (0, 0, 0), "decode": [(0, 0, 0)] * 2}
    assert len(run["decode_ms"]) == 2 and run["prefill_ms"] > 0
    assert main(["--device", "cpu", "--arch", "llama3.2-1b", "--batch", "1",
                 "--prompt-len", "4", "--new-tokens", "2"]) == 0


# --------------------------------------------------- EOS / done semantics --

class _ScriptedModel:
    """Stub whose decode emits a fixed per-row token script: logits put all
    mass on script[:, cache_len + 1], so greedy decoding replays the script
    (mirror of tests/test_system.py's stub)."""

    def __init__(self, script):
        self.script = torch.as_tensor(np.asarray(script))
        self.vocab = int(np.asarray(script).max()) + 1

    def _onehot(self, col):
        return torch.nn.functional.one_hot(col, self.vocab).float() * 10.0

    def prefill(self, batch, *, cache_size=None):
        return self._onehot(self.script[:, 0]), {"t": 0}, 0

    def decode_step(self, token, caches, cache_len, *, rolling=False):
        col = min(cache_len + 1, self.script.shape[1] - 1)
        return self._onehot(self.script[:, col]), caches


def test_serve_engine_freezes_rows_past_eos():
    eos = 9
    script = np.array([[5, eos, 7, 6, 5, 4], [eos, 3, 4, 5, 6, 7],
                       [1, 2, 3, 4, 5, 6]])
    out = ServeEngine(_ScriptedModel(script), cache_size=8).generate(
        {"tokens": np.zeros((3, 4), np.int32)}, max_new_tokens=5, eos_id=eos)
    np.testing.assert_array_equal(out, [[5, eos, eos, eos, eos],
                                        [eos, eos, eos, eos, eos],
                                        [1, 2, 3, 4, 5]])


def test_serve_engine_pads_to_max_new_tokens_when_all_done():
    eos = 9
    script = np.array([[3, eos, 1, 1, 1], [eos, 2, 2, 2, 2]])
    out = ServeEngine(_ScriptedModel(script), cache_size=8).generate(
        {"tokens": np.zeros((2, 4), np.int32)}, max_new_tokens=5, eos_id=eos)
    np.testing.assert_array_equal(out, [[3, eos, eos, eos, eos],
                                        [eos, eos, eos, eos, eos]])
    solo = ServeEngine(_ScriptedModel(script[:1]), cache_size=8).generate(
        {"tokens": np.zeros((1, 4), np.int32)}, max_new_tokens=5, eos_id=eos)
    np.testing.assert_array_equal(solo, out[:1])


def test_serve_engine_truncates_when_all_done_with_flag():
    eos = 9
    script = np.array([[3, eos, 1, 1, 1], [eos, 2, 2, 2, 2]])
    out = ServeEngine(_ScriptedModel(script), cache_size=8).generate(
        {"tokens": np.zeros((2, 4), np.int32)}, max_new_tokens=5, eos_id=eos,
        truncate_done=True)
    np.testing.assert_array_equal(out, [[3, eos], [eos, eos]])


def test_serve_engine_skips_trailing_decode():
    script = np.array([[1, 2, 3, 4, 5, 6]])
    model = _ScriptedModel(script)
    calls = []
    inner = model.decode_step
    model.decode_step = lambda *a, **k: (calls.append(1), inner(*a, **k))[1]
    out = ServeEngine(model, cache_size=8).generate({"tokens": np.zeros((1, 4), np.int32)},
                          max_new_tokens=4)
    np.testing.assert_array_equal(out, [[1, 2, 3, 4]])
    assert len(calls) == 3
