"""Training the encoder-decoder (whisper-small) and the prefix-LM
(paligemma-3b) in the port against the JAX reference, on the CPU (where the
kernel wrappers run their plain versions under autograd).

- ``Transformer.train_loss`` and every parameter's gradient (the encoder's,
  the cross-attention's) against ``jax.value_and_grad`` of the reference's
  ``train_loss``, with the port's remat on and off: whisper's encoder
  under autograd and its decoder's cross-attention, paligemma's patch
  embeddings prepended and their labels masked;
- the plain attention's gradient (``attention_ref``, the CPU's training
  attention) against ``jax.vjp`` of the reference's
  ``chunked_attention``: the prefix-LM mask at Dh 64 and 256, with and
  without a window, an MQA group of 8, and cross-attention at ``Sq != Sk``,
  not causal;
- ``build_step``'s train step (one AdamW step) and its personalize step
  over 2 partitions against the reference's ``build_step`` steps, the
  extra inputs carried in the batch with a partition axis;
- the encoder's input dtype in training (the port casts ``enc_embeds`` and
  ``patch_embeds`` to the model's dtype: a deliberate difference).

Reduced f32 configs, the reference's ``Transformer.init(0)`` weights
carried by ``params_from_jax``; inputs made with numpy from a seed."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import Transformer as JTransformer
from repro.models.layers import chunked_attention
from repro_torch.configs import InputShape, get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import Transformer, params_from_jax
from _torch_threads import one_torch_thread  # noqa: F401

# f32 through two reduced layers (whisper: two encoder and two decoder
# layers): torch's GEMMs and dense attention sum in another order than
# XLA's dots and the reference's chunked online softmax; a gradient is
# compared relative to its largest entry, as tests/test_torch_zoo_train.py
# compares the other families'
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
# the weights after one AdamW step, held as tests/test_torch_zoo_train.py
# holds them: within STEP_REL of the model's largest weight where the
# reference gradient of the step's objective is above GRAD_FLOOR.  The
# first update is -lr g / (|g| + eps) - lr wd w, so an entry whose gradient
# is near 0 turns with that gradient's rounding by up to 2 lr: entries whose
# reference gradient is at most GRAD_FLOOR are held to 2 lr + STEP_ATOL
# instead.  WD makes the decay term, lr wd |w|, 10 STEP_REL at the largest
# weight, so a step that dropped it fails; the personalize step's prox
# gradient, 2 lambda (w - w_G), sets the sign of the update where the
# loss's gradient is smaller than it, so a step that dropped it fails too
STEP_REL = 1e-5
STEP_ATOL = 1e-4
GRAD_FLOOR = 1e-6
LR, WD = 1e-3, 0.1
# attention alone in f32: the dense softmax against the chunked online
# softmax, O(1) inputs (the reference's own f32 attention tolerance)
ATTN_ATOL, ATTN_RTOL = 1e-5, 1e-4

ARCHS = ["whisper-small", "paligemma-3b"]
B, SEQ = 2, 24


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(cfg, b, s, seed, masked=3):
    """Tokens, next-token labels (the last and the first ``masked``
    positions -1) and the arch's extra input: standard normal f32
    ``enc_embeds`` (B, encoder_seq, d) or ``patch_embeds`` (B, P, d)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((b, 1), -1, np.int32)],
                            axis=1)
    labels[:, :masked] = -1
    batch = {"tokens": tokens, "labels": labels}
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = rng.normal(
            0, 1, (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.prefix_tokens:
        batch["patch_embeds"] = rng.normal(
            0, 1, (b, cfg.prefix_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _blocks_of(named, prefix, n, like):
    """``<prefix>.<r>.<group>.<key>`` for r < n stacked as the reference's
    ``blocks.sub0`` tree ``like`` (one sub-layer a super-block)."""
    return {"sub0": {g: {k: torch.stack([named[f"{prefix}.{r}.{g}.{k}"]
                                         for r in range(n)])
                         for k in leaves}
                     for g, leaves in like["sub0"].items()}}


def _tree_of(named, cfg, like):
    """Tensors of the port keyed by parameter name (weights or gradients)
    laid out as the reference's parameter tree ``like``: the decoder's
    layers as ``blocks.sub0``, the encoder's as ``encoder.blocks.sub0``
    and its final norm as ``encoder.final_norm``."""
    assert len(cfg.super_block) == 1
    out = {"embed": named["embed"],
           "final_norm": {k: named[f"final_norm.{k}"]
                          for k in like["final_norm"]},
           "blocks": _blocks_of(named, "layers", cfg.num_layers,
                                like["blocks"])}
    if "lm_head" in like:
        out["lm_head"] = named["lm_head"]
    if "encoder" in like:
        enc = like["encoder"]
        out["encoder"] = {
            "blocks": _blocks_of(named, "encoder", cfg.encoder_layers,
                                 enc["blocks"]),
            "final_norm": {k: named[f"encoder_norm.{k}"]
                           for k in enc["final_norm"]}}
    return out


def _step_close(named, cfg, want, grads, what):
    """The port's weights after a step (``named``, by parameter name)
    against the reference's tree ``want``, by the STEP_REL / GRAD_FLOOR
    rule; ``grads``: the reference's gradient of the step's objective, a
    tree like ``want``."""
    flat, _ = jax.tree_util.tree_flatten_with_path(_np_tree(want))
    got = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda t: t.detach().numpy(), _tree_of(named, cfg, want),
        is_leaf=lambda x: isinstance(x, torch.Tensor)))
    scale = max(float(np.abs(w).max()) for _, w in flat)
    for (path, w), have, g in zip(flat, got, jax.tree_util.tree_leaves(
            _np_tree(grads))):
        name = f"{what} {jax.tree_util.keystr(path)}"
        assert have.shape == w.shape == g.shape, name
        diff = np.abs(have - w)
        small = np.abs(g) <= GRAD_FLOOR
        assert diff[~small].max(initial=0) <= STEP_REL * scale, (
            name, float(diff[~small].max(initial=0)), scale)
        assert (diff[small] <= 2 * LR + STEP_ATOL).all(), name


def _tree_close(port_tree, ref_tree, rtol, atol, what, relative=False):
    """Leaf by leaf, the port's tree against the reference's; ``relative``
    scales ``atol`` by each reference leaf's largest entry, or, for a key
    bias ``b_k``, by that of its projection's ``wk``: whisper has no RoPE,
    so q . b_k is the same for every key of a query, the softmax leaves
    b_k a gradient of 0 in exact arithmetic and both sides give rounding
    alone (paligemma has no QKV bias)."""
    ref_np = _np_tree(ref_tree)
    flat_j, _ = jax.tree_util.tree_flatten_with_path(ref_np)
    flat_p = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda t: t.detach().numpy(), port_tree,
        is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert len(flat_j) == len(flat_p)
    for (path, want), have in zip(flat_j, flat_p):
        name = f"{what} {jax.tree_util.keystr(path)}"
        assert have.shape == want.shape, name
        assert np.isfinite(have).all(), name
        scale = 1.0
        if relative:
            keys = [p.key for p in path]
            like = want
            if keys[-1] == "b_k":
                node = ref_np
                for k in keys[:-1]:
                    node = node[k]
                like = node["wk"]
            scale = float(np.abs(like).max()) or 1.0
        np.testing.assert_allclose(have, want, rtol=rtol, atol=atol * scale,
                                   err_msg=name)


@functools.cache
def _reference(arch):
    """The reference's reduced model of ``arch``, its seed-0 parameters,
    and its loss and every gradient on ``_batch(seed=5)``: computed once
    for both of the port's remat settings (XLA's remat replays the same
    values, so remat off compiles the smaller program)."""
    jm = JTransformer(dataclasses.replace(j_get_config(arch).reduced(),
                                          remat=False))
    jp = jm.init(0)
    batch = _batch(get_config(arch).reduced(), B, SEQ, seed=5)
    jl, jg = jax.jit(jax.value_and_grad(jm.train_loss))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return jp, batch, float(jl), _np_tree(jg)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_encdec_train_loss_and_grads_match_reference(arch, remat):
    """The loss and the gradient of every parameter (the encoder's and
    its final norm's, the cross-attention's and its norm's; the embedding
    through the tied head and the tokens, not the patch embeddings)
    against ``jax.value_and_grad(Transformer.train_loss)``, the port's
    decoder layers checkpointed (``remat``) or not."""
    jp, batch, jl, jg = _reference(arch)
    cfg = dataclasses.replace(get_config(arch).reduced(), remat=remat)
    model = params_from_jax(_np_tree(jp), cfg, device="cpu")
    loss = model.train_loss(batch)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert loss.shape == () and torch.isfinite(loss)
    np.testing.assert_allclose(loss.item(), jl, rtol=LOSS_RTOL)
    _tree_close(_tree_of(dict(zip(names, grads)), cfg, jg), jg, GRAD_RTOL,
                GRAD_RTOL, "grad", relative=True)


def test_encoder_input_takes_the_model_dtype():
    """A deliberate difference (ROADMAP §3): the port casts ``enc_embeds``
    (and ``patch_embeds``) to the model's dtype before the encoder, where
    the reference's ``encode`` computes in the input's dtype.  A bf16
    model fed f32 embeddings trains exactly as on the embeddings rounded to
    bf16 by the caller."""
    for arch, name in (("whisper-small", "enc_embeds"),
                       ("paligemma-3b", "patch_embeds")):
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype="bfloat16")
        model = Transformer(cfg, seed=0, device="cpu")
        batch = _batch(cfg, B, SEQ, seed=3)
        rounded = {**batch, name: torch.as_tensor(batch[name]).to(
            torch.bfloat16)}
        with torch.no_grad():
            assert torch.equal(model.train_loss(batch),
                               model.train_loss(rounded))


# (b, hq, hkv, sq, sk, dh, causal, window, prefix_len): paligemma's MQA
# group of 8 with a prefix at Dh 64 and 256, a window whose live range
# leaves a gap after the prefix, a prefix past a tile edge; whisper's
# cross-attention (Sq != Sk, bidirectional) and its encoder's
# self-attention (bidirectional)
ATTN_CASES = [
    (1, 8, 1, 40, 40, 64, True, None, 12),
    (1, 8, 1, 40, 40, 256, True, None, 12),
    (1, 4, 2, 70, 70, 64, True, 16, 20),
    (1, 8, 1, 70, 70, 256, True, 16, 20),
    (1, 4, 2, 50, 50, 64, True, None, 45),
    (1, 4, 4, 24, 70, 64, False, None, 0),
    (1, 8, 1, 24, 70, 256, False, None, 0),
    (1, 4, 4, 60, 60, 64, False, None, 0),
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_grad_matches_chunked_vjp(case):
    """dq, dk, dv of the plain attention (what the CPU trains through, and
    what the card's backward kernel is held to) against ``jax.vjp`` of the
    reference's ``chunked_attention`` with the same mask."""
    b, hq, hkv, sq, sk, dh, causal, window, prefix = case
    rng = np.random.default_rng(sq * 100 + sk + dh)
    arrays = [rng.normal(0, 1, s).astype(np.float32)
              for s in ((b, hq, sq, dh), (b, hkv, sk, dh), (b, hkv, sk, dh),
                        (b, hq, sq, dh))]
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    # jitted: one compile, where the eager vjp dispatches op by op
    want = jax.jit(lambda q, k, v, g: jax.vjp(
        lambda q, k, v: chunked_attention(q, k, v, **kw), q, k, v)[1](g))(
            *(jnp.asarray(a) for a in arrays))
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays[:3]]
    out = fa.flash_attention(*leaves, **kw)
    got = torch.autograd.grad(out, leaves, torch.tensor(arrays[3]))
    for name, g, w in zip("qkv", got, want):
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATTN_ATOL,
                                   rtol=ATTN_RTOL, err_msg=f"d{name}")


# ----------------------------------------------------------- the steps --

@pytest.fixture(scope="module")
def one_device_mesh():
    from repro.launch.mesh import make_mesh_compat
    return make_mesh_compat((1, 1), ("data", "model"))


@pytest.mark.parametrize("arch", ARCHS)
def test_build_step_train_matches_reference(arch, one_device_mesh):
    """One generalize step of ``build_step(cfg, shape)`` (no mesh) from the
    same weights and batch, the extra input in the batch: the loss and
    every updated weight against the reference's ``build_step`` step (on
    ``_reference``'s weights and batch, whose gradient sets GRAD_FLOOR's
    mask)."""
    from repro.launch.steps import build_step as j_build_step
    from repro.train.optim import AdamW as JAdamW
    from repro_torch.launch.steps import build_step
    from repro_torch.train.optim import AdamW

    cfg, jcfg = get_config(arch).reduced(), j_get_config(arch).reduced()
    shape = InputShape("tiny_train", SEQ + cfg.prefix_tokens, B, "train")
    jp, batch, _, jg = _reference(arch)
    jopt = JAdamW(lr=LR, weight_decay=WD, grad_clip=1.0)
    with one_device_mesh:
        jb = j_build_step(jcfg, shape, one_device_mesh, optimizer=jopt)
        jp1, _, jl = jax.jit(jb.step)(jp, jopt.init(jp), {
            k: jnp.asarray(v) for k, v in batch.items()})
    built = build_step(cfg, shape, optimizer=AdamW(
        lr=LR, weight_decay=WD, grad_clip=1.0))
    assert built.name == jb.name
    assert {k: tuple(v.shape) for k, v in built.arg_specs.items()} == {
        k: v.shape for k, v in jb.arg_structs[2].items()}
    model = params_from_jax(_np_tree(jp), cfg, device="cpu")
    opt_state = AdamW().init(model.parameters())
    model, opt_state, loss = built.step(model, opt_state, batch)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    assert int(opt_state.step) == 1
    _step_close(dict(model.named_parameters()), cfg, jp1, jg, "train step")


@pytest.mark.parametrize("arch", ARCHS)
def test_build_step_personalize_matches_reference(arch, one_device_mesh):
    """One personalize step over 2 partitions, each its own replica with
    the prox pull toward the global weights, partition 1 inactive (bitwise
    unchanged), the extra input carried with a partition axis: the
    per-partition losses and weights against the reference's (GRAD_FLOOR's
    mask from the reference's gradient of each replica's loss plus its prox
    pull)."""
    from repro.core.gp.trainer import GPHyperParams, broadcast_to_partitions
    from repro.launch.steps import build_step as j_build_step
    from repro.train.losses import prox_penalty
    from repro.train.optim import AdamW as JAdamW
    from repro_torch.launch.steps import build_step
    from repro_torch.train.optim import AdamW

    cfg, jcfg = get_config(arch).reduced(), j_get_config(arch).reduced()
    shape = InputShape("tiny_train", SEQ + cfg.prefix_tokens, 4, "train")
    P = 2
    b = _batch(cfg, 4, SEQ, seed=4)
    batch_p = {k: v.reshape(P, 2, *v.shape[1:]) for k, v in b.items()}
    active = np.array([True, False])
    jopt = JAdamW(lr=LR, weight_decay=WD, grad_clip=1.0)
    with one_device_mesh:
        jb = j_build_step(jcfg, shape, one_device_mesh, phase="personalize",
                          num_partitions=P, optimizer=jopt)
        jg = jb.model.init(0)
        # the replicas start off the global weights, as after phase 0
        jpp = jax.tree.map(lambda x, r: x + r, broadcast_to_partitions(jg, P),
                           jax.tree.map(lambda x: jnp.asarray(
                               np.random.default_rng(1).normal(
                                   0, 1e-3, (P,) + x.shape), x.dtype),
                               jg))
        jb_p = {k: jnp.asarray(v) for k, v in batch_p.items()}
        jpp1, _, jl = jax.jit(jb.step)(jpp, jax.vmap(jopt.init)(jpp), jb_p,
                                       jg, jnp.asarray(active))
        lam = GPHyperParams().lambda_prox
        jgp = jax.jit(jax.vmap(jax.grad(
            lambda w, x: jb.model.train_loss(w, x)
            + lam * prox_penalty(w, jg))))(jpp, jb_p)
    built = build_step(cfg, shape, phase="personalize", num_partitions=P,
                       optimizer=AdamW(lr=LR, weight_decay=WD,
                                       grad_clip=1.0))
    assert {k: tuple(v.shape) for k, v in built.arg_specs.items()} == {
        k: v.shape for k, v in jb.arg_structs[2].items()}
    glob = params_from_jax(_np_tree(jg), cfg, device="cpu")
    models = [params_from_jax(jax.tree.map(lambda x: np.asarray(x)[p], jpp),
                              cfg, device="cpu") for p in range(P)]
    before = [p.detach().clone() for p in models[1].parameters()]
    states = [AdamW().init(m.parameters()) for m in models]
    models, states, losses = built.step(
        models, states, {k: torch.as_tensor(v) for k, v in batch_p.items()},
        glob, torch.as_tensor(active))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl),
                               rtol=LOSS_RTOL)
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 models[1].parameters()))
    assert [int(s.step) for s in states] == [1, 0]
    for p in range(P):
        want = jax.tree.map(lambda x: np.asarray(x)[p], jpp1)
        _step_close(dict(models[p].named_parameters()), cfg, want,
                    jax.tree.map(lambda x: np.asarray(x)[p], jgp),
                    f"personalize partition {p}")
