"""The LLM training path of the port against the JAX reference, on the CPU
(where the kernel wrappers run their plain versions under autograd):
``chunked_ce_loss`` and ``Transformer.train_loss`` with every gradient
against ``jax.value_and_grad``, remat bitwise no remat, ``build_step``'s
train and personalize steps, ``input_specs``, and ``launch.train llm``
against the reference's ``run_llm``.  Inputs come from numpy seeds and the
weights from the reference's ``Transformer.init`` through
``params_from_jax``."""
import argparse
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import input_specs as j_input_specs
from repro.models import Transformer as JTransformer
from repro.models.transformer import chunked_ce_loss as j_chunked_ce_loss
from repro_torch.configs import ARCH_IDS, SHAPES, InputShape, get_config
from repro_torch.configs import input_specs
from repro_torch.models import params_from_jax
from repro_torch.models.transformer import chunked_ce_loss

# f32 over the vocabulary in chunks: the same sums in another order
CE_RTOL, CE_ATOL = 1e-5, 1e-6
# the loss and every gradient of two reduced layers in f32: torch's GEMMs
# and dense attention sum in another order than XLA's and the reference's
# chunked online softmax; a gradient is compared relative to its largest
# entry (the reference's own f32 attention tolerance is 1e-5 / 1e-4)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
# the parameters after one AdamW step: the update -lr m/(sqrt(v)+eps) of an
# entry whose gradient is near 0 moves with that gradient's rounding,
# amplified up to lr/eps (1e5); observed below 3e-6
STEP_ATOL = 1e-4
# the tiny CLI run's final losses after 2 + 2 AdamW steps (lr 3e-3) from
# the same weights: the gradients' f32 rounding passes through AdamW's
# normalisation into the weights
CLI_LOSS_ATOL = 2e-3

ARCHS = ["llama3.2-1b", "qwen2-0.5b", "starcoder2-7b"]
# starcoder2's reduced window is 64: a longer sequence makes it bite
SEQ = {"llama3.2-1b": 24, "qwen2-0.5b": 24, "starcoder2-7b": 80}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(cfg, b, s, seed, masked=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((b, 1), -1, np.int32)],
                            axis=1)
    labels[:, :masked] = -1
    return {"tokens": tokens, "labels": labels}


def _tree_of(named, num_layers, like):
    """Tensors of the port keyed by parameter name (weights or gradients)
    laid out as the reference's parameter tree ``like``: layer ``r`` of
    sub-layer 0 is slice r of ``blocks.sub0``."""
    out = {"embed": named["embed"],
           "final_norm": {k: named[f"final_norm.{k}"]
                          for k in like["final_norm"]},
           "blocks": {"sub0": {g: {k: torch.stack(
               [named[f"layers.{r}.{g}.{k}"] for r in range(num_layers)])
               for k in leaves}
               for g, leaves in like["blocks"]["sub0"].items()}}}
    if "lm_head" in like:
        out["lm_head"] = named["lm_head"]
    return out


def _tree_close(port_tree, ref_tree, rtol, atol, what, relative=False):
    """Leaf by leaf, the port's tree against the reference's; ``relative``
    scales ``atol`` by each reference leaf's largest entry."""
    flat_j, _ = jax.tree_util.tree_flatten_with_path(_np_tree(ref_tree))
    flat_p = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda t: t.detach().numpy(), port_tree,
        is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert len(flat_j) == len(flat_p)
    for (path, want), have in zip(flat_j, flat_p):
        name = f"{what} {jax.tree_util.keystr(path)}"
        assert have.shape == want.shape, name
        scale = (float(np.abs(want).max()) or 1.0) if relative else 1.0
        np.testing.assert_allclose(have, want, rtol=rtol, atol=atol * scale,
                                   err_msg=name)


# --------------------------------------------------------------------------
# chunked_ce_loss
# --------------------------------------------------------------------------

@functools.cache
def _j_ce_value_and_grad(chunk):
    """The reference's loss and (dh, dW), compiled once per chunk size."""
    return jax.jit(jax.value_and_grad(
        lambda h, w, labels: j_chunked_ce_loss(h, w, labels, chunk=chunk),
        argnums=(0, 1)))


@pytest.mark.parametrize("chunk", [8, 37, 50, 4096])
@pytest.mark.parametrize("masked", ["some", "none", "all"])
def test_chunked_ce_loss_matches_reference(chunk, masked):
    """Value and ``(dh, dW)`` against ``jax.value_and_grad`` of the
    reference's, chunks that divide T, that do not, and at or past T;
    masked labels, and an all-masked input (loss 0, zero gradients)."""
    rng = np.random.default_rng(chunk)
    t, d, v = 50, 16, 40
    h = rng.normal(0, 1, (t, d)).astype(np.float32)
    w = rng.normal(0, 0.3, (d, v)).astype(np.float32)
    labels = rng.integers(0, v, t)
    if masked == "some":
        labels[rng.random(t) < 0.3] = -1
    elif masked == "all":
        labels[:] = -1
    jl, (jdh, jdw) = _j_ce_value_and_grad(chunk)(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels))
    th, tw = (torch.tensor(x, requires_grad=True) for x in (h, w))
    loss = chunked_ce_loss(th, tw, torch.as_tensor(labels), chunk=chunk)
    dh, dw = torch.autograd.grad(loss, (th, tw))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=CE_RTOL,
                               atol=CE_ATOL)
    np.testing.assert_allclose(dh.numpy(), np.asarray(jdh), rtol=CE_RTOL,
                               atol=CE_ATOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=CE_RTOL,
                               atol=CE_ATOL)
    if masked == "all":
        assert loss.item() == 0.0 and not dh.any() and not dw.any()


# --------------------------------------------------------------------------
# Transformer.train_loss
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def arch_pair(request):
    """(cfg, reference model, reference params, port model) of one reduced
    f32 arch with the reference's weights."""
    arch = request.param
    cfg = get_config(arch).reduced()
    jm = JTransformer(j_get_config(arch).reduced())
    jp = jm.init(0)
    return cfg, jm, jp, params_from_jax(_np_tree(jp), cfg, device="cpu")


def test_train_loss_and_grads_match_reference(arch_pair):
    """The loss and the gradient of every parameter against
    ``jax.value_and_grad(Transformer.train_loss)``."""
    cfg, jm, jp, model = arch_pair
    batch = _batch(cfg, 2, SEQ[cfg.name], seed=len(cfg.name), masked=3)
    jl, jg = jax.jit(jax.value_and_grad(jm.train_loss))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss = model.train_loss(batch)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    _tree_close(_tree_of(dict(zip(names, grads)), cfg.num_layers, jg), jg,
                GRAD_RTOL, GRAD_RTOL, "grad", relative=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bitwise_no_remat(arch):
    """Checkpointing each layer replays its forward in the backward and
    changes no bit of the loss or of any gradient."""
    from repro_torch.models import Transformer

    out = []
    for remat in (True, False):
        cfg = dataclasses.replace(get_config(arch).reduced(), remat=remat)
        model = Transformer(cfg, seed=1, device="cpu")
        loss = model.train_loss(_batch(cfg, 2, SEQ[arch], seed=5, masked=2))
        out.append([loss] + list(torch.autograd.grad(
            loss, list(model.parameters()))))
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_tied_head_gradient_reaches_embed():
    """qwen2-0.5b ties its head: the embedding's gradient holds the head's
    share, and the unused rows of the lookup get the head's alone."""
    from repro_torch.models import Transformer

    cfg = get_config("qwen2-0.5b").reduced()
    model = Transformer(cfg, seed=0, device="cpu")
    batch = _batch(cfg, 1, 8, seed=0)
    (g,) = torch.autograd.grad(model.train_loss(batch), [model.embed])
    unused = np.setdiff1d(np.arange(cfg.vocab_size), batch["tokens"])
    assert g[torch.as_tensor(unused)].abs().sum() > 0


# --------------------------------------------------------------------------
# configs/shapes.py and launch/steps.py
# --------------------------------------------------------------------------

DENSE = [a for a in ARCH_IDS if get_config(a).family == "dense"]


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_input_specs_match_reference(arch, shape):
    """Every dense arch and every assigned shape: the reference's shapes and
    dtypes, as meta tensors (the decode caches one per layer, each the
    reference's stacked cache's slice)."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert SHAPES[shape] == InputShape(**dataclasses.asdict(J_SHAPES[shape]))
    got, want = input_specs(cfg, SHAPES[shape]), j_input_specs(
        jcfg, J_SHAPES[shape])
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if key == "caches":
            assert len(g) == cfg.num_layers
            for layer in g:
                for kv in ("k", "v"):
                    ref = w["sub0"]["attn"][kv]
                    assert tuple(layer[kv].shape) == ref.shape[1:]
                    assert str(layer[kv].dtype).split(".")[1] == ref.dtype.name
                    assert layer[kv].device.type == "meta"
        elif key == "rolling":
            assert g == w
        else:
            assert tuple(g.shape) == w.shape and g.device.type == "meta"
            assert str(g.dtype).split(".")[1] == np.dtype(w.dtype).name


@pytest.fixture(scope="module")
def one_device_mesh():
    from repro.launch.mesh import make_mesh_compat
    return make_mesh_compat((1, 1), ("data", "model"))


def _weights_tree(model, like):
    return _tree_of(dict(model.named_parameters()), model.cfg.num_layers,
                    like)


def test_build_step_train_matches_reference(one_device_mesh):
    """One generalize step of ``build_step(...).step`` from the same weights
    and batch: the loss and every updated weight."""
    from repro.launch.steps import build_step as j_build_step
    from repro.train.optim import AdamW as JAdamW
    from repro_torch.launch.steps import build_step
    from repro_torch.train.optim import AdamW

    arch = "qwen2-0.5b"
    cfg, jcfg = get_config(arch).reduced(), j_get_config(arch).reduced()
    shape = InputShape("tiny_train", 16, 4, "train")
    batch = _batch(cfg, 4, 16, seed=9)
    with one_device_mesh:
        jb = j_build_step(jcfg, shape, one_device_mesh,
                          optimizer=JAdamW(lr=1e-3, weight_decay=0.01,
                                           grad_clip=1.0))
        jp = jb.model.init(0)
        jo = JAdamW(lr=1e-3, weight_decay=0.01, grad_clip=1.0).init(jp)
        jp1, _, jl = jax.jit(jb.step)(jp, jo, {k: jnp.asarray(v)
                                               for k, v in batch.items()})
    built = build_step(cfg, shape, optimizer=AdamW(
        lr=1e-3, weight_decay=0.01, grad_clip=1.0))
    assert built.name == jb.name
    assert {k: tuple(v.shape) for k, v in built.arg_specs.items()} == {
        k: v.shape for k, v in jb.arg_structs[2].items()}
    model = params_from_jax(_np_tree(jp), cfg, device="cpu")
    opt_state = AdamW().init(model.parameters())
    model, opt_state, loss = built.step(model, opt_state, batch)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    assert int(opt_state.step) == 1
    _tree_close(_weights_tree(model, jp1), jp1, 0, STEP_ATOL, "train step")


def test_build_step_personalize_matches_reference(one_device_mesh):
    """One personalize step over 2 partitions, each its own replica with
    the prox pull toward the global weights, partition 1 inactive (bitwise
    unchanged): the per-partition losses and weights."""
    from repro.core.gp.trainer import broadcast_to_partitions
    from repro.launch.steps import build_step as j_build_step
    from repro.train.optim import AdamW as JAdamW
    from repro_torch.launch.steps import build_step
    from repro_torch.train.optim import AdamW

    arch = "llama3.2-1b"
    cfg, jcfg = get_config(arch).reduced(), j_get_config(arch).reduced()
    shape = InputShape("tiny_train", 12, 4, "train")
    P = 2
    b = _batch(cfg, 4, 12, seed=4)
    batch_p = {k: v.reshape(P, 2, 12) for k, v in b.items()}
    active = np.array([True, False])
    with one_device_mesh:
        jb = j_build_step(jcfg, shape, one_device_mesh, phase="personalize",
                          num_partitions=P)
        jg = jb.model.init(0)
        # the replicas start off the global weights, as after phase 0
        jpp = jax.tree.map(lambda x, r: x + r, broadcast_to_partitions(jg, P),
                           jax.tree.map(lambda x: jnp.asarray(
                               np.random.default_rng(1).normal(
                                   0, 1e-3, (P,) + x.shape), x.dtype),
                               jg))
        jo = jax.vmap(JAdamW(lr=1e-3, weight_decay=0.01,
                             grad_clip=1.0).init)(jpp)
        jpp1, _, jl = jax.jit(jb.step)(jpp, jo, {
            k: jnp.asarray(v) for k, v in batch_p.items()}, jg,
            jnp.asarray(active))
    built = build_step(cfg, shape, phase="personalize", num_partitions=P,
                       optimizer=AdamW(lr=1e-3, weight_decay=0.01,
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
        _tree_close(_weights_tree(models[p], want), want, 0, STEP_ATOL,
                    f"personalize partition {p}")


# --------------------------------------------------------------------------
# launch.train llm
# --------------------------------------------------------------------------

TINY = ["--arch", "qwen2-0.5b", "--shards", "2", "--d-model", "64",
        "--seq", "16", "--docs", "64", "--steps", "4", "--phase0-frac",
        "0.5", "--seed", "0"]


def _ref_args():
    """``TINY`` as the reference's ``llm`` subparser parses it."""
    return argparse.Namespace(arch="qwen2-0.5b", shards=2, method="ew",
                              no_cbs=False, steps=4, phase0_frac=0.5,
                              lambda_prox=0.01, docs=64, seq=16, batch=8,
                              d_model=64, seed=0)


def test_cli_matches_reference_run_llm(monkeypatch, capsys):
    """``main(["llm", ...])`` on the CPU from the reference's initial
    weights: ``shard_entropies`` bitwise, both final losses within
    CLI_LOSS_ATOL of the reference's ``run_llm`` on the same args."""
    import repro_torch.launch.train as T
    from repro.launch.train import run_llm as j_run_llm

    want = j_run_llm(_ref_args())
    jp = JTransformer(j_get_config("qwen2-0.5b").reduced(d_model=64)).init(0)
    seen = {}

    def from_reference(cfg, seed, device):
        seen["cfg"] = cfg
        return params_from_jax(_np_tree(jp), cfg, device=device)

    monkeypatch.setattr(T, "_llm_model", from_reference)
    got = T.run_llm(T.build_parser().parse_args(
        ["llm", *TINY, "--device", "cpu"]))
    assert seen["cfg"] == get_config("qwen2-0.5b").reduced(d_model=64)
    assert got["shard_entropies"] == want["shard_entropies"]
    np.testing.assert_allclose(got["phase0_final_loss"],
                               want["phase0_final_loss"], atol=CLI_LOSS_ATOL)
    np.testing.assert_allclose(got["phase1_final_loss"],
                               want["phase1_final_loss"], atol=CLI_LOSS_ATOL)
    assert len(got["phase1_final_loss"]) == 2
    # no kernel launches on the CPU
    assert got["launches_per_step"] == [[0, 0, 0, 0]] * 4
    assert T.main(["llm", *TINY, "--steps", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "corpus shard domain entropies (ew)" in out
    assert "[phase-0] step    0 loss" in out


def test_cli_full_draws_corpus_over_reduced_vocab(monkeypatch):
    """``--full`` trains the published widths (here their config only: the
    model factory is replaced by a reduced one) on a corpus over the
    ``reduced()`` vocabulary."""
    import repro_torch.data as D
    import repro_torch.launch.train as T
    from repro_torch.models import Transformer

    seen, made = {}, []

    def small(cfg, seed, device):
        seen["cfg"] = cfg
        return Transformer(dataclasses.replace(get_config(
            "qwen2-0.5b").reduced(d_model=64), vocab_size=cfg.vocab_size),
            seed=seed, device=device)

    class Spy(D.DomainCorpus):
        def __init__(self, spec):
            made.append(spec)
            super().__init__(spec)

    monkeypatch.setattr(D, "DomainCorpus", Spy)
    monkeypatch.setattr(T, "_llm_model", small)
    got = T.run_llm(T.build_parser().parse_args(
        ["llm", *TINY, "--steps", "2", "--full", "--device", "cpu"]))
    assert seen["cfg"] == get_config("qwen2-0.5b")
    assert made[0].vocab_size == get_config("qwen2-0.5b").reduced().vocab_size
    assert np.isfinite(got["phase0_final_loss"])
    assert np.isfinite(got["phase1_final_loss"]).all()
