"""The sharded LLM steps (``launch/steps.py::build_step`` with a mesh,
ROADMAP item 15.7) in worlds of ranks on the CPU, against the reference
and against the port's unsharded steps.

One world of 4 ranks is spawned for the module
(``repro_torch.launch.mesh.spawn_partition_world`` on the ``staged``
backend, whose collectives run on an inner gloo group and count their
bytes); its rank functions are ``tests/_torch_sharding_ranks.py``, which
imports no JAX.  Reduced f32 configs with the reference's weights
(``models/convert.py::params_from_jax``): qwen2-0.5b and llama3.2-1b on a
``(2, 2)`` ``("data", "model")`` mesh and a ``(2, 2, 1)`` ``("pod", "data",
"model")`` mesh, qwen2 with one KV head on ``(2, 2)`` (the KV heads do not
divide ``"model"``, and the decode cache is the context-parallel one), and
qwen2 with 6 query heads on ``(1, 4)`` (the heads do not divide a model
axis of 4).  For each: one train step (the loss, every gradient, the
weights after one AdamW step), the prefill (logits, caches gathered) and 8
greedy decode steps (logits, tokens), held

- against the reference's ``jax.value_and_grad(model.train_loss)`` and its
  AdamW step, ``prefill`` and ``decode_step``, within the port's
  transformer tolerances (1e-5 / 1e-4, gradients 1e-4 of their largest
  entry), greedy tokens equal;
- against the port's unsharded steps: loss, gradients, logits and caches
  within 1e-5 of each tensor's largest entry, greedy tokens equal;
- in both: the gradients' global norm, which AdamW's clip divides by,
  within 1e-6 relative (a norm of the local shards would be off by a
  factor near sqrt(|model|)); the weights after AdamW's first step within
  1e-5 of the model's largest weight where the gradient is at least 1e-6,
  and within 1e-4 below that floor (there the first update ``-lr g / (|g|
  + eps)`` moves with the gradient's rounding, up to ``2 lr``; the clip's
  scale cancels from that update, so the norm is held on its own);
- the bytes each step's collectives move equal to
  ``models/sharded.py::step_collective_bytes``, worked out from the specs.

The personalize step with 2 replicas on ``(2, 2)`` against the
reference's; a world of 1 on a ``(1, 1)`` mesh bitwise ``mesh=None`` for
all four step kinds; a mesh that is not the world's size raises.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_sharding_ranks as sr
from repro.configs import get_config as j_get_config
from repro.models import Transformer as JTransformer
from repro.train.optim import AdamW as JAdamW
from repro.train.optim import apply_updates as j_apply_updates
from repro.train.optim import global_norm as j_global_norm
from repro_torch.launch.mesh import spawn_partition_world

ATOL, RTOL = 1e-5, 1e-4          # the transformer tolerances
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
SHARD_REL = 1e-5                 # sharded vs unsharded, of the largest entry
NORM_REL = 1e-6                  # the gradients' global norm (AdamW's clip)
# the weights after AdamW's first step: within STEP_REL of the model's
# largest weight where the gradient is at least GRAD_FLOOR (100 x AdamW's
# eps); below it the update -lr g / (|g| + eps) turns on the gradient's
# rounding, up to 2 lr, and is held to STEP_ATOL
STEP_REL, GRAD_FLOOR, STEP_ATOL = 1e-5, 1e-6, 1e-4

CASES = [(mname, name) for mname, _, _, cases in sr.MESHES
         for name in cases]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jcfg(name):
    arch, over = sr.CASES[name]
    return dataclasses.replace(j_get_config(arch).reduced(), **over)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The ranks use one intra-op thread each; so does this process, so
    the unsharded runs here sum as a rank's would."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def reference():
    """Per case: the reference's weights (numpy), its loss and gradients,
    weights after one AdamW step, prefill and greedy decode."""
    out = {}
    for name in sr.CASES:
        jm = JTransformer(_jcfg(name))
        jp = jm.init(0)
        cfg = sr.case_cfg(name)
        batch = {k: jnp.asarray(v, jnp.int32)
                 for k, v in sr.train_batch(cfg).items()}
        loss, grads = jax.jit(jax.value_and_grad(jm.train_loss))(jp, batch)
        opt = JAdamW(lr=1e-3, weight_decay=0.01, grad_clip=1.0)
        updates, _ = opt.update(grads, opt.init(jp), jp)
        toks = jnp.asarray(sr.prompt(cfg), jnp.int32)
        logits, caches, _ = jax.jit(partial(jm.prefill, cache_size=None))(
            jp, {"tokens": toks})
        dl, dc, n = jax.jit(partial(jm.prefill, cache_size=sr.WIDTH))(
            jp, {"tokens": toks})
        decode = jax.jit(jm.decode_step)
        tok = jnp.argmax(dl, axis=-1)[:, None].astype(jnp.int32)
        steps, tokens = [], [np.asarray(tok[:, 0])]
        for _ in range(sr.DECODE):
            dl, dc = decode(jp, tok, dc, n)
            n = n + 1
            steps.append(np.asarray(dl))
            tok = jnp.argmax(dl, axis=-1)[:, None].astype(jnp.int32)
            tokens.append(np.asarray(tok[:, 0]))
        out[name] = {
            "tree": _np_tree(jp), "loss": float(loss),
            "grads": _np_tree(grads), "grad_norm": float(j_global_norm(grads)),
            "params": _np_tree(j_apply_updates(jp, updates)),
            "prefill": np.asarray(logits),
            "prefill_k": np.asarray(caches["sub0"]["attn"]["k"]),
            "prefill_v": np.asarray(caches["sub0"]["attn"]["v"]),
            "decode": np.stack(steps), "tokens": np.stack(tokens, axis=1),
            "decode_k": np.asarray(dc["sub0"]["attn"]["k"])}
    return out


@pytest.fixture(scope="module")
def personalize(reference):
    """The personalize inputs (global weights, 2 replicas started apart,
    replica 1 inactive) and the reference's step."""
    from repro.core.gp.trainer import (GPHyperParams, broadcast_to_partitions,
                                       make_personalize_step)
    name = sr.PERSONALIZE_CASE
    jm = JTransformer(_jcfg(name))
    jg = jm.init(0)
    jpp = jax.tree.map(lambda x, r: x + r,
                       broadcast_to_partitions(jg, sr.PARTS),
                       jax.tree.map(lambda x: jnp.asarray(
                           np.random.default_rng(1).normal(
                               0, 1e-3, (sr.PARTS,) + x.shape), x.dtype), jg))
    opt = JAdamW(lr=1e-3, weight_decay=0.01, grad_clip=1.0)
    step = jax.jit(make_personalize_step(jm.train_loss, opt,
                                         GPHyperParams()))
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, sr.case_cfg(name).vocab_size, (4, 12))
    labels = np.concatenate([tokens[:, 1:], np.full((4, 1), -1)], axis=1)
    batch_p = {"tokens": jnp.asarray(tokens.reshape(sr.PARTS, 2, 12),
                                     jnp.int32),
               "labels": jnp.asarray(labels.reshape(sr.PARTS, 2, 12),
                                     jnp.int32)}
    active = np.array([True, False])
    jpp1, _, jl = step(jpp, jax.vmap(opt.init)(jpp), batch_p, jg,
                       jnp.asarray(active))
    replicas = [jax.tree.map(lambda x: np.asarray(x)[p], jpp)
                for p in range(sr.PARTS)]
    want = [jax.tree.map(lambda x: np.asarray(x)[p], jpp1)
            for p in range(sr.PARTS)]
    return (_np_tree(jg), replicas, active), np.asarray(jl), want


@pytest.fixture(scope="module")
def world4(reference, personalize, tmp_path_factory):
    trees = {k: v["tree"] for k, v in reference.items()}
    return spawn_partition_world(
        sr.world_checks, 4, (trees, personalize[0]), backend="staged",
        device="cpu", workdir=str(tmp_path_factory.mktemp("w4")),
        timeout_s=120, join_timeout_s=600)


@pytest.fixture(scope="module")
def world1(reference, personalize, tmp_path_factory):
    trees = {k: v["tree"] for k, v in reference.items()}
    return spawn_partition_world(
        sr.world_of_one, 1, (trees, personalize[0]), backend="gloo",
        device="cpu", workdir=str(tmp_path_factory.mktemp("w1")),
        timeout_s=120, join_timeout_s=600)


@pytest.fixture(scope="module")
def unsharded(reference):
    """The port's unsharded steps, per case."""
    return {name: sr.run_case(sr.case_cfg(name), reference[name]["tree"],
                              None) for name in sr.CASES}


def _tree_of(named, cfg, like):
    """Port tensors keyed by name laid out as the reference's tree."""
    out = {"embed": named["embed"],
           "final_norm": {k: named[f"final_norm.{k}"]
                          for k in like["final_norm"]},
           "blocks": {"sub0": {g: {k: np.stack(
               [named[f"layers.{r}.{g}.{k}"] for r in range(cfg.num_layers)])
               for k in leaves}
               for g, leaves in like["blocks"]["sub0"].items()}}}
    if "lm_head" in like:
        out["lm_head"] = named["lm_head"]
    return out


def _close_trees(have, want, rtol, atol, what, relative):
    flat_w, _ = jax.tree_util.tree_flatten_with_path(want)
    flat_h = jax.tree_util.tree_leaves(have)
    assert len(flat_w) == len(flat_h)
    for (path, w), h in zip(flat_w, flat_h):
        scale = (float(np.abs(w).max()) or 1.0) if relative else 1.0
        np.testing.assert_allclose(h, w, rtol=rtol, atol=atol * scale,
                                   err_msg=f"{what} "
                                           f"{jax.tree_util.keystr(path)}")


def _largest(tree) -> float:
    return max(float(np.abs(x).max()) for x in jax.tree_util.tree_leaves(
        tree))


def _step_close(have, want, grad, scale, what):
    """Weights after AdamW's first step: ``STEP_REL`` of ``scale`` (the
    model's largest weight) where ``|grad|`` is at least ``GRAD_FLOOR``,
    ``STEP_ATOL`` below."""
    err = np.abs(np.asarray(have) - np.asarray(want))
    big = np.abs(np.asarray(grad)) >= GRAD_FLOOR
    assert err[big].max(initial=0) <= STEP_REL * scale, (
        what, float(err[big].max()), scale)
    assert err[~big].max(initial=0) <= STEP_ATOL, (what, float(err.max()))


def _step_trees(have, want, grads, what):
    flat_w, _ = jax.tree_util.tree_flatten_with_path(want)
    flat_h = jax.tree_util.tree_leaves(have)
    flat_g = jax.tree_util.tree_leaves(grads)
    assert len(flat_w) == len(flat_h) == len(flat_g)
    scale = _largest(want)
    for (path, w), h, g in zip(flat_w, flat_h, flat_g):
        _step_close(h, w, g, scale, f"{what} {jax.tree_util.keystr(path)}")


def _rel(a, b, what):
    """|a - b| within SHARD_REL of b's largest entry."""
    scale = float(np.abs(b).max()) or 1.0
    err = float(np.abs(np.asarray(a) - np.asarray(b)).max())
    assert err <= SHARD_REL * scale, (what, err, scale)


@pytest.mark.parametrize("mesh,name", CASES)
def test_train_step_matches_reference(world4, reference, mesh, name):
    got, want = world4[0][mesh, name], reference[name]
    cfg = sr.case_cfg(name)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    _close_trees(_tree_of(got["grads"], cfg, want["grads"]), want["grads"],
                 GRAD_RTOL, GRAD_RTOL, "grad", relative=True)
    _step_trees(_tree_of(got["params"], cfg, want["params"]),
                want["params"], want["grads"], "step")
    # the clip's norm is the full gradients': a shard's would be smaller
    assert abs(got["grad_norm"] - want["grad_norm"]) <= (
        NORM_REL * want["grad_norm"]), (got["grad_norm"], want["grad_norm"])


@pytest.mark.parametrize("mesh,name", CASES)
def test_serving_matches_reference(world4, reference, mesh, name):
    got, want = world4[0][mesh, name], reference[name]
    np.testing.assert_allclose(got["prefill"], want["prefill"], atol=ATOL,
                               rtol=RTOL)
    for key in ("prefill_k", "prefill_v", "decode_k"):
        np.testing.assert_allclose(got[key], want[key], atol=ATOL, rtol=RTOL,
                                   err_msg=key)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_allclose(got["decode"], want["decode"], atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("mesh,name", CASES)
def test_sharded_matches_unsharded(world4, unsharded, mesh, name):
    got, want = world4[0][mesh, name], unsharded[name]
    _rel(got["loss"], want["loss"], "loss")
    assert abs(got["grad_norm"] - want["grad_norm"]) <= (
        NORM_REL * want["grad_norm"]), (got["grad_norm"], want["grad_norm"])
    for n in want["grads"]:
        _rel(got["grads"][n], want["grads"][n], f"grad {n}")
        _step_close(got["params"][n], want["params"][n], want["grads"][n],
                    _largest(want["params"]), f"step {n}")
    for key in ("prefill", "prefill_k", "prefill_v", "decode", "decode_k"):
        _rel(got[key], want[key], key)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


@pytest.mark.parametrize("mesh,name", CASES)
def test_collective_bytes_equal_closed_form(world4, mesh, name):
    got = world4[0][mesh, name]
    for kind in ("train", "prefill", "decode"):
        want = got["closed_form"][kind]
        assert got[f"{kind}_bytes"] == want, (kind, got[f"{kind}_bytes"],
                                              want)


def test_placements_follow_the_specs(world4):
    """The logits come back ``P(data, "model")``; the decode cache is
    heads over ``"model"`` where the KV heads divide it and the sequence
    (context-parallel) where they do not; batch over (pod, data)."""
    r = world4[0]
    assert r["2x2", "qwen2"]["logits_placements"] == ["S0", "S1"]
    assert r["2x2", "qwen2"]["cache_placements"] == ["S0", "S1"]
    assert r["2x2", "qwen2-mqa"]["cache_placements"] == ["S0", "S2"]
    assert r["2x2x1", "llama"]["cache_placements"] == ["S0", "S0", "S1"]
    assert r["1x4", "qwen2-h6"]["cache_placements"] == ["S0", "S2"]


def test_every_rank_holds_the_same(world4):
    r0 = world4[0]
    for other in world4[1:]:
        for key, (loss, pre, tokens) in other["digest"].items():
            assert loss == r0[key]["loss"], key
            assert pre == float(r0[key]["prefill"].sum()), key
            assert tokens == r0[key]["tokens"].tolist(), key


def test_personalize_matches_reference(world4, personalize):
    """Two replicas, one per data coordinate, each sharded over
    ``"model"``; replica 1 inactive comes back bitwise unchanged."""
    inputs, jl, want = personalize
    cfg = sr.case_cfg(sr.PERSONALIZE_CASE)
    for rank, r in enumerate(world4):
        np.testing.assert_allclose(r["personalize"]["losses"], jl,
                                   rtol=LOSS_RTOL)
        # data coordinate rank // 2 holds replica rank // 2
        (p, got), = r["personalize"]["params"].items()
        assert p == rank // 2
        assert r["personalize"]["steps"] == {p: 1 - p}
        if p == 0:
            _close_trees(_tree_of(got, cfg, want[0]), want[0], 0, STEP_ATOL,
                         "replica 0", relative=False)
        else:
            for n, v in got.items():
                assert np.array_equal(v, _tree_flat(inputs[1][1], n)), n


def _tree_flat(tree, name):
    """The reference tree's leaf of the port's parameter ``name``."""
    if name == "embed" or name == "lm_head":
        return tree[name]
    if name.startswith("final_norm."):
        return tree["final_norm"][name.split(".")[1]]
    _, r, g, k = name.split(".")
    return np.asarray(tree["blocks"]["sub0"][g][k])[int(r)]


@pytest.mark.parametrize("kind", ["train", "personalize", "prefill",
                                  "decode"])
def test_world_of_one_is_bitwise_unsharded(world1, kind):
    out = world1[0]
    if kind == "personalize":
        a, b = out["personalize"]
        assert np.array_equal(a["losses"], b["losses"])
        for p in a["params"]:
            for n in a["params"][p]:
                assert np.array_equal(a["params"][p][n],
                                      b["params"][p][n]), (p, n)
        assert a["steps"] == b["steps"]
        return
    keys = {"train": ("loss", "grads", "grad_norm", "params", "train_bytes"),
            "prefill": ("prefill", "prefill_k", "prefill_v"),
            "decode": ("decode", "tokens", "decode_k")}[kind]
    for name in ("qwen2", "llama"):
        a, b = out[name]
        for key in keys:
            va, vb = a[key], b[key]
            if isinstance(va, dict):
                assert va.keys() == vb.keys()
                for n in va:
                    assert np.array_equal(va[n], vb[n]), (name, key, n)
            else:
                assert np.array_equal(va, vb), (name, key)


def test_mesh_not_the_world_raises(world4):
    errors = world4[0]["errors"]
    assert "needs a world of 8 ranks, have 4" in errors[0]
    assert "needs a world of 2 ranks, have 4" in errors[1]
    assert "needs a world of 256 ranks, have 4" in errors[2]
