"""The encoder-decoder (whisper-small) and the prefix-LM (paligemma-3b) on a
mesh (``launch/steps.py::build_step`` with a mesh, ROADMAP item 15.7b): the
sharded train, personalize, prefill and decode steps in worlds of ranks on
the CPU, against the reference and against the port's unsharded steps.

One world of 4 ranks is spawned for the module
(``repro_torch.launch.mesh.spawn_partition_world`` on the ``staged``
backend, whose collectives run on an inner gloo group and count their
bytes); its rank functions are ``tests/_torch_sharding_encdec_ranks.py``,
which imports no JAX.  Reduced f32 configs with the reference's weights
(``models/convert.py::params_from_jax``), the extra inputs drawn with
numpy from a seed:

- whisper on ``(2, 2)`` and ``(1, 4)`` ``("data", "model")`` meshes with a
  vocabulary of 515 (odd, as whisper-small's 51,865: the embedding and the
  tied head stay replicated) and 30 encoder frames (split over a model
  axis of 2, replicated over 4);
- whisper with 6 heads on ``(1, 4)`` (the heads divide no model axis of 4:
  every rank computes all of them from gathered projections, in the
  encoder's and the decoder's self-attention and in cross-attention);
- paligemma on ``(2, 2)`` and ``(1, 4)`` (the prefix of 16 patches, one KV
  head: the decode cache is the context-parallel one).

For each: one train step (the loss, every gradient, their global norm, the
weights after one AdamW step), the prefill (logits, every cache, whisper's
``"cross"`` included) and 8 greedy decode steps (logits, tokens, caches),
held

- against the reference's ``jax.value_and_grad(model.train_loss)`` and its
  AdamW step, ``prefill`` and ``decode_step``, within the port's
  transformer tolerances (1e-5 / 1e-4, gradients 1e-4 of their largest
  entry), greedy tokens equal;
- against the port's unsharded steps: loss, gradients, logits and caches
  within 1e-5 of each tensor's largest entry, greedy tokens equal, the
  gradients' global norm within 1e-6 relative;
- in both: a key bias ``b_k`` scaled by its projection's ``wk`` gradient
  (whisper has no RoPE, so ``b_k``'s gradient is 0 in exact arithmetic
  and rounding on every side, ROADMAP §3); the weights after one step
  within 1e-5 of the model's largest weight where the reference gradient
  is at least 1e-6, within 2 lr + 1e-4 below it (AdamW's first update turns
  there with the gradient's rounding);
- the bytes each step's collectives move equal to
  ``models/sharded.py::step_collective_bytes``.

The personalize step with 2 replicas on ``(2, 2)`` against the reference's
for both archs; a world of 1 on a ``(1, 1)`` mesh bitwise ``mesh=None`` for
all four step kinds of both archs.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_sharding_encdec_ranks as er
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
# largest weight where the reference gradient is at least GRAD_FLOOR (100 x
# AdamW's eps); below it the update -lr g / (|g| + eps) turns with the
# gradient's rounding, by up to 2 lr, and is held to 2 lr + STEP_ATOL
STEP_REL, GRAD_FLOOR, STEP_ATOL, LR = 1e-5, 1e-6, 1e-4, 1e-3

CASES = [(mname, name) for mname, _, _, cases in er.MESHES
         for name in cases]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jcfg(name):
    arch, over = er.CASES[name]
    return dataclasses.replace(j_get_config(arch).reduced(), **over)


def _jbatch(batch):
    return {k: jnp.asarray(v, jnp.float32 if v.dtype.kind == "f"
                           else jnp.int32) for k, v in batch.items()}


def _caches(caches):
    """The reference's stacked caches as ``run_case`` keys them."""
    sub = caches["sub0"]
    out = {k: np.asarray(sub["attn"][k]) for k in ("k", "v")}
    if "cross" in sub:
        out.update({f"cross_{k}": np.asarray(sub["cross"][k])
                    for k in ("k", "v")})
    return out


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
    for name in er.CASES:
        jm = JTransformer(_jcfg(name))
        jp = jm.init(0)
        cfg = er.case_cfg(name)
        loss, grads = jax.jit(jax.value_and_grad(jm.train_loss))(
            jp, _jbatch(er.train_batch(cfg)))
        opt = JAdamW(lr=LR, weight_decay=0.01, grad_clip=1.0)
        updates, _ = opt.update(grads, opt.init(jp), jp)
        inputs = _jbatch(er.prompt(cfg))
        logits, caches, _ = jax.jit(partial(jm.prefill, cache_size=None))(
            jp, inputs)
        dl, dc, n = jax.jit(partial(jm.prefill, cache_size=er.width(cfg)))(
            jp, inputs)
        decode = jax.jit(jm.decode_step)
        tok = jnp.argmax(dl, axis=-1)[:, None].astype(jnp.int32)
        steps, tokens = [], [np.asarray(tok[:, 0])]
        for _ in range(er.DECODE):
            dl, dc = decode(jp, tok, dc, n)
            n = n + 1
            steps.append(np.asarray(dl))
            tok = jnp.argmax(dl, axis=-1)[:, None].astype(jnp.int32)
            tokens.append(np.asarray(tok[:, 0]))
        out[name] = {
            "tree": _np_tree(jp), "loss": float(loss),
            "grads": _np_tree(grads), "grad_norm": float(j_global_norm(grads)),
            "params": _np_tree(j_apply_updates(jp, updates)),
            "prefill": np.asarray(logits), "prefill_caches": _caches(caches),
            "decode": np.stack(steps), "tokens": np.stack(tokens, axis=1),
            "decode_caches": _caches(dc)}
    return out


@pytest.fixture(scope="module")
def personalize(reference):
    """Per arch: the personalize inputs (global weights, 2 replicas started
    apart, replica 1 inactive) and the reference's step."""
    from repro.core.gp.trainer import (GPHyperParams, broadcast_to_partitions,
                                       make_personalize_step)
    out = {}
    for name in er.PERSONALIZE:
        jm = JTransformer(_jcfg(name))
        jg = jm.init(0)
        jpp = jax.tree.map(lambda x, r: x + r,
                           broadcast_to_partitions(jg, er.PARTS),
                           jax.tree.map(lambda x: jnp.asarray(
                               np.random.default_rng(1).normal(
                                   0, 1e-3, (er.PARTS,) + x.shape), x.dtype),
                               jg))
        opt = JAdamW(lr=LR, weight_decay=0.01, grad_clip=1.0)
        step = jax.jit(make_personalize_step(jm.train_loss, opt,
                                             GPHyperParams()))
        active = np.array([True, False])
        jpp1, _, jl = step(jpp, jax.vmap(opt.init)(jpp),
                           _jbatch(er.personalize_batch(er.case_cfg(name))),
                           jg, jnp.asarray(active))
        replicas = [jax.tree.map(lambda x: np.asarray(x)[p], jpp)
                    for p in range(er.PARTS)]
        want = [jax.tree.map(lambda x: np.asarray(x)[p], jpp1)
                for p in range(er.PARTS)]
        out[name] = ((_np_tree(jg), replicas, active), np.asarray(jl), want)
    return out


def _world_args(reference, personalize):
    trees = {k: v["tree"] for k, v in reference.items()}
    return trees, {k: v[0] for k, v in personalize.items()}


@pytest.fixture(scope="module")
def world4(reference, personalize, tmp_path_factory):
    return spawn_partition_world(
        er.world_checks, 4, _world_args(reference, personalize),
        backend="staged", device="cpu",
        workdir=str(tmp_path_factory.mktemp("w4")), timeout_s=120,
        join_timeout_s=600)


@pytest.fixture(scope="module")
def world1(reference, personalize, tmp_path_factory):
    return spawn_partition_world(
        er.world_of_one, 1, _world_args(reference, personalize),
        backend="gloo", device="cpu",
        workdir=str(tmp_path_factory.mktemp("w1")), timeout_s=120,
        join_timeout_s=600)


@pytest.fixture(scope="module")
def unsharded(reference):
    """The port's unsharded steps, per case."""
    return {name: er.run_case(er.case_cfg(name), reference[name]["tree"],
                              None) for name in er.CASES}


def _blocks(named, prefix, n, like):
    return {"sub0": {g: {k: np.stack([named[f"{prefix}.{r}.{g}.{k}"]
                                      for r in range(n)])
                         for k in leaves}
                     for g, leaves in like["sub0"].items()}}


def _tree_of(named, cfg, like):
    """Port tensors keyed by name laid out as the reference's tree: the
    decoder's layers as ``blocks.sub0``, the encoder's as
    ``encoder.blocks.sub0`` and its final norm as ``encoder.final_norm``."""
    out = {"embed": named["embed"],
           "final_norm": {k: named[f"final_norm.{k}"]
                          for k in like["final_norm"]},
           "blocks": _blocks(named, "layers", cfg.num_layers,
                             like["blocks"])}
    if "lm_head" in like:
        out["lm_head"] = named["lm_head"]
    if "encoder" in like:
        enc = like["encoder"]
        out["encoder"] = {
            "blocks": _blocks(named, "encoder", cfg.encoder_layers,
                              enc["blocks"]),
            "final_norm": {k: named[f"encoder_norm.{k}"]
                           for k in enc["final_norm"]}}
    return out


def _leaves(tree):
    """``[(path keys, leaf)]`` of a numpy tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [([p.key for p in path], np.asarray(x)) for path, x in flat]


def _scale_of(keys, grads_by_path, leaf):
    """The scale a gradient is held relative to: its largest entry, or for
    a key bias ``b_k`` its projection's ``wk`` gradient's."""
    like = leaf
    if keys[-1] == "b_k":
        like = grads_by_path[tuple(keys[:-1]) + ("wk",)]
    return float(np.abs(like).max()) or 1.0


def _grads_close(have, want, rtol, atol, what):
    """Leaf by leaf, relative to each leaf's scale (``_scale_of``)."""
    flat_w, flat_h = _leaves(want), _leaves(have)
    assert [k for k, _ in flat_w] == [k for k, _ in flat_h]
    by_path = {tuple(k): x for k, x in flat_w}
    for (keys, w), (_, h) in zip(flat_w, flat_h):
        np.testing.assert_allclose(
            h, w, rtol=rtol, atol=atol * _scale_of(keys, by_path, w),
            err_msg=f"{what} {keys}")


def _step_close(have, want, grad, scale, what):
    """Weights after AdamW's first step: ``STEP_REL`` of ``scale`` (the
    model's largest weight) where ``|grad|`` is at least ``GRAD_FLOOR``,
    2 lr + ``STEP_ATOL`` below."""
    err = np.abs(np.asarray(have) - np.asarray(want))
    big = np.abs(np.asarray(grad)) >= GRAD_FLOOR
    assert err[big].max(initial=0) <= STEP_REL * scale, (
        what, float(err[big].max()), scale)
    assert err[~big].max(initial=0) <= 2 * LR + STEP_ATOL, (
        what, float(err.max()))


def _step_trees(have, want, grads, what):
    flat_w, flat_h, flat_g = _leaves(want), _leaves(have), _leaves(grads)
    assert len(flat_w) == len(flat_h) == len(flat_g)
    scale = max(float(np.abs(x).max()) for _, x in flat_w)
    for (keys, w), (_, h), (_, g) in zip(flat_w, flat_h, flat_g):
        _step_close(h, w, g, scale, f"{what} {keys}")


def _rel(a, b, what, scale=None):
    """|a - b| within SHARD_REL of ``scale`` (b's largest entry)."""
    scale = scale or float(np.abs(b).max()) or 1.0
    err = float(np.abs(np.asarray(a) - np.asarray(b)).max())
    assert err <= SHARD_REL * scale, (what, err, scale)


@pytest.mark.parametrize("mesh,name", CASES)
def test_train_step_matches_reference(world4, reference, mesh, name):
    got, want = world4[0][mesh, name], reference[name]
    cfg = er.case_cfg(name)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    _grads_close(_tree_of(got["grads"], cfg, want["grads"]), want["grads"],
                 GRAD_RTOL, GRAD_RTOL, "grad")
    _step_trees(_tree_of(got["params"], cfg, want["params"]),
                want["params"], want["grads"], "step")
    # the clip's norm is the full gradients': a shard's would be smaller
    assert abs(got["grad_norm"] - want["grad_norm"]) <= (
        NORM_REL * want["grad_norm"]), (got["grad_norm"], want["grad_norm"])


@pytest.mark.parametrize("mesh,name", CASES)
def test_serving_matches_reference(world4, reference, mesh, name):
    """The prefill's logits and every cache (whisper's ``"cross"`` keys and
    values of the encoder included), the greedy tokens, each decode step's
    logits and the caches after them."""
    got, want = world4[0][mesh, name], reference[name]
    np.testing.assert_allclose(got["prefill"], want["prefill"], atol=ATOL,
                               rtol=RTOL)
    for part in ("prefill_caches", "decode_caches"):
        assert set(got[part]) == set(want[part])
        for key, w in want[part].items():
            np.testing.assert_allclose(got[part][key], w, atol=ATOL,
                                       rtol=RTOL, err_msg=f"{part} {key}")
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_allclose(got["decode"], want["decode"], atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("mesh,name", CASES)
def test_sharded_matches_unsharded(world4, unsharded, mesh, name):
    got, want = world4[0][mesh, name], unsharded[name]
    _rel(got["loss"], want["loss"], "loss")
    assert abs(got["grad_norm"] - want["grad_norm"]) <= (
        NORM_REL * want["grad_norm"]), (got["grad_norm"], want["grad_norm"])
    grads = want["grads"]
    w_max = max(float(np.abs(p).max()) for p in want["params"].values())
    for n in grads:
        scale = None
        if n.endswith(".b_k"):
            scale = float(np.abs(grads[n[:-len("b_k")] + "wk"]).max())
        _rel(got["grads"][n], grads[n], f"grad {n}", scale)
        _step_close(got["params"][n], want["params"][n], grads[n], w_max,
                    f"step {n}")
    for key in ("prefill", "decode"):
        _rel(got[key], want[key], key)
    for part in ("prefill_caches", "decode_caches"):
        assert set(got[part]) == set(want[part])
        for key in want[part]:
            _rel(got[part][key], want[part][key], f"{part} {key}")
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


@pytest.mark.parametrize("mesh,name", CASES)
def test_collective_bytes_equal_closed_form(world4, mesh, name):
    got = world4[0][mesh, name]
    for kind in ("train", "prefill", "decode"):
        want = got["closed_form"][kind]
        assert got[f"{kind}_bytes"] == want, (kind, got[f"{kind}_bytes"],
                                              want)


def test_placements_follow_the_specs(world4):
    """The logits come back ``P(data, "model")`` where the vocabulary
    splits and ``P(data)`` where it does not (515); the self and cross
    caches are heads over ``"model"`` where the KV heads divide it, the
    sequence (context-parallel) where they do not and it divides, and
    replicated there otherwise (whisper-h6's 30 encoder frames over 4)."""
    r = world4[0]
    for mesh in ("2x2", "1x4"):
        assert r[mesh, "whisper"]["logits_placements"] == ["S0", "R"]
        assert r[mesh, "whisper"]["cache_placements"] == ["S0", "S1"]
        assert r[mesh, "whisper"]["cross_placements"] == ["S0", "S1"]
        assert r[mesh, "paligemma"]["logits_placements"] == ["S0", "S1"]
        assert r[mesh, "paligemma"]["cache_placements"] == ["S0", "S2"]
        assert "cross_placements" not in r[mesh, "paligemma"]
    assert r["1x4", "whisper-h6"]["cache_placements"] == ["S0", "S2"]
    assert r["1x4", "whisper-h6"]["cross_placements"] == ["S0", "R"]


def test_every_rank_holds_the_same(world4):
    r0 = world4[0]
    for other in world4[1:]:
        for key, v in other.items():
            if key[0] == "personalize":
                continue
            loss, pre, tokens = v
            assert loss == r0[key]["loss"], key
            assert pre == float(r0[key]["prefill"].sum()), key
            assert tokens == r0[key]["tokens"].tolist(), key


@pytest.mark.parametrize("name", er.PERSONALIZE)
def test_personalize_matches_reference(world4, personalize, name):
    """Two replicas, one per data coordinate, each sharded over
    ``"model"``, the extra input carried with a partition axis; replica 1
    inactive comes back bitwise unchanged."""
    inputs, jl, want = personalize[name]
    cfg = er.case_cfg(name)
    for rank, r in enumerate(world4):
        got = r["personalize", name]
        np.testing.assert_allclose(got["losses"], jl, rtol=LOSS_RTOL)
        # data coordinate rank // 2 holds replica rank // 2
        (p, params), = got["params"].items()
        assert p == rank // 2
        assert got["steps"] == {p: 1 - p}
        tree = _tree_of(params, cfg, want[p])
        if p == 0:
            flat_w, flat_h = _leaves(want[0]), _leaves(tree)
            for (keys, w), (_, h) in zip(flat_w, flat_h):
                np.testing.assert_allclose(h, w, rtol=0, atol=STEP_ATOL,
                                           err_msg=f"replica 0 {keys}")
        else:
            for (keys, w), (_, h) in zip(_leaves(inputs[1][1]),
                                         _leaves(tree)):
                assert np.array_equal(h, w), keys


@pytest.mark.parametrize("kind", ["train", "personalize", "prefill",
                                  "decode"])
def test_world_of_one_is_bitwise_unsharded(world1, kind):
    out = world1[0]
    for name in er.PERSONALIZE:
        if kind == "personalize":
            a, b = out["personalize", name]
            assert np.array_equal(a["losses"], b["losses"]), name
            for p in a["params"]:
                for n in a["params"][p]:
                    assert np.array_equal(a["params"][p][n],
                                          b["params"][p][n]), (name, p, n)
            assert a["steps"] == b["steps"]
            continue
        keys = {"train": ("loss", "grads", "grad_norm", "params",
                          "train_bytes"),
                "prefill": ("prefill", "prefill_caches"),
                "decode": ("decode", "tokens", "decode_caches")}[kind]
        a, b = out[name]
        for key in keys:
            va, vb = a[key], b[key]
            if isinstance(va, dict):
                assert va.keys() == vb.keys()
                for n in va:
                    assert np.array_equal(va[n], vb[n]), (name, key, n)
            else:
                assert np.array_equal(va, vb), (name, key)
