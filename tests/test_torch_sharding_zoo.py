"""The MoE and Mamba2 families on a mesh (``launch/steps.py::build_step``
with a mesh, ROADMAP item 15.7b, part 2): the sharded train, personalize,
prefill and decode steps of phi3.5-moe, mamba2-370m and jamba in worlds of
ranks on the CPU, against the reference and against the port's unsharded
steps.

One world of 4 ranks is spawned for the module, from threads of this
process while the reference computes here
(``repro_torch.launch.mesh.spawn_partition_world`` on the ``staged``
backend, whose collectives run on an inner gloo group and count their
bytes); its rank functions are ``tests/_torch_sharding_zoo_ranks.py``,
which imports no JAX.  Reduced f32 configs with the reference's weights
(``models/convert.py::params_from_jax``), batches of 4 x 32 tokens:

- phi3.5-moe (4 experts, capacity factor 0.75) on ``(2, 2)`` and
  ``(1, 4)`` ``("data", "model")`` meshes: on ``(2, 2)`` data rank 1
  loses choices to the slots data rank 0's tokens took first, and the
  choices kept on the ranks, in data-rank order, are the reference's;
- phi3.5-moe with 6 experts on ``(1, 4)`` (they divide no model axis of
  4: the experts stay replicated and each rank runs its range);
- mamba2-370m on ``(2, 2)`` and ``(1, 4)`` (its 16 SSM heads over
  ``"model"``; a prefill gathers the projected rows over ``"model"``),
  with 6 heads on ``(1, 4)`` (every rank runs every head; ``ssm_norm``,
  ``out_proj`` and the conv channels still split) and with d_model 64 on
  ``(2, 2)`` (a prefill gathers ``in_proj`` and the conv's weights, as
  ``models/sharded.py::ssm_serves_activations`` picks by the bytes);
- jamba (attention + MLP, Mamba2 + MoE and Mamba2 + MLP sub-layers in one
  model) on ``(2, 2)``, and with remat on.

For each: one train step (the loss with MoE's auxiliary, every gradient,
their global norm, the weights after one AdamW step), the prefill (logits,
every KV, conv and SSM cache) and 8 greedy decode steps (logits, tokens,
caches), held against the reference's ``jax.value_and_grad(train_loss)``
and its AdamW step, ``prefill`` and ``decode_step``, and against the
port's unsharded steps, with the tolerances of
``tests/test_torch_sharding_encdec.py``; the bytes each step's
collectives move equal to ``models/sharded.py::step_collective_bytes``.
The personalize step of jamba with 2 replicas on ``(2, 2)`` against the
reference's; a world of 1 on a ``(1, 1)`` mesh bitwise ``mesh=None`` for
all four step kinds of phi3.5-moe and jamba.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_sharding_zoo_ranks as zr
from repro.configs import get_config as j_get_config
from repro.models import Transformer as JTransformer
from repro.models import layers as JL
from repro.train.optim import AdamW as JAdamW
from repro.train.optim import apply_updates as j_apply_updates
from repro.train.optim import global_norm as j_global_norm
from repro_torch.launch.mesh import spawn_partition_world
from test_torch_sharding_encdec import (ATOL, GRAD_RTOL, LOSS_RTOL, LR,
                                        NORM_REL, RTOL, _leaves,
                                        _rel, _step_close, _step_trees)

CASES = [(mname, name) for mname, _, _, cases in zr.MESHES
         for name in cases]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jcfg(name):
    arch, over = zr.CASES[name]
    return dataclasses.replace(j_get_config(arch).reduced(), **over)


def _jbatch(batch):
    return {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}


def _caches(cfg, caches):
    """The reference's stacked caches keyed as ``caches_of`` keys the
    port's: layer ``r · len(super_block) + i`` is repeat r of
    ``sub<i>``."""
    nsub = len(cfg.super_block)
    out = {}
    for j in range(cfg.num_layers):
        r, i = divmod(j, nsub)
        for group in caches[f"sub{i}"].values():
            for k, v in group.items():
                out[f"{j}.{k}"] = np.asarray(v[r])
    return out


def _kept(jm, jp, batch, cfg):
    """The choices the reference keeps in each MoE call of its train loss
    (T, K), in layer order: its ``moe_apply`` wrapped to hand its input's
    routing (the reference's top-k, token-major slots and capacity) to the
    host."""
    calls, inner = [], JL.moe_apply

    def keep_of(p, x):
        t = x.shape[0] * x.shape[1]
        probs = jax.nn.softmax(x.reshape(t, -1).astype(jnp.float32)
                               @ p["router"], axis=-1)
        _, top_i = jax.lax.top_k(probs, cfg.top_k)
        flat = top_i.reshape(-1)
        pos = jnp.cumsum(jax.nn.one_hot(flat, cfg.num_experts,
                                        dtype=jnp.int32), axis=0) - 1
        slot = jnp.take_along_axis(pos, flat[:, None], axis=1)[:, 0]
        cap = max(8, int(np.ceil(t * cfg.top_k * cfg.capacity_factor
                                 / cfg.num_experts)))
        return (slot < cap).reshape(t, cfg.top_k)

    def wrapped(p, x, c, *args):
        jax.debug.callback(lambda k: calls.append(np.asarray(k)),
                           keep_of(p, x), ordered=True)
        return inner(p, x, c, *args)

    JL.moe_apply = wrapped
    try:
        jax.block_until_ready(jax.jit(jm.train_loss)(jp, _jbatch(batch)))
    finally:
        JL.moe_apply = inner
    return calls


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The ranks use one intra-op thread each; so does this process, so
    the unsharded runs here sum as a rank's would."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def trees():
    """Per case the reference's initial weights (numpy)."""
    return {name: _np_tree(JTransformer(_jcfg(name)).init(0))
            for name in zr.CASES}


@pytest.fixture(scope="module")
def reference(trees):
    """Per case: the reference's weights (numpy), its loss and gradients,
    weights after one AdamW step, prefill and greedy decode, and the
    choices its MoE calls keep."""
    out = {}
    for name in zr.CASES:
        cfg = _jcfg(name)
        jm = JTransformer(cfg)
        jp = jax.tree_util.tree_map(jnp.asarray, trees[name])
        batch = zr.train_batch(cfg)
        loss, grads = jax.jit(jax.value_and_grad(jm.train_loss))(
            jp, _jbatch(batch))
        opt = JAdamW(lr=LR, weight_decay=0.01, grad_clip=1.0)
        updates, _ = opt.update(grads, opt.init(jp), jp)
        inputs = _jbatch(zr.prompt(cfg))
        logits, caches, _ = jax.jit(partial(jm.prefill, cache_size=None))(
            jp, inputs)
        dl, dc, n = jax.jit(partial(jm.prefill, cache_size=zr.WIDTH))(
            jp, inputs)
        decode = jax.jit(jm.decode_step)
        tok = jnp.argmax(dl, axis=-1)[:, None].astype(jnp.int32)
        steps, tokens = [], [np.asarray(tok[:, 0])]
        for _ in range(zr.DECODE):
            dl, dc = decode(jp, tok, dc, n)
            n = n + 1
            steps.append(np.asarray(dl))
            tok = jnp.argmax(dl, axis=-1)[:, None].astype(jnp.int32)
            tokens.append(np.asarray(tok[:, 0]))
        out[name] = {
            "tree": trees[name], "loss": float(loss),
            "grads": _np_tree(grads), "grad_norm": float(j_global_norm(grads)),
            "params": _np_tree(j_apply_updates(jp, updates)),
            "prefill": np.asarray(logits),
            "prefill_caches": _caches(cfg, caches),
            "decode": np.stack(steps), "tokens": np.stack(tokens, axis=1),
            "decode_caches": _caches(cfg, dc),
            "kept": (_kept(jm, jp, batch, cfg) if cfg.num_experts
                     else [])}
    return out


@pytest.fixture(scope="module")
def personalize_inputs():
    """The personalize step's inputs: the global weights, 2 replicas
    started apart, replica 1 inactive."""
    from repro.core.gp.trainer import broadcast_to_partitions
    jg = JTransformer(_jcfg(zr.PERSONALIZE)).init(0)
    jpp = jax.tree.map(lambda x, r: x + r,
                       broadcast_to_partitions(jg, zr.PARTS),
                       jax.tree.map(lambda x: jnp.asarray(
                           np.random.default_rng(1).normal(
                               0, 1e-3, (zr.PARTS,) + x.shape), x.dtype),
                           jg))
    replicas = [jax.tree.map(lambda x: np.asarray(x)[p], jpp)
                for p in range(zr.PARTS)]
    return jg, jpp, (_np_tree(jg), replicas, np.array([True, False]))


@pytest.fixture(scope="module")
def personalize(personalize_inputs):
    """The personalize inputs (as the worlds take them), the reference's
    step and replica 0's gradient (the train loss and the proximal
    term)."""
    from repro.core.gp.trainer import (GPHyperParams, make_personalize_step,
                                       prox_penalty)
    jg, jpp, inputs = personalize_inputs
    cfg = _jcfg(zr.PERSONALIZE)
    jm = JTransformer(cfg)
    opt = JAdamW(lr=LR, weight_decay=0.01, grad_clip=1.0)
    step = jax.jit(make_personalize_step(jm.train_loss, opt,
                                         GPHyperParams()))
    batch_p = _jbatch(zr.personalize_batch(cfg))
    jpp1, _, jl = step(jpp, jax.vmap(opt.init)(jpp), batch_p, jg,
                       jnp.asarray(inputs[2]))
    hp = GPHyperParams()

    def total(p):
        loss = jm.train_loss(p, {k: v[0] for k, v in batch_p.items()})
        if hp.use_prox:
            loss = loss + hp.lambda_prox * prox_penalty(p, jg)
        return loss

    g0 = jax.jit(jax.grad(total))(jax.tree.map(lambda x: x[0], jpp))
    want = [jax.tree.map(lambda x: np.asarray(x)[p], jpp1)
            for p in range(zr.PARTS)]
    return inputs, np.asarray(jl), want, _np_tree(g0)


@pytest.fixture(scope="module")
def worlds(trees, personalize_inputs, tmp_path_factory):
    """The world of 4 and the world of 1, started in threads of this
    process (their ranks are processes of their own): they run while the
    reference computes here."""
    pool = ThreadPoolExecutor(2)
    args = (trees, personalize_inputs[2])
    out = {
        4: pool.submit(spawn_partition_world, zr.world_checks, 4, args,
                       backend="staged", device="cpu",
                       workdir=str(tmp_path_factory.mktemp("w4")),
                       timeout_s=120, join_timeout_s=600),
        1: pool.submit(spawn_partition_world, zr.world_of_one, 1, args,
                       backend="gloo", device="cpu",
                       workdir=str(tmp_path_factory.mktemp("w1")),
                       timeout_s=120, join_timeout_s=600)}
    yield out
    pool.shutdown()


@pytest.fixture(scope="module")
def world4(worlds, reference, personalize):
    return worlds[4].result()


@pytest.fixture(scope="module")
def world1(worlds, reference, personalize):
    return worlds[1].result()


@pytest.fixture(scope="module")
def unsharded(reference):
    """The port's unsharded steps, per case."""
    return {name: zr.run_case(zr.case_cfg(name), reference[name]["tree"],
                              None) for name in zr.CASES}


def _grads_close(have, want, rtol, atol, what):
    """Leaf by leaf, each within ``atol`` of its largest entry."""
    flat_w, flat_h = _leaves(want), _leaves(have)
    assert [k for k, _ in flat_w] == [k for k, _ in flat_h]
    for (keys, w), (_, h) in zip(flat_w, flat_h):
        np.testing.assert_allclose(
            h, w, rtol=rtol, atol=atol * (float(np.abs(w).max()) or 1.0),
            err_msg=f"{what} {keys}")


def _tree(named, cfg, like):
    """Port arrays keyed by parameter name laid out as the reference's tree
    ``like``: layer ``r · len(super_block) + i`` is slice r of
    ``blocks.sub<i>``."""
    nsub = len(cfg.super_block)
    out = {"embed": named["embed"],
           "final_norm": {k: named[f"final_norm.{k}"]
                          for k in like["final_norm"]},
           "blocks": {f"sub{i}": {g: {k: np.stack(
               [named[f"layers.{r * nsub + i}.{g}.{k}"]
                for r in range(cfg.num_repeats)]) for k in leaves}
               for g, leaves in like["blocks"][f"sub{i}"].items()}
               for i in range(nsub)}}
    if "lm_head" in like:
        out["lm_head"] = named["lm_head"]
    return out


@pytest.mark.parametrize("mesh,name", CASES)
def test_train_step_matches_reference(world4, reference, mesh, name):
    got, want = world4[0][mesh, name], reference[name]
    cfg = zr.case_cfg(name)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    _grads_close(_tree(got["grads"], cfg, want["grads"]), want["grads"],
                 GRAD_RTOL, GRAD_RTOL, "grad")
    _step_trees(_tree(got["params"], cfg, want["params"]),
                want["params"], want["grads"], "step")
    assert abs(got["grad_norm"] - want["grad_norm"]) <= (
        NORM_REL * want["grad_norm"]), (got["grad_norm"], want["grad_norm"])


@pytest.mark.parametrize("mesh,name", CASES)
def test_serving_matches_reference(world4, reference, mesh, name):
    """The prefill's logits and every cache (attention's keys and values,
    Mamba2's conv tail and state), the greedy tokens, each decode step's
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
    w_max = max(float(np.abs(p).max()) for p in want["params"].values())
    for n, g in want["grads"].items():
        _rel(got["grads"][n], g, f"grad {n}")
        _step_close(got["params"][n], want["params"][n], g, w_max,
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


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_moe_keeps_the_reference_choices(world4, reference, mesh):
    """Each MoE call's kept choices: the ranks of model coordinate 0 in
    data-rank order hold the reference's, over the global batch.  On
    ``(2, 2)`` data rank 1 drops choices it would keep alone (its slots
    come after data rank 0's), and data rank 0 drops none of them."""
    want = reference["phi"]["kept"]
    ranks = [0, 2] if mesh == "2x2" else [0]
    calls = [world4[r][mesh, "phi"]["routes"] for r in ranks]
    assert len(want) == 2 and all(len(c) == len(want) for c in calls)
    lost = []
    for j, w in enumerate(want):
        kept = np.concatenate([c[j][0] for c in calls])
        np.testing.assert_array_equal(kept, w, err_msg=f"MoE call {j}")
        lost.append([int((c[j][1] & ~c[j][0]).sum()) for c in calls])
    if mesh == "2x2":
        assert all(n[0] == 0 for n in lost), lost
        assert sum(n[1] for n in lost) > 0, lost
    # every model rank of a data rank routes its rows alike
    for r, rr in enumerate(world4):
        data = r // 2 if mesh == "2x2" else 0
        for (k, a), (k0, a0) in zip(rr[mesh, "phi"]["routes"],
                                    calls[data]):
            assert np.array_equal(k, k0) and np.array_equal(a, a0), r


def test_placements_follow_the_specs(world4):
    """Attention's cache by heads over ``"model"``; Mamba2's state by heads
    where they divide it (replicated for 6 heads over 4), its conv tail
    by an even cut of the channels."""
    r = world4[0]
    assert r["2x2", "jamba"]["cache_placements"] == {
        "k": ["S0", "S1"], "v": ["S0", "S1"], "conv": ["S0", "S2"],
        "ssm": ["S0", "S1"]}
    assert r["1x4", "mamba2"]["cache_placements"] == {
        "conv": ["S0", "S2"], "ssm": ["S0", "S1"]}
    assert r["1x4", "mamba2-h6"]["cache_placements"] == {
        "conv": ["S0", "S2"], "ssm": ["S0", "R"]}


def test_every_rank_holds_the_same(world4):
    r0 = world4[0]
    for other in world4[1:]:
        for key, v in other.items():
            if key == "personalize":
                continue
            loss, pre, tokens = v["digest"]
            assert loss == r0[key]["loss"], key
            assert pre == float(r0[key]["prefill"].sum()), key
            assert tokens == r0[key]["tokens"].tolist(), key


def test_personalize_matches_reference(world4, personalize):
    """Two replicas of jamba, one per data coordinate, each sharded over
    ``"model"``: replica 0's weights after the step held as the train
    step's (against its reference gradient); replica 1 inactive comes back
    bitwise unchanged."""
    inputs, jl, want, g0 = personalize
    cfg = zr.case_cfg(zr.PERSONALIZE)
    for rank, r in enumerate(world4):
        got = r["personalize"]
        np.testing.assert_allclose(got["losses"], jl, rtol=LOSS_RTOL)
        (p, params), = got["params"].items()
        assert p == rank // 2
        assert got["steps"] == {p: 1 - p}
        tree = _tree(params, cfg, want[p])
        if p == 0:
            _step_trees(tree, want[0], g0, "replica 0")
        else:
            for (keys, w), (_, h) in zip(_leaves(inputs[1][1]),
                                         _leaves(tree)):
                assert np.array_equal(h, w), keys


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
    keys = {"train": ("loss", "grads", "grad_norm", "params"),
            "prefill": ("prefill", "prefill_caches"),
            "decode": ("decode", "tokens", "decode_caches")}[kind]
    for name in zr.ONE:
        a, b = out[name]
        for key in keys:
            va, vb = a[key], b[key]
            if isinstance(va, dict):
                assert va.keys() == vb.keys()
                for n in va:
                    assert np.array_equal(va[n], vb[n]), (name, key, n)
            else:
                assert np.array_equal(va, vb), (name, key)
