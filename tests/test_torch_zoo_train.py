"""Training the zoo's MoE and Mamba2 families in the port against the JAX
reference, on the CPU (where the kernel wrappers run their plain versions
under autograd): ``Transformer.train_loss`` (MoE's Switch auxiliary loss
included) and every gradient against ``jax.value_and_grad`` of the
reference's ``train_loss``, with remat on and off; one AdamW step of
``build_step``'s train step against the reference's AdamW on the
reference's gradients; the SSD scan's gradient finite across chunk
boundaries where the masked exponent overflows; and ``launch.train llm
--arch mamba2-370m`` against the reference's ``run_llm``.  Reduced f32
phi3.5-moe, qwen3-moe, mamba2-370m and jamba, the reference's weights
carried by ``params_from_jax``."""
import argparse
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import Transformer as JTransformer
from repro.models import layers as JL
from repro_torch.configs import InputShape, get_config
from repro_torch.models import Transformer, params_from_jax
from repro_torch.models import layers as L
from _torch_threads import one_torch_thread  # noqa: F401

# f32 through two reduced layers (jamba: a super-block of eight sub-layers):
# torch's GEMMs, dense attention, cumsum and the SSD loop sum in another
# order than XLA's dots, the reference's chunked online softmax and its
# scan; a gradient is compared relative to its largest entry, as
# tests/test_torch_llm_train.py compares the dense decoders'
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
# the weights after one AdamW step: within STEP_REL of the model's largest
# weight where the reference gradient is above GRAD_FLOOR (as
# tests/test_torch_sharding_world.py holds them).  The first update is
# -lr g / (|g| + eps) - lr wd w, so an entry whose gradient is near 0 turns
# with that gradient's rounding by up to 2 lr: entries whose reference
# gradient is at most GRAD_FLOOR are held to 2 lr + STEP_ATOL instead.
# WD is large enough that its term, lr wd |w|, is 10 STEP_REL at the
# largest weight, so a step that dropped it fails
STEP_REL = 1e-5
STEP_ATOL = 1e-4
GRAD_FLOOR = 1e-6
LR, WD = 1e-3, 0.1
# the tiny CLI run's final losses after 2 + 2 AdamW steps from the same
# weights (the dense decoders' CLI_LOSS_ATOL)
CLI_LOSS_ATOL = 2e-3

ARCHS = ["phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b", "mamba2-370m",
         "jamba-v0.1-52b"]
# a multiple of the reduced ssm_chunk (32) where a Mamba2 mixer runs: two
# chunks, so the state crosses a chunk boundary
SEQ = {"phi3.5-moe-42b-a6.6b": 24, "qwen3-moe-235b-a22b": 24,
       "mamba2-370m": 64, "jamba-v0.1-52b": 64}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(cfg, b, s, seed, masked=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((b, 1), -1, np.int32)],
                            axis=1)
    labels[:, :masked] = -1
    return {"tokens": tokens, "labels": labels}


def _tree_of(named, cfg, like):
    """Tensors of the port keyed by parameter name laid out as the
    reference's tree ``like``: layer ``r · nsub + i`` is slice r of
    ``blocks.sub<i>``."""
    nsub = len(cfg.super_block)
    out = {"embed": named["embed"],
           "final_norm": {k: named[f"final_norm.{k}"]
                          for k in like["final_norm"]},
           "blocks": {f"sub{i}": {g: {k: torch.stack(
               [named[f"layers.{r * nsub + i}.{g}.{k}"]
                for r in range(cfg.num_repeats)]) for k in leaves}
               for g, leaves in like["blocks"][f"sub{i}"].items()}
               for i in range(nsub)}}
    if "lm_head" in like:
        out["lm_head"] = named["lm_head"]
    return out


def _tree_close(port_tree, ref_tree, rtol, atol, what, relative=False):
    flat_j, _ = jax.tree_util.tree_flatten_with_path(_np_tree(ref_tree))
    flat_p = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda t: t.detach().numpy(), port_tree,
        is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert len(flat_j) == len(flat_p)
    for (path, want), have in zip(flat_j, flat_p):
        name = f"{what} {jax.tree_util.keystr(path)}"
        assert have.shape == want.shape, name
        assert np.isfinite(have).all(), name
        scale = (float(np.abs(want).max()) or 1.0) if relative else 1.0
        np.testing.assert_allclose(have, want, rtol=rtol, atol=atol * scale,
                                   err_msg=name)


@functools.cache
def _reference(arch):
    """The reference's reduced model of ``arch``, its seed-0 parameters and
    its jitted ``value_and_grad(train_loss)`` (remat off: XLA's remat
    replays the same values, and the one compile serves both of the port's
    settings)."""
    jm = JTransformer(dataclasses.replace(j_get_config(arch).reduced(),
                                          remat=False))
    jp = jm.init(0)
    return jm, jp, jax.jit(jax.value_and_grad(jm.train_loss))


def _port(arch, remat, jp):
    cfg = dataclasses.replace(get_config(arch).reduced(), remat=remat)
    return cfg, params_from_jax(_np_tree(jp), cfg, device="cpu")


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_zoo_train_loss_and_grads_match_reference(arch, remat):
    """The loss (MoE's auxiliary loss included) and the gradient of every
    parameter against ``jax.value_and_grad(Transformer.train_loss)``, the
    port's layers checkpointed (``remat``) or not."""
    jm, jp, vg = _reference(arch)
    cfg, model = _port(arch, remat, jp)
    batch = _batch(cfg, 2, SEQ[arch], seed=len(arch), masked=3)
    jl, jg = vg(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss = model.train_loss(batch)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    _tree_close(_tree_of(dict(zip(names, grads)), cfg, jg), jg, GRAD_RTOL,
                GRAD_RTOL, "grad", relative=True)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "jamba-v0.1-52b"])
def test_moe_aux_is_summed_into_the_loss(arch):
    """The loss is the cross-entropy plus every MoE layer's Switch term in
    layer order: the same model with ``router_aux_weight`` 0 gives the
    cross-entropy alone, and the difference is the sum of the layers'
    ``moe_apply`` auxes (recorded on the same forward)."""
    cfg = get_config(arch).reduced()
    model = Transformer(cfg, seed=3, device="cpu")
    batch = _batch(cfg, 2, SEQ[arch], seed=7)
    auxes, inner = [], L.moe_apply

    def spy(p, x, c):
        y, aux = inner(p, x, c)
        auxes.append(aux)
        return y, aux

    L.moe_apply = spy
    try:
        with torch.no_grad():
            loss = model.train_loss(batch)
    finally:
        L.moe_apply = inner
    n_moe = sum(layer.ffn == "moe" for layer in model.layers)
    assert len(auxes) == n_moe > 0
    model.cfg = dataclasses.replace(cfg, router_aux_weight=0.0)
    with torch.no_grad():
        ce = model.train_loss(batch)
    total = auxes[0]
    for a in auxes[1:]:
        total = total + a
    assert float(total) > 0
    torch.testing.assert_close(loss, ce + total, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_zoo_train_step_matches_reference_adamw(arch):
    """One ``build_step(cfg, shape)`` generalize step (no mesh) from the
    reference's weights: its loss, and every weight against the
    reference's AdamW applied to the reference's gradients."""
    from repro.train.optim import AdamW as JAdamW
    from repro.train.optim import apply_updates as j_apply
    from repro_torch.launch.steps import build_step
    from repro_torch.train.optim import AdamW

    jm, jp, vg = _reference(arch)
    cfg, model = _port(arch, True, jp)
    s = SEQ[arch]
    batch = _batch(cfg, 2, s, seed=11)
    jl, jg = vg(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    jopt = JAdamW(lr=LR, weight_decay=WD, grad_clip=1.0)
    # one compiled program: the eager update compiles each primitive of
    # every leaf's shape on its own
    jp1 = jax.jit(lambda p, g: j_apply(p, jopt.update(g, jopt.init(p),
                                                      p)[0]))(jp, jg)
    built = build_step(cfg, InputShape("tiny_train", s, 2, "train"),
                       optimizer=AdamW(lr=LR, weight_decay=WD,
                                       grad_clip=1.0))
    opt_state = AdamW().init(model.parameters())
    model, opt_state, loss = built.step(model, opt_state, batch)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    assert int(opt_state.step) == 1
    got = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda t: t.detach().numpy(), _tree_of(
            dict(model.named_parameters()), cfg, jp1),
        is_leaf=lambda x: isinstance(x, torch.Tensor)))
    flat, _ = jax.tree_util.tree_flatten_with_path(_np_tree(jp1))
    scale = max(float(np.abs(w).max()) for _, w in flat)
    for (path, want), have, g in zip(flat, got,
                                     jax.tree_util.tree_leaves(jg)):
        name = f"train step {jax.tree_util.keystr(path)}"
        assert have.shape == want.shape, name
        diff = np.abs(have - want)
        small = np.abs(np.asarray(g)) <= GRAD_FLOOR
        assert diff[~small].max(initial=0) <= STEP_REL * scale, (
            name, float(diff[~small].max()), scale)
        assert (diff[small] <= 2 * LR + STEP_ATOL).all(), name


@pytest.mark.parametrize("arch", ["mamba2-370m", "phi3.5-moe-42b-a6.6b"])
def test_zoo_personalize_step_runs_each_replica(arch):
    """``build_step(cfg, shape, phase="personalize")`` without a mesh: each
    active replica takes the port's single-partition step (loss plus the
    prox pull) and an inactive one stays bitwise unchanged."""
    from repro_torch.core.gp.trainer import (GPHyperParams,
                                             make_personalize_partition_step)
    from repro_torch.launch.steps import build_step
    from repro_torch.train.optim import AdamW

    cfg = get_config(arch).reduced()
    s, P = SEQ[arch], 2
    opt = AdamW(lr=1e-3, weight_decay=0.01, grad_clip=1.0)
    built = build_step(cfg, InputShape("tiny_train", s, 4, "train"),
                       phase="personalize", num_partitions=P, optimizer=opt)
    b = _batch(cfg, 4, s, seed=2)
    batch_p = {k: torch.as_tensor(v.reshape(P, 2, s)) for k, v in b.items()}
    glob = Transformer(cfg, seed=0, device="cpu")
    models = [Transformer(cfg, seed=p + 1, device="cpu") for p in range(P)]
    twin = Transformer(cfg, seed=1, device="cpu")
    before = [p.detach().clone() for p in models[1].parameters()]
    states = [opt.init(m.parameters()) for m in models]
    models, states, losses = built.step(models, states, batch_p, glob,
                                        torch.tensor([True, False]))
    assert torch.isfinite(losses).all()
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 models[1].parameters()))
    inner = make_personalize_partition_step(lambda m, x: m.train_loss(x),
                                            opt, GPHyperParams())
    _, _, want = inner(twin, opt.init(twin.parameters()),
                       {k: v[0] for k, v in batch_p.items()}, glob, True)
    assert torch.equal(losses[0], want)
    assert all(torch.equal(a, b) for a, b in zip(models[0].parameters(),
                                                 twin.parameters()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_adamw_update_in_place_is_bitwise_update(dtype):
    """``AdamW.update_`` (clip, weight decay, warmup; three steps) leaves
    bitwise the weights and moments that ``update`` followed by ``p + u``
    gives, in the moment tensors it was handed, and drops every gradient
    of the list it was given."""
    from repro_torch.train.optim import AdamW

    rng = np.random.default_rng(5)
    shapes = [(7, 5), (5,), (3, 4, 2)]
    opt = AdamW(lr=1e-2, weight_decay=0.1, grad_clip=0.5, warmup_steps=2)
    ref = [torch.tensor(rng.normal(0, 1, sh), dtype=dtype) for sh in shapes]
    mine = [t.clone() for t in ref]
    st_ref, st = opt.init(ref), opt.init(mine)
    for _ in range(3):
        grads = [torch.tensor(rng.normal(0, 2, sh), dtype=dtype)
                 for sh in shapes]
        upd, st_ref = opt.update(grads, st_ref, ref)
        ref = [p + u for p, u in zip(ref, upd)]
        given, mu = list(grads), st.mu
        st = opt.update_(given, st, mine)
        assert given == [None] * len(shapes)
        assert all(a is b for a, b in zip(st.mu, mu))
        assert torch.equal(st.step, st_ref.step)
        for a, b in zip(mine + st.mu + st.nu, ref + st_ref.mu + st_ref.nu):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch", ["mamba2-370m", "phi3.5-moe-42b-a6.6b"])
def test_personalize_step_in_place_is_bitwise(arch):
    """``make_personalize_partition_step(..., inplace=True)``, the step
    ``launch.train llm``'s phase 1 takes: two steps give bitwise the loss,
    the weights and the moments of the functional step, and an inactive
    partition is refused."""
    from repro_torch.core.gp.trainer import (GPHyperParams,
                                             make_personalize_partition_step)
    from repro_torch.train.optim import AdamW

    cfg = get_config(arch).reduced()
    opt = AdamW(lr=1e-3, weight_decay=0.01, grad_clip=1.0)
    loss_fn = lambda m, x: m.train_loss(x)
    glob = Transformer(cfg, seed=0, device="cpu")
    models = [Transformer(cfg, seed=1, device="cpu") for _ in range(2)]
    states = [opt.init(m.parameters()) for m in models]
    steps = [make_personalize_partition_step(loss_fn, opt, GPHyperParams(),
                                             inplace=i) for i in (False, True)]
    for seed in (3, 4):
        b = {k: torch.as_tensor(v) for k, v in
             _batch(cfg, 2, SEQ[arch], seed=seed).items()}
        out = [step(m, st, b, glob, True)
               for step, m, st in zip(steps, models, states)]
        states = [o[1] for o in out]
        assert torch.equal(out[0][2], out[1][2])
        for a, c in zip(list(models[0].parameters()) + states[0].mu
                        + states[0].nu,
                        list(models[1].parameters()) + states[1].mu
                        + states[1].nu):
            assert torch.equal(a, c)
    with pytest.raises(ValueError, match="active partition"):
        steps[1](models[1], states[1], b, glob, torch.tensor(False))


def test_llm_phase0_step_is_bitwise_the_functional_step():
    """``launch.train.llm_phase0_step`` (gradients summed and averaged in
    place, ``AdamW.update_``) against the same step spelled with
    ``AdamW.update``: two steps over 2 shards, bitwise."""
    from repro_torch.launch.train import llm_phase0_step
    from repro_torch.train.optim import AdamW

    cfg = get_config("mamba2-370m").reduced()
    opt = AdamW(lr=3e-3, grad_clip=1.0)
    mine, ref = (Transformer(cfg, seed=0, device="cpu") for _ in range(2))
    st, st_ref = opt.init(mine.parameters()), opt.init(ref.parameters())
    for seed in (6, 7):
        b = _batch(cfg, 4, SEQ["mamba2-370m"], seed=seed)
        nb = {k: torch.as_tensor(v.reshape(2, 2, -1)) for k, v in b.items()}
        st, losses = llm_phase0_step(mine, opt, st, nb, 2)
        w = list(ref.parameters())
        acc, want = None, []
        for p in range(2):
            loss = ref.train_loss({k: v[p] for k, v in nb.items()})
            g = torch.autograd.grad(loss, w)
            want.append(loss.item())
            acc = list(g) if acc is None else [a + x for a, x in zip(acc, g)]
        upd, st_ref = opt.update([a / 2 for a in acc], st_ref, w)
        with torch.no_grad():
            for p, u in zip(w, upd):
                p.add_(u)
        assert losses == want
        for a, c in zip(list(mine.parameters()) + st.mu + st.nu,
                        w + st_ref.mu + st_ref.nu):
            assert torch.equal(a, c)


def test_ssd_gradient_is_finite_where_the_masked_exponent_overflows():
    """``_ssd_chunked`` under autograd with decays whose upper-triangle
    exponent overflows f32 (the double ``where``): every gradient finite and
    equal to ``jax.grad`` of the reference's, across two chunk
    boundaries."""
    rng = np.random.default_rng(0)
    b, s, h, p, n, chunk = 1, 48, 2, 4, 3, 16
    xh = rng.normal(0, 1, (b, s, h, p)).astype(np.float32)
    # one spike a chunk: the exponent across it overflows above the
    # diagonal, the decays elsewhere stay informative
    dt = rng.uniform(0.01, 0.1, (b, s, h)).astype(np.float32)
    dt[:, 5::chunk] = 40.0
    a = np.array([-4.0, -3.0], np.float32)
    bm = rng.normal(0, 1, (b, s, n)).astype(np.float32)
    cm = rng.normal(0, 1, (b, s, n)).astype(np.float32)

    def j_loss(*args):
        y, st = JL._ssd_chunked(*args[:3], *args[3:], chunk)
        return y.sum() + st.sum()

    jgrads = jax.grad(j_loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(v) for v in (xh, dt, a, bm, cm)))
    ts = [torch.tensor(v, requires_grad=True) for v in (xh, dt, a, bm, cm)]
    y, st = L._ssd_chunked(*ts[:3], *ts[3:], chunk)
    grads = torch.autograd.grad(y.sum() + st.sum(), ts)
    for name, g, w in zip(("xh", "dt", "a", "b", "c"), grads, jgrads):
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4 * (float(np.abs(w).max())
                                                or 1.0),
                                   err_msg=name)


# --------------------------------------------------------------------------
# launch.train llm --arch mamba2-370m
# --------------------------------------------------------------------------

TINY = ["--arch", "mamba2-370m", "--shards", "2", "--d-model", "64",
        "--seq", "32", "--docs", "64", "--steps", "4", "--phase0-frac",
        "0.5", "--seed", "0"]


def test_cli_mamba2_matches_reference_run_llm(monkeypatch):
    """``launch.train llm --arch mamba2-370m --device cpu`` on reduced
    widths from the reference's initial weights: ``shard_entropies``
    bitwise, both final losses within CLI_LOSS_ATOL of the reference's
    ``run_llm``; no kernel launches on the CPU."""
    import repro_torch.launch.train as T
    from repro.launch.train import run_llm as j_run_llm

    want = j_run_llm(argparse.Namespace(
        arch="mamba2-370m", shards=2, method="ew", no_cbs=False, steps=4,
        phase0_frac=0.5, lambda_prox=0.01, docs=64, seq=32, batch=8,
        d_model=64, seed=0))
    jp = JTransformer(j_get_config("mamba2-370m").reduced(d_model=64)).init(0)
    monkeypatch.setattr(T, "_llm_model", lambda cfg, seed, device:
                        params_from_jax(_np_tree(jp), cfg, device=device))
    got = T.run_llm(T.build_parser().parse_args(
        ["llm", *TINY, "--device", "cpu"]))
    assert got["shard_entropies"] == want["shard_entropies"]
    np.testing.assert_allclose(got["phase0_final_loss"],
                               want["phase0_final_loss"], atol=CLI_LOSS_ATOL)
    np.testing.assert_allclose(got["phase1_final_loss"],
                               want["phase1_final_loss"], atol=CLI_LOSS_ATOL)
    assert got["launches_per_step"] == [[0, 0, 0, 0]] * 4


def test_cli_depth_cut_and_phase0_state(monkeypatch):
    """``--num-repeats`` and ``--sub-layers`` cut the published depth,
    leaving the widths and the experts (jamba's first 2 sub-layers:
    attention + MLP, Mamba2 + MoE); phase 1 frees phase 0's
    AdamW state, so a run with phase 1 returns none, and a phase-0-only
    run returns it."""
    import repro_torch.launch.train as T

    seen = []

    def model(cfg, seed, device):
        seen.append(cfg)
        return Transformer(dataclasses.replace(cfg, d_model=64, d_ff=128,
                                               num_heads=4, num_kv_heads=2,
                                               head_dim=16,
                                               ssm_state=16, ssm_headdim=16,
                                               ssm_chunk=32, vocab_size=512),
                           seed=seed, device=device)

    monkeypatch.setattr(T, "_llm_model", model)
    base = ["llm", "--arch", "jamba-v0.1-52b", "--full", "--shards", "1",
            "--batch", "2", "--seq", "32", "--docs", "16", "--num-repeats",
            "1", "--sub-layers", "2", "--device", "cpu"]
    got = T.run_llm(T.build_parser().parse_args(
        base + ["--steps", "2", "--phase0-frac", "0.5"]))
    full = get_config("jamba-v0.1-52b")
    assert seen[0] == dataclasses.replace(full, num_repeats=1,
                                          super_block=full.super_block[:2])
    assert [(sl.mixer, sl.ffn) for sl in seen[0].super_block] == [
        ("attention", "mlp"), ("mamba2", "moe")]
    assert got["opt_state"] is None and len(got["replicas"]) == 1
    assert np.isfinite(got["phase0_final_loss"])
    assert np.isfinite(got["phase1_final_loss"]).all()
    only0 = T.run_llm(T.build_parser().parse_args(
        base + ["--steps", "1", "--phase0-frac", "1.0"]))
    assert int(only0["opt_state"].step) == 1
