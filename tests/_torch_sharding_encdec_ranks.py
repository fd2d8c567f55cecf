"""What one rank of the sharded encoder-decoder and prefix-LM tests runs.

``tests/test_torch_sharding_encdec.py`` spawns a world of 4 ranks on the
CPU (``repro_torch.launch.mesh.spawn_partition_world`` over the ``staged``
backend, whose collectives run on an inner gloo group and are counted) and
a world of 1; each rank imports this module, which imports nothing of JAX,
builds the port's whisper-small or paligemma-3b from the reference's
weights (numpy trees the test hands over), runs
``launch/steps.py::build_step``'s steps on a mesh with the arch's extra
input in the batch (``enc_embeds``, ``patch_embeds``) and hands back the
full tensors for the test to hold against the reference and against the
port's unsharded steps.
"""
import dataclasses

import numpy as np
import torch

from _torch_sharding_ranks import _bytes, _full, _launches, _names, optimizer
from repro_torch.configs import InputShape, get_config
from repro_torch.launch import staged_backend as sb
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.launch.steps import _sync, build_step
from repro_torch.models import params_from_jax
from repro_torch.models.sharded import step_collective_bytes
from repro_torch.train.optim import global_norm

# (arch, ModelConfig overrides of the reduced config): whisper with an odd
# vocabulary, as whisper-small's 51,865 (the tied head stays replicated),
# and 30 encoder frames (split over a model axis of 2, replicated over 4);
# whisper with 6 heads (they divide no model axis of 4: every rank computes
# all of them, in self- and cross-attention, and the self-attention's decode
# cache is the context-parallel one); paligemma reduced (4 query heads over
# one KV head, a prefix of 16 patches: the decode cache is the
# context-parallel one)
WHISPER = {"vocab_size": 515, "encoder_seq": 30}
CASES = {
    "whisper": ("whisper-small", WHISPER),
    "whisper-h6": ("whisper-small", {**WHISPER, "num_heads": 6,
                                     "num_kv_heads": 6, "head_dim": 64}),
    "paligemma": ("paligemma-3b", {}),
}
MESHES = [
    ("2x2", (2, 2), ("data", "model"), ("whisper", "paligemma")),
    ("1x4", (1, 4), ("data", "model"), ("whisper", "whisper-h6",
                                        "paligemma")),
]
B, S, DECODE = 4, 16, 8
PERSONALIZE = ("whisper", "paligemma")
PARTS = 2


def case_cfg(name: str):
    arch, over = CASES[name]
    return dataclasses.replace(get_config(arch).reduced(), **over)


def width(cfg) -> int:
    """The decode cache's slots: the prefix, the prompt and the steps."""
    return cfg.prefix_tokens + S + DECODE


def extra_inputs(cfg, rng, b) -> dict:
    """The arch's extra input, standard normal f32: ``enc_embeds`` (b,
    encoder_seq, d) or ``patch_embeds`` (b, P, d)."""
    out = {}
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = rng.normal(
            0, 1, (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.prefix_tokens:
        out["patch_embeds"] = rng.normal(
            0, 1, (b, cfg.prefix_tokens, cfg.d_model)).astype(np.float32)
    return out


def train_batch(cfg, seed: int = 9) -> dict:
    """Tokens, next-token labels (the first 3 of each row and the last
    masked) and the extra input."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -1)], axis=1)
    labels[:, :3] = -1
    return {"tokens": tokens, "labels": labels, **extra_inputs(cfg, rng, B)}


def prompt(cfg, seed: int = 4) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int64), **extra_inputs(cfg, rng, B)}


def personalize_batch(cfg) -> dict:
    """4 rows of 12 tokens with their extra input, split over ``PARTS``
    partitions."""
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, (4, 12))
    labels = np.concatenate([tokens[:, 1:], np.full((4, 1), -1)], axis=1)
    batch = {"tokens": tokens, "labels": labels,
             **extra_inputs(cfg, rng, 4)}
    return {k: v.reshape(PARTS, 4 // PARTS, *v.shape[1:])
            for k, v in batch.items()}


def _caches(caches) -> dict:
    """The self-attention caches and, with cross-attention, the cross
    caches, full, stacked over the layers."""
    out = {key: np.stack([_full(c[key]) for c in caches])
           for key in ("k", "v")}
    if "cross" in caches[0]:
        for key in ("k", "v"):
            out[f"cross_{key}"] = np.stack([_full(c["cross"][key])
                                            for c in caches])
    return out


def shapes(cfg):
    n = cfg.prefix_tokens + S
    return (InputShape("tiny_train", n, B, "train"),
            InputShape("tiny_prefill", n, B, "prefill"),
            InputShape("tiny_decode", width(cfg), B, "decode"))


def run_case(cfg, tree, mesh, device="cpu"):
    """One config on ``mesh`` (None: the unsharded steps): the train step
    (loss, gradients and their global norm, weights after one AdamW step),
    the prefill (logits, every cache) and 8 greedy decode steps (logits,
    tokens, caches) from a prefill into a cache of ``width(cfg)`` slots;
    each step kind's kernel launches; with a mesh also each step's
    collective bytes beside the closed form."""
    out = {"launches": {}}

    def weights():
        if tree is None:
            from repro_torch.models import Transformer
            return Transformer(cfg, seed=0, device=device)
        return params_from_jax(tree, cfg, device=device)

    train, pre_shape, dec_shape = shapes(cfg)
    opt = optimizer()
    built = build_step(cfg, train, mesh, optimizer=opt)
    model = built.shard_model(weights())
    names = [n for n, _ in model.named_parameters()]
    batch = train_batch(cfg)
    loss = model.train_loss(batch)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    if mesh is not None:
        grads = _sync(grads, list(model.parameters()))
    out["grads"] = {n: _full(g) for n, g in zip(names, grads)}
    out["grad_norm"] = float(_full(global_norm(grads)))
    state = opt.init(model.parameters())
    sb.reset_staged_bytes()
    _launches()
    model, state, loss = built.step(model, state, batch)
    out["launches"]["train"] = _launches()
    out["train_bytes"] = _bytes()
    out["loss"] = float(_full(loss))
    out["params"] = {n: _full(p) for n, p in model.named_parameters()}
    model = built.shard_model(weights())
    pre = build_step(cfg, pre_shape, mesh)
    inputs = prompt(cfg)
    sb.reset_staged_bytes()
    _launches()
    logits, caches, n = pre.step(model, inputs)
    out["launches"]["prefill"] = _launches()
    out["prefill_bytes"] = _bytes()
    out["prefill"] = _full(logits)
    out["prefill_caches"] = _caches(caches)
    if mesh is not None:
        out["cache_placements"] = _names(caches[0]["k"].placements)
        if "cross" in caches[0]:
            out["cross_placements"] = _names(
                caches[0]["cross"]["k"].placements)
        out["logits_placements"] = _names(logits.placements)
    dec = build_step(cfg, dec_shape, mesh)
    logits, caches, n = model.prefill(inputs, cache_size=width(cfg))
    tok = np.argmax(_full(logits), axis=-1)[:, None]
    steps, tokens = [], [tok[:, 0]]
    for t in range(DECODE):
        sb.reset_staged_bytes()
        _launches()
        logits, caches = dec.step(model, tok, caches, n + t)
        if t == 0:
            out["decode_bytes"] = _bytes()
            out["launches"]["decode"] = _launches()
        full = _full(logits)
        steps.append(full)
        tok = np.argmax(full, axis=-1)[:, None]
        tokens.append(tok[:, 0])
    out["decode"] = np.stack(steps)
    out["tokens"] = np.stack(tokens, axis=1)
    out["decode_caches"] = _caches(caches)
    if mesh is not None:
        pol = built.policy
        out["closed_form"] = {
            "train": step_collective_bytes(cfg, "train", B, S, pol),
            "prefill": step_collective_bytes(cfg, "prefill", B, S, pol),
            "decode": step_collective_bytes(cfg, "decode", B, 1, pol,
                                            cache_width=width(cfg))}
    return out


def run_personalize(cfg, global_tree, replica_trees, mesh, active,
                    device="cpu"):
    """One personalize step over ``PARTS`` replicas: each rank's replicas'
    weights after it (full, keyed by the replica's index), the losses and
    the step's kernel launches."""
    opt = optimizer()
    shape = InputShape("tiny_train", cfg.prefix_tokens + 12, 4, "train")
    built = build_step(cfg, shape, mesh, phase="personalize",
                       num_partitions=PARTS, optimizer=opt)
    glob = built.shard_model(params_from_jax(global_tree, cfg,
                                             device=device))
    models = built.shard_replicas([params_from_jax(t, cfg, device=device)
                                   for t in replica_trees])
    lo = 0 if mesh is None else built._replicas[0]
    states = [opt.init(m.parameters()) for m in models]
    _launches()
    models, states, losses = built.step(models, states,
                                        personalize_batch(cfg), glob,
                                        np.asarray(active))
    return {"losses": _full(losses), "launches": _launches(),
            "params": {lo + j: {n: _full(p) for n, p in m.named_parameters()}
                       for j, m in enumerate(models)},
            "steps": {lo + j: int(s.step) for j, s in enumerate(states)}}


def world_checks(rank, trees, personalize):
    """Every mesh case of the world of 4 and the personalize step of each
    arch on ``(2, 2)``.  Rank 0 hands back the full results, the others a
    digest of theirs (every rank must hold the same full tensors)."""
    torch.set_num_threads(1)
    out = {}
    for mname, shape, axes, cases in MESHES:
        mesh = make_mesh_compat(shape, axes)
        for name in cases:
            out[mname, name] = run_case(case_cfg(name), trees[name], mesh)
    mesh = make_mesh_compat((2, 2), ("data", "model"))
    for name in PERSONALIZE:
        g, reps, active = personalize[name]
        out["personalize", name] = run_personalize(case_cfg(name), g, reps,
                                                   mesh, active)
    if rank == 0:
        return out
    return {k: (v["loss"], float(v["prefill"].sum()), v["tokens"].tolist())
            if k[0] != "personalize" else v for k, v in out.items()}


def world_of_one(rank, trees, personalize):
    """A world of 1 on a (1, 1) mesh: every step kind of both archs
    against the same step with ``mesh=None``, bitwise."""
    torch.set_num_threads(1)
    mesh = make_mesh_compat((1, 1), ("data", "model"))
    out = {}
    for name in PERSONALIZE:
        cfg = case_cfg(name)
        out[name] = (run_case(cfg, trees[name], mesh),
                     run_case(cfg, trees[name], None))
        g, reps, active = personalize[name]
        out["personalize", name] = (
            run_personalize(cfg, g, reps, mesh, active),
            run_personalize(cfg, g, reps, None, active))
    return out
