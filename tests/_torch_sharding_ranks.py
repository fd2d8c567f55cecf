"""What one rank of the sharded LLM step tests runs.

``tests/test_torch_sharding_world.py`` spawns a world of 4 ranks on the CPU
(``repro_torch.launch.mesh.spawn_partition_world`` over the ``staged``
backend, whose collectives run on an inner gloo group and are counted) and
a world of 1; each rank imports this module, which imports nothing of JAX,
builds the port's models from the reference's weights (numpy trees the
test hands over), runs ``launch/steps.py::build_step``'s steps on a mesh
and hands back the full tensors (``full_tensor``) for the test to hold
against the reference and against the port's unsharded steps.
"""
import dataclasses

import numpy as np
import torch

from repro_torch.configs import InputShape, get_config
from repro_torch.launch import staged_backend as sb
from repro_torch.launch.mesh import make_mesh_compat, make_production_mesh
from repro_torch.launch.steps import build_step
from repro_torch.models import params_from_jax
from repro_torch.models.sharded import step_collective_bytes
from repro_torch.train.optim import AdamW, global_norm

# (arch, ModelConfig overrides of the reduced config): qwen2 (GQA 4/2,
# qkv bias, tied), llama (MHA 4/4), qwen2 with one KV head (the KV heads do
# not divide "model": each rank takes the KV head its query heads read, and
# the decode cache is the context-parallel one), qwen2 with 6 query heads
# (they do not divide a model axis of 4: every rank computes them all)
CASES = {
    "qwen2": ("qwen2-0.5b", {}),
    "llama": ("llama3.2-1b", {}),
    "qwen2-mqa": ("qwen2-0.5b", {"num_kv_heads": 1}),
    "qwen2-h6": ("qwen2-0.5b", {"num_heads": 6, "head_dim": 64}),
}
# (mesh name, shape, axis names, cases)
MESHES = [
    ("2x2", (2, 2), ("data", "model"), ("qwen2", "llama", "qwen2-mqa")),
    ("2x2x1", (2, 2, 1), ("pod", "data", "model"), ("qwen2", "llama")),
    ("1x4", (1, 4), ("data", "model"), ("qwen2-h6",)),
]
B, S, DECODE = 4, 16, 8
WIDTH = S + DECODE
TRAIN = InputShape("tiny_train", S, B, "train")
PREFILL = InputShape("tiny_prefill", S, B, "prefill")
DECODE_SHAPE = InputShape("tiny_decode", WIDTH, B, "decode")
PERSONALIZE_CASE, PARTS = "llama", 2


def optimizer() -> AdamW:
    return AdamW(lr=1e-3, weight_decay=0.01, grad_clip=1.0)


def case_cfg(name: str):
    arch, over = CASES[name]
    return dataclasses.replace(get_config(arch).reduced(), **over)


def train_batch(cfg, seed: int = 9) -> dict:
    """Tokens and next-token labels, the first 3 labels of each row and the
    last masked."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -1)], axis=1)
    labels[:, :3] = -1
    return {"tokens": tokens, "labels": labels}


def prompt(cfg, seed: int = 4) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int64)


def _full(t):
    t = t.full_tensor() if type(t).__name__ == "DTensor" else t
    return t.detach().cpu().numpy().copy()


def _names(placements) -> list:
    """``Shard(d)`` as ``"S0"``, ``Replicate()`` as ``"R"``."""
    return [f"S{p.dim}" if p.is_shard() else "R" for p in placements]


def _bytes():
    out = {k: sb.staged_bytes(k) for k in ("all_gather", "reduce_scatter",
                                           "all_reduce")}
    sb.reset_staged_bytes()
    return out


def _launches():
    """The kernels' launch counts since the last call (then zeroed)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    out = {d: fa.flash_launch_count(d)
           for d in ("prefill", "decode", "train", "backward")}
    out.update(rmsnorm=rn.rmsnorm_launch_count(),
               add_rmsnorm=rn.add_rmsnorm_launch_count(),
               rmsnorm_bwd=rn.rmsnorm_bwd_launch_count(),
               add_rmsnorm_bwd=rn.add_rmsnorm_bwd_launch_count())
    fa.reset_flash_launch_count()
    rn.reset_rmsnorm_launch_count()
    return out


def run_case(cfg, tree, mesh, device="cpu"):
    """One config on ``mesh`` (None: the unsharded steps): the train step
    (loss, gradients, weights after one AdamW step), the prefill (logits,
    caches) and 8 greedy decode steps (logits, tokens) from a prefill into
    a cache of ``WIDTH`` slots; with a mesh also each step's collective
    bytes beside the closed form.  ``tree`` None: the weights from seed 0.
    Each step kind's kernel launches are counted (``launches``); the
    gradients' global norm (``grad_norm``) is the one AdamW's clip takes."""
    out = {"launches": {}}

    def weights():
        if tree is None:
            from repro_torch.models import Transformer
            return Transformer(cfg, seed=0, device=device)
        return params_from_jax(tree, cfg, device=device)

    opt = optimizer()
    built = build_step(cfg, TRAIN, mesh, optimizer=opt)
    model = built.shard_model(weights())
    names = [n for n, _ in model.named_parameters()]
    batch = train_batch(cfg)
    # the gradients of the loss the step descends
    loss = model.train_loss(batch)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    if mesh is not None:
        from repro_torch.launch.steps import _sync
        grads = _sync(grads, list(model.parameters()))
    out["grads"] = {n: _full(g) for n, g in zip(names, grads)}
    # the norm AdamW's clip divides by: of the full gradients on a mesh
    out["grad_norm"] = float(_full(global_norm(grads)))
    state = opt.init(model.parameters())
    sb.reset_staged_bytes()
    _launches()
    model, state, loss = built.step(model, state, batch)
    out["launches"]["train"] = _launches()
    out["train_bytes"] = _bytes()
    out["loss"] = float(_full(loss))
    out["params"] = {n: _full(p) for n, p in model.named_parameters()}
    # prefill (the built step) and greedy decode
    model = built.shard_model(weights())
    pre = build_step(cfg, PREFILL, mesh)
    toks = prompt(cfg)
    sb.reset_staged_bytes()
    _launches()
    logits, caches, n = pre.step(model, {"tokens": toks})
    out["launches"]["prefill"] = _launches()
    out["prefill_bytes"] = _bytes()
    out["prefill"] = _full(logits)
    out["prefill_k"] = np.stack([_full(c["k"]) for c in caches])
    out["prefill_v"] = np.stack([_full(c["v"]) for c in caches])
    if mesh is not None:
        out["cache_placements"] = _names(caches[0]["k"].placements)
        out["logits_placements"] = _names(logits.placements)
    dec = build_step(cfg, DECODE_SHAPE, mesh)
    logits, caches, n = model.prefill({"tokens": toks}, cache_size=WIDTH)
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
    out["decode_k"] = np.stack([_full(c["k"]) for c in caches])
    if mesh is not None:
        pol = built.policy
        out["closed_form"] = {
            "train": step_collective_bytes(cfg, "train", B, S, pol),
            "prefill": step_collective_bytes(cfg, "prefill", B, S, pol),
            "decode": step_collective_bytes(cfg, "decode", B, 1, pol,
                                            cache_width=WIDTH)}
    return out


def run_personalize(cfg, global_tree, replica_trees, mesh, active,
                    device="cpu"):
    """One personalize step over ``PARTS`` replicas: each rank's replicas'
    weights after it (full, keyed by the replica's index), the losses and
    the step's kernel launches.  Trees None: the global weights from seed
    0, replica p from seed p + 1."""
    from repro_torch.models import Transformer

    def weights(tree, seed):
        if tree is None:
            return Transformer(cfg, seed=seed, device=device)
        return params_from_jax(tree, cfg, device=device)

    opt = optimizer()
    shape = InputShape("tiny_train", 12, 4, "train")
    built = build_step(cfg, shape, mesh, phase="personalize",
                       num_partitions=PARTS, optimizer=opt)
    glob = built.shard_model(weights(global_tree, 0))
    models = built.shard_replicas([weights(t, p + 1)
                                   for p, t in enumerate(replica_trees)])
    lo = 0 if mesh is None else built._replicas[0]
    states = [opt.init(m.parameters()) for m in models]
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, (4, 12))
    labels = np.concatenate([tokens[:, 1:], np.full((4, 1), -1)], axis=1)
    batch_p = {"tokens": tokens.reshape(PARTS, 2, 12),
               "labels": labels.reshape(PARTS, 2, 12)}
    _launches()
    models, states, losses = built.step(models, states, batch_p, glob,
                                        np.asarray(active))
    return {"losses": _full(losses), "launches": _launches(),
            "params": {lo + j: {n: _full(p) for n, p in m.named_parameters()}
                       for j, m in enumerate(models)},
            "steps": {lo + j: int(s.step) for j, s in enumerate(states)}}


def world_checks(rank, trees, personalize):
    """Every mesh case of the world of 4; the refusals of a mesh that is
    not the world's size.  Rank 0 hands back the full results, the others
    a digest of theirs (every rank must hold the same full tensors)."""
    torch.set_num_threads(1)
    out = {}
    for mname, shape, axes, cases in MESHES:
        mesh = make_mesh_compat(shape, axes)
        for name in cases:
            out[mname, name] = run_case(case_cfg(name), trees[name], mesh)
    mesh = make_mesh_compat((2, 2), ("data", "model"))
    g, reps, active = personalize
    out["personalize"] = run_personalize(case_cfg(PERSONALIZE_CASE), g, reps,
                                         mesh, active)
    errors = []
    for bad in ((2, 4), (1, 2)):
        try:
            make_mesh_compat(bad, ("data", "model"))
        except ValueError as e:
            errors.append(str(e))
    try:
        make_production_mesh()
    except ValueError as e:
        errors.append(str(e))
    out["errors"] = errors
    if rank == 0:
        return out
    return {"digest": {k: (v["loss"], float(v["prefill"].sum()),
                           v["tokens"].tolist()) for k, v in out.items()
                       if isinstance(k, tuple)},
            "personalize": out["personalize"]}


def world_of_one(rank, trees, personalize):
    """A world of 1 on a (1, 1) mesh: every step kind against the same
    step with ``mesh=None``, bitwise."""
    torch.set_num_threads(1)
    mesh = make_mesh_compat((1, 1), ("data", "model"))
    out = {}
    for name in ("qwen2", "llama"):
        cfg = case_cfg(name)
        out[name] = (run_case(cfg, trees[name], mesh),
                     run_case(cfg, trees[name], None))
    g, reps, active = personalize
    cfg = case_cfg(PERSONALIZE_CASE)
    out["personalize"] = (run_personalize(cfg, g, reps, mesh, active),
                          run_personalize(cfg, g, reps, None, active))
    return out


def card_checks(rank, mesh_shape):
    """On the card, with the kernels: reduced f32 qwen2-0.5b from seed 0
    through the four step kinds on a ``mesh_shape`` ``("data", "model")``
    mesh, and (the same rank, the same weights) through the unsharded
    steps; each step's launches and collective bytes."""
    torch.set_num_threads(1)
    mesh = make_mesh_compat(mesh_shape, ("data", "model"))
    cfg = case_cfg("qwen2")
    out = {"sharded": run_case(cfg, None, mesh, device="cuda"),
           "plain": run_case(cfg, None, None, device="cuda")}
    active = np.array([True, False])
    reps = [None] * PARTS
    out["personalize"] = (
        run_personalize(cfg, None, reps, mesh, active, device="cuda"),
        run_personalize(cfg, None, reps, None, active, device="cuda"))
    return out
