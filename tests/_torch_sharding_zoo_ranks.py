"""What one rank of the sharded MoE and Mamba2 tests runs.

``tests/test_torch_sharding_zoo.py`` spawns a world of 4 ranks on the CPU
(``repro_torch.launch.mesh.spawn_partition_world`` over the ``staged``
backend, whose collectives run on an inner gloo group and are counted) and
a world of 1; each rank imports this module, which imports nothing of JAX,
builds the port's phi3.5-moe, mamba2-370m or jamba from the reference's
weights (numpy trees the test hands over), runs
``launch/steps.py::build_step``'s steps on a mesh and hands back the full
tensors for the test to hold against the reference and against the port's
unsharded steps, with every MoE routing call's kept choices.
"""
import dataclasses

import numpy as np
import torch

from _torch_sharding_ranks import _bytes, _full, _launches, _names, optimizer
from repro_torch.configs import InputShape, get_config
from repro_torch.launch import staged_backend as sb
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.launch.steps import _sync, build_step
from repro_torch.models import layers as L
from repro_torch.models import params_from_jax
from repro_torch.models.sharded import step_collective_bytes
from repro_torch.train.optim import global_norm

# (arch, ModelConfig overrides of the reduced config): phi3.5-moe with 4
# experts and a capacity factor of 0.75 (48 slots an expert for the 128
# tokens: data rank 0's tokens take about 32 of each, so data rank 1's
# later choices are dropped), the same with 6 experts (they divide no
# model axis of 4: each rank runs its range of the replicated experts),
# mamba2-370m reduced (16 SSM heads), mamba2 with 6 heads (d_model 96:
# they divide no model axis of 4, nor does in_proj's 454 columns, while
# ssm_norm, out_proj and the conv channels split at cuts inside a head),
# mamba2 with d_model 64 (4 heads; a prefill's 64 rows a rank move more
# bytes than the weights, so it gathers in_proj and the conv's weights as
# training does, where the others' prefills gather the projected rows),
# jamba reduced (attention + MLP, Mamba2 + MoE, ... in one model), and
# jamba with remat on
CASES = {
    "phi": ("phi3.5-moe-42b-a6.6b", {"capacity_factor": 0.75}),
    "phi-e6": ("phi3.5-moe-42b-a6.6b", {"capacity_factor": 0.75,
                                         "num_experts": 6}),
    "mamba2": ("mamba2-370m", {}),
    "mamba2-h6": ("mamba2-370m", {"d_model": 96}),
    "mamba2-d64": ("mamba2-370m", {"d_model": 64}),
    "jamba": ("jamba-v0.1-52b", {}),
    "jamba-remat": ("jamba-v0.1-52b", {"remat": True}),
}
MESHES = [
    ("2x2", (2, 2), ("data", "model"), ("phi", "mamba2", "mamba2-d64",
                                        "jamba", "jamba-remat")),
    ("1x4", (1, 4), ("data", "model"), ("phi", "phi-e6", "mamba2",
                                        "mamba2-h6")),
]
B, S, DECODE = 4, 32, 8
WIDTH = S + DECODE
PERSONALIZE = "jamba"
PARTS = 2
# the cases of the world of 1, against mesh=None bitwise
ONE = ("phi", "jamba")


def case_cfg(name: str):
    arch, over = CASES[name]
    return dataclasses.replace(get_config(arch).reduced(), **over)


def train_batch(cfg, seed: int = 9) -> dict:
    """Tokens and next-token labels, the first 3 of each row and the last
    masked."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -1)], axis=1)
    labels[:, :3] = -1
    return {"tokens": tokens, "labels": labels}


def prompt(cfg, seed: int = 4) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int64)}


def personalize_batch(cfg) -> dict:
    """4 rows of S tokens split over ``PARTS`` partitions."""
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, (4, S))
    labels = np.concatenate([tokens[:, 1:], np.full((4, 1), -1)], axis=1)
    return {k: v.reshape(PARTS, 4 // PARTS, S)
            for k, v in {"tokens": tokens, "labels": labels}.items()}


def caches_of(caches) -> dict:
    """Every cache leaf, full, keyed ``"<layer>.<key>"``."""
    return {f"{i}.{k}": _full(v) for i, c in enumerate(caches)
            for k, v in c.items()}


class Routes:
    """Records every routing call of a mesh's MoE blocks inside the block
    (``layers.moe_route`` given the global token count): the kept choices
    (T, K) and the choices this rank's rows would keep with no earlier data
    ranks (no offset), on the host, in call order."""

    def __enter__(self):
        self.inner, self.calls = L.moe_route, []

        def route(p, xf, cfg, offset=None, tokens=None):
            out = self.inner(p, xf, cfg, offset=offset, tokens=tokens)
            if tokens is None:
                return out
            with torch.no_grad():
                alone = self.inner(p, xf, cfg, tokens=tokens)[4]
            k = out[2].shape[1]
            self.calls.append((out[4].reshape(-1, k).numpy().copy(),
                               alone.reshape(-1, k).numpy().copy()))
            return out

        L.moe_route = route
        return self

    def __exit__(self, *exc):
        L.moe_route = self.inner


def shapes():
    return (InputShape("tiny_train", S, B, "train"),
            InputShape("tiny_prefill", S, B, "prefill"),
            InputShape("tiny_decode", WIDTH, B, "decode"))


def run_case(cfg, tree, mesh, device="cpu"):
    """One config on ``mesh`` (None: the unsharded steps): the train step
    (loss, gradients and their global norm, weights after one AdamW step;
    the kept choices of its loss's MoE calls), the prefill (logits, every
    cache) and 8 greedy decode steps (logits, tokens, caches) from a
    prefill into a cache of ``WIDTH`` slots; each step kind's kernel
    launches; with a mesh also each step's collective bytes beside the
    closed form."""
    out = {"launches": {}}
    train, pre_shape, dec_shape = shapes()
    opt = optimizer()
    built = build_step(cfg, train, mesh, optimizer=opt)
    model = built.shard_model(params_from_jax(tree, cfg, device=device))
    names = [n for n, _ in model.named_parameters()]
    batch = train_batch(cfg)
    with Routes() as routes:
        loss = model.train_loss(batch)
    out["routes"] = routes.calls
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
    model = built.shard_model(params_from_jax(tree, cfg, device=device))
    pre = build_step(cfg, pre_shape, mesh)
    inputs = prompt(cfg)
    sb.reset_staged_bytes()
    _launches()
    logits, caches, n = pre.step(model, inputs)
    out["launches"]["prefill"] = _launches()
    out["prefill_bytes"] = _bytes()
    out["prefill"] = _full(logits)
    out["prefill_caches"] = caches_of(caches)
    if mesh is not None:
        out["cache_placements"] = {k: _names(v.placements)
                                   for i, c in enumerate(caches[:2])
                                   for k, v in c.items()}
    dec = build_step(cfg, dec_shape, mesh)
    logits, caches, n = model.prefill(inputs, cache_size=WIDTH)
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
    out["decode_caches"] = caches_of(caches)
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
    the step's kernel launches."""
    opt = optimizer()
    shape = InputShape("tiny_train", S, 4, "train")
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
    """Every mesh case of the world of 4 and the personalize step on
    ``(2, 2)``.  Rank 0 hands back the full results, the others a digest
    of theirs (every rank must hold the same full tensors) and their
    routes."""
    torch.set_num_threads(1)
    out = {}
    for mname, shape, axes, cases in MESHES:
        mesh = make_mesh_compat(shape, axes)
        for name in cases:
            out[mname, name] = run_case(case_cfg(name), trees[name], mesh)
    mesh = make_mesh_compat((2, 2), ("data", "model"))
    g, reps, active = personalize
    out["personalize"] = run_personalize(case_cfg(PERSONALIZE), g, reps,
                                         mesh, active)
    if rank == 0:
        return out
    return {k: {"digest": (v["loss"], float(v["prefill"].sum()),
                           v["tokens"].tolist()), "routes": v["routes"]}
            if k != "personalize" else v for k, v in out.items()}


def world_of_one(rank, trees, personalize):
    """A world of 1 on a (1, 1) mesh: every step kind of ``ONE``'s cases
    and the personalize step against the same with ``mesh=None``,
    bitwise."""
    torch.set_num_threads(1)
    mesh = make_mesh_compat((1, 1), ("data", "model"))
    out = {}
    for name in ONE:
        cfg = case_cfg(name)
        out[name] = (run_case(cfg, trees[name], mesh),
                     run_case(cfg, trees[name], None))
    g, reps, active = personalize
    cfg = case_cfg(PERSONALIZE)
    out["personalize"] = (run_personalize(cfg, g, reps, mesh, active),
                          run_personalize(cfg, g, reps, None, active))
    return out
