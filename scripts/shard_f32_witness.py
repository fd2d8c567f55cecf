#!/usr/bin/env python3
"""Which f32 gradient of paligemma-3b's train loss moves most between a world
of 4 on a ``(2, 2)`` mesh (the ``staged`` backend, four processes sharing
one CUDA card) and the unsharded steps (which phase 7b of ``chip_smoke.py``
holds bitwise to a world of 1), and whether that move is rounding. Four
witnesses of the same gradient, unsharded, from the same weights and batch:
the plain versions of the kernels in f32; the kernels in f32 with the
batch's rows reversed (the same loss, summed in another order); the plain
versions with the model in float64 (its norm scales and its loss head stay
f32, as the port holds them: the norm scales' gradients are summed in
float64 and rounded once to f32); and the world of 4 itself in float64 with
the plain versions (``--f64-seq``; its tied head frozen, which four ranks'
float64 gradients of do not fit one card), against the unsharded float64.
The float64 runs take the loss head in float64 too (``_HeadF64``).
paligemma-3b at its published width, cut to phase 7b's f32 depth
(``chip_smoke.SHARD_RUNS``: 2 layers), seed 0, 4 rows of 256 random patches
+ S text tokens (the batch phase 7b draws), for each S given. Prints, for
each S, the losses and the leaves with the largest world-of-4 difference:
every difference is the largest absolute one over the leaf's largest
unsharded f32 entry (a key bias's over its projection's, as phase 7b holds
them), with the card's name and power limit first.

    python3 scripts/shard_f32_witness.py [--seq 256 512] [--f64-seq 256]
        [--top 6]
"""
import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
import chip_smoke as cs  # noqa: E402

ARCH = "paligemma-3b"
from repro_torch.models.transformer import _ChunkedCE as _CE  # noqa: E402


def _run():
    return next(r for r in cs.SHARD_RUNS if r[0] == ARCH)


def _cfg(dtype="float32"):
    return cs.zoo_config(ARCH, _run()[5], dtype)


def _batch(torch, cfg, seq):
    b = _run()[1][0]
    return cs.encdec_batch(torch, cfg, b, seq, seed=0)


def world_rank(rank, seqs, f64_seqs, out_dir):
    """One rank of the world of 4: the gradients of the train loss at each
    S (f32 with the kernels; for each S of ``f64_seqs`` also float64 with
    the plain versions), gathered whole, saved by rank 0."""
    import torch

    from repro_torch.configs import InputShape
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.launch.steps import _sync, build_step

    mesh = make_mesh_compat(cs.SHARD_MESH, ("data", "model"))
    runs = [(s, False) for s in seqs] + [(s, True) for s in f64_seqs]
    for seq, f64 in runs:
        cfg = _cfg("float64" if f64 else "float32")
        shape = InputShape("witness", cfg.prefix_tokens + seq, _run()[1][0],
                           "train")
        built = build_step(cfg, shape, mesh)
        model = built.shard_model(_model(torch, f64))
        _head(f64)
        if f64:
            # the tied head's float64 gradient does not fit four ranks on
            # one card beside the rest: the body's leaves are compared
            model.embed.requires_grad_(False)
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        weights = [p for _, p in named]
        batch = _batch(torch, _cfg(), seq)
        if f64:
            batch = {k: v.double() if v.is_floating_point() else v
                     for k, v in batch.items()}
        loss = model.train_loss(batch)
        grads = _sync(torch.autograd.grad(loss, weights), weights)
        full = {}
        for (n, _), g in zip(named, grads):
            t = g.full_tensor()
            if rank == 0:
                full[n] = t.cpu()
            del t
        if rank == 0:
            torch.save({"loss": float(loss.detach()), "grads": full},
                       os.path.join(out_dir, f"w4_{seq}_{int(f64)}.pt"))
        del model, named, weights, grads, full, loss
        torch.cuda.empty_cache()
    return rank


class _HeadF64:
    """The loss head in float64, for the float64 runs only: the port's
    ``_ChunkedCE`` casts the head and its logits to f32 (as the reference
    does), which would leave f32 rounding in a float64 witness.  The whole
    (T, V) logits at once, under autograd."""

    @staticmethod
    def apply(h, w_head, labels, chunk, mean=True):
        import torch

        logp = torch.log_softmax(h @ w_head.to(h.dtype), dim=-1)
        wgt = (labels >= 0).to(h.dtype)
        tot = -(logp.gather(1, labels.clamp_min(0)[:, None])[:, 0]
                * wgt).sum()
        return tot / torch.clamp_min(wgt.sum(), 1.0) if mean else tot


def _head(f64):
    """Put the float64 head in place for a float64 run, the port's back
    otherwise."""
    from repro_torch.models import transformer as tm

    tm._ChunkedCE = _HeadF64 if f64 else _CE


def _model(torch, f64):
    """The model of seed 0 in f32 with the kernels, or its weights in
    float64 with the plain versions."""
    from repro_torch.models import Transformer

    model = Transformer(_cfg(), seed=0, device="cuda")
    if not f64:
        return model
    m64 = Transformer(_cfg("float64"), seed=0, device="cuda",
                      use_kernels=False)
    with torch.no_grad():
        for a, b in zip(m64.parameters(), model.parameters(), strict=True):
            a.copy_(b)
    return m64


def unsharded(torch, seq, *, kernels=True, reverse=False, f64=False):
    """The unsharded loss and gradients (on the host, by name)."""
    model = _model(torch, f64)
    model.use_kernels = kernels and not f64
    _head(f64)
    batch = _batch(torch, _cfg(), seq)
    if reverse:
        batch = {k: v.flip(0) for k, v in batch.items()}
    if f64:
        batch = {k: v.double() if v.is_floating_point() else v
                 for k, v in batch.items()}
    weights = list(model.parameters())
    loss = model.train_loss(batch)
    grads = torch.autograd.grad(loss, weights)
    out = {n: g.detach().cpu() for (n, _), g in zip(model.named_parameters(),
                                                    grads)}
    loss = float(loss.detach())
    del model, weights, grads
    torch.cuda.empty_cache()
    return loss, out


def _load(torch, tmp, seq, f64):
    """Rank 0's saved gradients at S (None where that run was not asked
    for), the file removed."""
    path = os.path.join(tmp, f"w4_{seq}_{f64}.pt")
    if not os.path.exists(path):
        return None
    out = torch.load(path, weights_only=False)
    os.remove(path)
    return out


def main() -> int:
    import torch

    from repro_torch.kernels import build
    from repro_torch.launch.mesh import spawn_partition_world

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seq", type=int, nargs="+", default=[256, 512])
    ap.add_argument("--f64-seq", type=int, nargs="*", default=[256])
    ap.add_argument("--top", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    card = card.splitlines()[0]
    cs.log(card)
    t_all = time.perf_counter()
    build.build_all()
    tmp = tempfile.mkdtemp(prefix="witness_")
    try:
        spawn_partition_world(world_rank, 4, (args.seq, args.f64_seq, tmp),
                              backend="staged", device="cuda",
                              timeout_s=600, join_timeout_s=900)
        cs.log(f"world of 4 {time.perf_counter() - t_all:.1f} s")
        for seq in args.seq:
            w4, w4_64 = (_load(torch, tmp, seq, f64) for f64 in (0, 1))
            sides = {"f32": unsharded(torch, seq),
                     "plain": unsharded(torch, seq, kernels=False),
                     "reversed": unsharded(torch, seq, reverse=True),
                     "f64": unsharded(torch, seq, f64=True)}
            g1 = sides["f32"][1]
            rows = []
            for n, g in w4["grads"].items():
                base = g1[n[:-3] + "wk"] if n.endswith(".b_k") else g1[n]
                scale = float(base.abs().max()) or 1.0
                d = lambda a, b: float((a.double() - b.double()).abs().max()
                                       ) / scale
                rows.append({
                    "leaf": n, "largest": scale,
                    "w4_vs_f32": d(g, g1[n]),
                    "plain_vs_f32": d(sides["plain"][1][n], g1[n]),
                    "reversed_vs_f32": d(sides["reversed"][1][n], g1[n]),
                    "f32_vs_f64": d(g1[n], sides["f64"][1][n]),
                    "w4_vs_f64": d(g, sides["f64"][1][n]),
                    "w4_f64_vs_f64": (d(w4_64["grads"][n],
                                        sides["f64"][1][n])
                                      if w4_64 and n in w4_64["grads"]
                                      else None)})
            rows.sort(key=lambda r: -r["w4_vs_f32"])
            losses = {k: v[0] for k, v in sides.items()}
            losses["w4"] = w4["loss"]
            if w4_64:
                losses["w4_f64"] = w4_64["loss"]
            worst = {k: max((r[k] for r in rows if r[k] is not None),
                            default=None)
                     for k in rows[0] if k not in ("leaf", "largest")}
            cs.log(f"{ARCH} f32 {_cfg().num_layers} layers, "
                   f"{_run()[1][0]} x ({_cfg().prefix_tokens} + {seq}), "
                   f"{card}: losses {losses}; largest over all leaves "
                   f"{worst}; leaves by world-of-4 difference "
                   f"{rows[:args.top]}")
            del w4, w4_64, sides, g1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cs.log(f"wall {time.perf_counter() - t_all:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
