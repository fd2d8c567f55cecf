"""Serving entry point (CLI) on the CUDA card: batched generation with a
decoder of the zoo, or the partitioned GNN inference service (counterpart
of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
        --batch 4 --prompt-len 32 --new-tokens 16 [--full] [--swa] \\
        [--device cpu]

    PYTHONPATH=src python -m repro_torch.launch.serve --gnn \\
        --dataset products-s --parts 4 --hidden 128 --ticks 20 \\
        --updates-per-tick 4 --queries-per-tick 16 [--device cpu] \\
        [--checkpoint best.npz] [--fail-partition 1 --fail-at-tick 5 \\
        --recover-after-ticks 8]

The transformer path runs the arch's ``reduced()`` config, as the
reference does, unless ``--full`` asks for its published widths; weights are
random from ``--seed``.  Every arch of the zoo serves (dense, MoE, Mamba2,
the jamba hybrid, the whisper-small encoder-decoder and the paligemma-3b
prefix-LM).  It prefills a random prompt (with random ``patch_embeds`` or
``enc_embeds`` where the arch takes them, drawn as the reference CLI draws
them) and decodes through ``ServeEngine`` with the flash attention and
RMSNorm kernels, and reports prefill time, decode time per step and both
kernels' launches.
``--swa`` serves from the mod-W rolling cache of ``sliding_window`` slots:
an arch without a native window takes the ``swa`` variant (window 8,192),
as the reference does; one with a native window (starcoder2-7b) keeps it,
where the reference's ``get_config(arch, "swa")`` refuses the variant.

The GNN path partitions the graph with EW, exports the per-partition layer
embeddings from a stacked ``SPMDEngine`` (the full-graph forward through the
CUDA segment-mean kernel), then serves a synthetic stream of feature updates
and logit queries with incremental recomputation (the kernel again).  Unlike
the reference CLI, which hardcodes the plain aggregation, both engines run
with the kernel aggregation on.  ``--checkpoint`` serves the params of an
npz written by ``train.checkpoint.save_pytree`` (either package's) instead
of random ones; ``--fail-partition`` fails that partition at
``--fail-at-tick`` and recovers it ``--recover-after-ticks`` later through
a ``FaultPlan``, and the run reports its degraded queries.
"""
from __future__ import annotations

import argparse
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def gnn_main(args) -> dict:
    """Build, export and serve ``args.ticks`` ticks; prints the reference's
    summary lines plus the kernel's launches and returns the run:
    ``graph``, ``parts``, ``pg``, ``model``, ``params`` (the served
    weights: the checkpoint's, or ``model`` itself), ``spmd`` (the
    exporting engine), ``engine`` (the serving engine),
    ``feature_updates`` (gid -> last vector written), ``lat_s``,
    ``p50_ms``, ``p99_ms``, ``qps``, ``export_launches``,
    ``tick_launches``, ``stats``, ``health`` (every partition's health
    after each tick) and ``stale_answers``."""
    from repro_torch.core import partition_graph
    from repro_torch.device import resolve_device
    from repro_torch.engine import EngineConfig, SPMDEngine
    from repro_torch.graph import (BENCHMARKS, GraphSAGE,
                                   build_partitioned_graph, make_benchmark)
    from repro_torch.kernels import kernel_launch_count
    from repro_torch.serve import GNNServingEngine

    device = resolve_device(args.device)
    g = make_benchmark(BENCHMARKS[args.dataset])
    r = partition_graph(g.indptr, g.indices, g.features, g.labels,
                        args.parts, method="ew", seed=args.seed)
    pg = build_partitioned_graph(g, r.parts, args.parts)
    model = GraphSAGE(feature_dim=g.feature_dim, hidden_dim=args.hidden,
                      num_classes=g.num_classes).init(args.seed).to(device)
    eng = SPMDEngine(model, None, None, pg, None,
                     EngineConfig(mode="stacked", use_kernel_agg=True,
                                  device=str(device)))
    k0 = kernel_launch_count()
    if args.checkpoint:
        srv = GNNServingEngine.from_checkpoint(args.checkpoint, eng, pg,
                                               use_kernel_agg=True)
    else:
        srv = GNNServingEngine.from_engine(eng, pg, model,
                                           use_kernel_agg=True)
    _sync(device)
    export_launches = kernel_launch_count() - k0
    print(f"{g.name}: {g.num_nodes} nodes, P={args.parts}, "
          f"{model.num_layers}-layer SAGE, store ready on {device} "
          f"(halo rows live in recv-slot geometry)")
    if args.fail_partition >= 0:
        from repro_torch.robustness import FaultPlan

        fail_tick = max(1, args.fail_at_tick)
        srv.set_fault_plan(FaultPlan(
            serve_fail={fail_tick: (args.fail_partition,)},
            serve_recover={fail_tick + args.recover_after_ticks:
                           (args.fail_partition,)}))
        print(f"fault plan: partition {args.fail_partition} fails at tick "
              f"{fail_tick}, recovers after {args.recover_after_ticks} ticks")

    rng = np.random.default_rng(args.seed)
    fupd: dict[int, np.ndarray] = {}
    lat, health = [], []
    stale_answers = 0
    k1 = kernel_launch_count()
    t_start = time.time()
    for _ in range(args.ticks):
        for v in rng.choice(g.num_nodes, args.updates_per_tick,
                            replace=False):
            vec = rng.normal(0, 1, g.feature_dim).astype(np.float32)
            srv.update_features(int(v), vec)
            fupd[int(v)] = vec
        srv.submit(rng.choice(g.num_nodes, args.queries_per_tick,
                              replace=False))
        t0 = time.perf_counter()
        _, tick_stats = srv.tick()
        _sync(device)
        lat.append(time.perf_counter() - t0)
        health.append(tick_stats["health"])
        stale_answers += len(tick_stats["staleness"])
    wall = time.time() - t_start
    tick_launches = kernel_launch_count() - k1
    qps = args.ticks * args.queries_per_tick / wall
    p50, p99 = np.percentile(lat, [50, 99])
    s = srv.stats
    print(f"{args.ticks} ticks x ({args.updates_per_tick} updates + "
          f"{args.queries_per_tick} queries): p50 {p50 * 1e3:.1f} ms, "
          f"p99 {p99 * 1e3:.1f} ms, {qps:.0f} queries/s")
    print(f"rows recomputed {s['rows_recomputed']}, gather calls "
          f"{s['gather_calls']}, halo rows grown {s['halo_rows_grown']}")
    if s["failovers"] or s["updates_queued"]:
        print(f"degraded mode: {s['failovers']} failover(s), "
              f"{s['degraded_queries']} degraded queries "
              f"({stale_answers} stale answers), {s['updates_queued']} "
              f"updates queued, {s['replay_attempts']} replay attempts, "
              f"{s['replayed']} replayed after {s['recoveries']} "
              f"recovery(ies); final health {srv.health}")
    print(f"segment-mean kernel launches: export {export_launches}, "
          f"ticks {tick_launches}")
    return {"graph": g, "parts": r.parts, "pg": pg, "model": model,
            "params": srv.params, "spmd": eng, "engine": srv,
            "feature_updates": fupd, "lat_s": lat,
            "p50_ms": float(p50 * 1e3), "p99_ms": float(p99 * 1e3),
            "qps": float(qps), "export_launches": export_launches,
            "tick_launches": tick_launches, "stats": dict(s),
            "health": health, "stale_answers": stale_answers}


def _timed(fn, device, times: list, launches: list):
    """``fn`` wrapped to record its synchronised host-clock time and the
    flash attention, RMSNorm (both entry points) and fused add + RMSNorm
    launches it made."""
    from repro_torch.kernels import (add_rmsnorm_launch_count,
                                     flash_launch_count, rmsnorm_launch_count)

    counts = (flash_launch_count, rmsnorm_launch_count,
              add_rmsnorm_launch_count)

    def call(*a, **kw):
        _sync(device)
        before = [n() for n in counts]
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        _sync(device)
        times.append(time.perf_counter() - t0)
        launches.append(tuple(n() - b for n, b in zip(counts, before)))
        return out

    return call


def serve_model(model, batch: dict, *, new_tokens: int, cache_size: int,
                rolling: bool = False, temperature: float = 0.0,
                seed: int = 0, label: str = "") -> dict:
    """Generate ``new_tokens`` for ``batch`` through ``ServeEngine`` after an
    untimed two-token warm-up generation, timing the engine's prefill and
    decode calls (synchronised host clock) and counting their kernel
    launches.  Prints the reference's summary line (``label`` after the
    rate) plus the timing and launch lines, and returns ``engine``,
    ``tokens``, ``wall_s``, ``tokens_per_s``, ``prefill_ms``, ``decode_ms``
    (per step), ``decode_ms_p50``, ``decode_ms_p99`` and ``launches``
    (``{"prefill": (flash, rmsnorm, fused), "decode": [(flash, rmsnorm,
    fused) per step]}``; ``rmsnorm`` counts both RMSNorm entry points,
    ``fused`` those with the residual add)."""
    from repro_torch.serve import ServeEngine

    device = model.device
    engine = ServeEngine(model, cache_size=cache_size, rolling=rolling)
    engine.generate(batch, max_new_tokens=2, temperature=temperature,
                    seed=seed)
    # the timed run drives the same model through timing wrappers of the
    # two calls the engine makes
    prefill_s, decode_s, prefill_n, decode_n = [], [], [], []
    timed = ServeEngine(SimpleNamespace(
        prefill=_timed(model.prefill, device, prefill_s, prefill_n),
        decode_step=_timed(model.decode_step, device, decode_s, decode_n)),
        cache_size=cache_size, rolling=rolling)
    t0 = time.perf_counter()
    out = timed.generate(batch, max_new_tokens=new_tokens,
                         temperature=temperature, seed=seed)
    _sync(device)
    wall = time.perf_counter() - t0
    dec_ms = [t * 1e3 for t in decode_s]
    p50, p99 = (np.percentile(dec_ms, [50, 99]).tolist() if dec_ms
                else (float("nan"), float("nan")))
    tps = out.size / wall
    b, s = np.shape(batch["tokens"])
    print(f"{model.cfg.name}: {out.shape[0]} seqs x {out.shape[1]} tokens "
          f"in {wall:.2f}s ({tps:.1f} tok/s, {label})")
    print(f"prefill {prefill_s[0] * 1e3:.2f} ms ({b} x {s} tokens), decode "
          f"p50 {p50:.3f} ms p99 {p99:.3f} ms per step over {len(dec_ms)} "
          f"steps")
    print(f"kernel launches: prefill flash {prefill_n[0][0]} rmsnorm "
          f"{prefill_n[0][1]} (fused add {prefill_n[0][2]}); decode flash "
          f"{sum(n[0] for n in decode_n)} rmsnorm "
          f"{sum(n[1] for n in decode_n)} (fused add "
          f"{sum(n[2] for n in decode_n)}) over {len(decode_n)} steps")
    print(out)
    return {"engine": engine, "tokens": out, "wall_s": wall,
            "tokens_per_s": tps, "prefill_ms": prefill_s[0] * 1e3,
            "decode_ms": dec_ms, "decode_ms_p50": p50, "decode_ms_p99": p99,
            "launches": {"prefill": prefill_n[0], "decode": decode_n}}


def llm_main(args) -> dict:
    """Prefill a random ``(batch, prompt_len)`` prompt and greedily (or with
    ``temperature``) decode ``new_tokens`` through :func:`serve_model`;
    ``--swa`` decodes from the rolling cache of ``sliding_window`` slots.
    A prefix-LM's ``patch_embeds`` and an encoder-decoder's ``enc_embeds``
    are standard normal draws from the same generator after the tokens,
    in that order (the reference CLI's); the cache holds the prefix too
    (the reference CLI's ``prompt_len + new_tokens + 4`` slots would not,
    ROADMAP §3).  Returns :func:`serve_model`'s run with ``cfg``, ``model``
    and ``batch``."""
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models import Transformer

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.swa and cfg.sliding_window is None:
        cfg = get_config(args.arch, "swa")
    if not args.full:
        cfg = cfg.reduced()
    model = Transformer(cfg, seed=args.seed, device=device)
    rng = np.random.default_rng(args.seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (args.batch, args.prompt_len))}
    if cfg.prefix_tokens:
        batch["patch_embeds"] = rng.normal(
            0, 1, (args.batch, cfg.prefix_tokens, cfg.d_model)).astype(
                np.float32)
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = rng.normal(
            0, 1, (args.batch, cfg.encoder_seq, cfg.d_model)).astype(
                np.float32)
    rolling = args.swa and cfg.sliding_window is not None
    run = serve_model(
        model, batch, new_tokens=args.new_tokens,
        cache_size=(cfg.sliding_window if rolling
                    else cfg.prefix_tokens + args.prompt_len
                    + args.new_tokens + 4),
        rolling=rolling, temperature=args.temperature, seed=args.seed,
        label=f"{'full' if args.full else 'reduced'} config on {device}")
    return {"cfg": cfg, "model": model, "batch": batch, **run}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gnn", action="store_true",
                    help="serve the partitioned GNN instead of a "
                         "transformer")
    ap.add_argument("--dataset", default="tiny")
    ap.add_argument("--parts", type=int, default=4)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--updates-per-tick", type=int, default=4)
    ap.add_argument("--queries-per-tick", type=int, default=16)
    ap.add_argument("--checkpoint", default="",
                    help="GNN params to serve: an npz written by "
                         "save_pytree (default: random from --seed)")
    ap.add_argument("--fail-partition", type=int, default=-1,
                    help="fault injection: fail this partition at "
                         "--fail-at-tick (GNN serving)")
    ap.add_argument("--fail-at-tick", type=int, default=5)
    ap.add_argument("--recover-after-ticks", type=int, default=8)
    ap.add_argument("--arch", default="qwen2-0.5b",
                    help="an arch of repro_torch.configs (every one serves)")
    ap.add_argument("--full", action="store_true",
                    help="the arch's published widths instead of reduced()")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--swa", action="store_true",
                    help="serve from the rolling sliding-window cache (the "
                         "swa variant's window where the arch has none)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.gnn:
        gnn_main(args)
    else:
        llm_main(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
