"""Serving driver (CLI) for the partitioned GNN inference service, on the
CUDA card (counterpart of ``repro/launch/serve.py --gnn``).

    PYTHONPATH=src python -m repro_torch.launch.serve --gnn \\
        --dataset products-s --parts 4 --hidden 128 --ticks 20 \\
        --updates-per-tick 4 --queries-per-tick 16 [--device cpu]

Partitions the graph with EW, exports the per-partition layer embeddings
from a stacked ``SPMDEngine`` (the full-graph forward through the CUDA
segment-mean kernel), then serves a synthetic stream of feature updates and
logit queries with incremental recomputation (the kernel again).  Unlike
the reference CLI, which hardcodes the plain aggregation, both engines run
with the kernel aggregation on.  ``--checkpoint`` and ``--fail-partition``
wait for ROADMAP item 12 and the transformer path for item 15; each says so
when asked for.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def gnn_main(args) -> dict:
    """Build, export and serve ``args.ticks`` ticks; prints the reference's
    summary lines plus the kernel's launches and returns the run:
    ``graph``, ``parts``, ``pg``, ``model``, ``spmd`` (the exporting
    engine), ``engine`` (the serving engine), ``feature_updates`` (gid ->
    last vector written), ``lat_s``, ``p50_ms``, ``p99_ms``, ``qps``,
    ``export_launches``, ``tick_launches`` and ``stats``."""
    from repro_torch.core import partition_graph
    from repro_torch.device import resolve_device
    from repro_torch.engine import EngineConfig, SPMDEngine
    from repro_torch.graph import (BENCHMARKS, GraphSAGE,
                                   build_partitioned_graph, make_benchmark)
    from repro_torch.kernels import kernel_launch_count
    from repro_torch.serve import GNNServingEngine

    if args.checkpoint:
        raise NotImplementedError(
            "--checkpoint (msgpack checkpoints) is not ported yet "
            "(ROADMAP item 12)")
    if args.fail_partition >= 0:
        raise NotImplementedError(
            "--fail-partition (seeded fault plans) is not ported yet "
            "(ROADMAP item 12)")
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
    srv = GNNServingEngine.from_engine(eng, pg, model, use_kernel_agg=True)
    _sync(device)
    export_launches = kernel_launch_count() - k0
    print(f"{g.name}: {g.num_nodes} nodes, P={args.parts}, "
          f"{model.num_layers}-layer SAGE, store ready on {device} "
          f"(halo rows live in recv-slot geometry)")

    rng = np.random.default_rng(args.seed)
    fupd: dict[int, np.ndarray] = {}
    lat = []
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
        srv.tick()
        _sync(device)
        lat.append(time.perf_counter() - t0)
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
    print(f"segment-mean kernel launches: export {export_launches}, "
          f"ticks {tick_launches}")
    return {"graph": g, "parts": r.parts, "pg": pg, "model": model,
            "spmd": eng, "engine": srv, "feature_updates": fupd, "lat_s": lat,
            "p50_ms": float(p50 * 1e3), "p99_ms": float(p99 * 1e3),
            "qps": float(qps), "export_launches": export_launches,
            "tick_launches": tick_launches, "stats": dict(s)}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gnn", action="store_true",
                    help="serve the partitioned GNN (the only path ported)")
    ap.add_argument("--dataset", default="tiny")
    ap.add_argument("--parts", type=int, default=4)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--updates-per-tick", type=int, default=4)
    ap.add_argument("--queries-per-tick", type=int, default=16)
    ap.add_argument("--checkpoint", default="",
                    help="not ported yet (ROADMAP item 12)")
    ap.add_argument("--fail-partition", type=int, default=-1,
                    help="not ported yet (ROADMAP item 12)")
    ap.add_argument("--fail-at-tick", type=int, default=5)
    ap.add_argument("--recover-after-ticks", type=int, default=8)
    ap.add_argument("--arch", default="qwen2-0.5b",
                    help="transformer path: not ported yet (ROADMAP item 15)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--swa", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.gnn:
        print("the transformer serving path is not ported yet (ROADMAP "
              "item 15); pass --gnn", file=sys.stderr)
        return 2
    gnn_main(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
