#!/usr/bin/env python3
"""Time the segment-mean kernels at products-s (P=4, EW, seed 0, the stacked
blocks of the full-graph step and the export) in f32 on one CUDA card,
forward and backward at D=64 and D=128, three ways:

  enqueue_ms  ``chip_smoke.time_ms``: CUDA events around the enqueue of one
              call, L2 flushed before it (host work counts where the
              device outruns the host)
  device_ms   the same with the host's enqueue hidden behind a sleep kernel
              (the device's time alone)
  call_us     host clock per call over back-to-back calls (the call as its
              caller sees it), median of five rounds

for the kernel, ``torch.sparse.mm`` with the CSR mean matrix (its transpose
for the backward; a yardstick the port never calls) and ``torch.zeros`` of
the output (what zero-filling the output would cost).  It also times, on the
host clock (``host_us``, median of five rounds), the host side of the
blocks: the products-s stacked blocks, both directions
(``build_stacked_vjp_blocks``, once per engine), their rows' slot ranges
(``block_row_ptr``) and the work plan cut from them (``block_row_work``),
and the forward blocks of a serving recompute
(``build_mean_blocks`` and ``blocks_to_device``, which
``serve/gnn.py::_recompute_rows`` runs per layer and partition on every
tick) for 16 and 256 rows of products-s in-edges.  The kernels and the
block builders come from the ``repro_torch`` under ``--src`` (this
checkout's ``src`` by default), so one command can time two trees of the
port, e.g. the parent commit unpacked with ``git archive`` and the working
tree, in the order parent, change, change, parent:

    python3 scripts/segment_timing.py --label <name> [--src <tree>/src] [--k K]

``--k`` rebuilds the work plan with items of at most K slots (trees with
``block_row_work``).  One JSON line per (shape, function); inputs are made
from the seed chip_smoke.py uses for the same shapes.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def measure(fn, flush, iters):
    cs.time_ms(fn, 2, flush)                       # build and warm up
    return {"enqueue_ms": cs.time_ms(fn, iters, flush),
            "device_ms": cs.time_ms(fn, iters, flush, hide_host=True),
            "call_us": statistics.median(cs.call_us(fn, 50)
                                         for _ in range(5))}


def host_us(fn, n):
    """Host clock per call (µs), median of five rounds of ``n`` calls."""
    fn()
    rounds = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        rounds.append((time.perf_counter() - t0) / n * 1e6)
    return statistics.median(rounds)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", required=True, help="name of the tree timed")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the tree's src directory, which holds repro_torch")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--k", type=int, default=None,
                    help="most slots per work item (default: the tree's)")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch
    from repro_torch.core import partition_graph
    from repro_torch.engine.stacking import build_stacked_vjp_blocks
    from repro_torch.graph import (BENCHMARKS, build_partitioned_graph,
                                   make_benchmark)
    from repro_torch.kernels import segment_agg as sa
    print(f"segment_timing {args.label}: {sa.__file__}", file=sys.stderr)

    if not torch.cuda.is_available():
        print("segment_timing: no CUDA card", file=sys.stderr)
        return 1
    g = make_benchmark(BENCHMARKS["products-s"])
    r = partition_graph(g.indptr, g.indices, g.features, g.labels, 4,
                        method="ew", seed=0)
    pg = build_partitioned_graph(g, r.parts, 4)
    blk = build_stacked_vjp_blocks(pg)
    if args.k is not None:
        for pre in ("", "t_"):
            blk.update(sa.block_row_work(
                sa.block_row_ptr(blk[pre + "dst"], blk[pre + "mask"]),
                k=args.k, prefix=pre))
    dev = torch.device("cuda")
    bl = sa.blocks_to_device(blk, dev)
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=dev)
    n = pg.max_nodes

    def emit(shape, fn_name, times, err=None):
        print(json.dumps({"label": args.label, "k": args.k, "shape": shape,
                          "fn": fn_name, "max_abs_err": err, **times}),
              flush=True)

    rng = np.random.default_rng(0)                 # chip_smoke.py's draws
    for d in (64, 128):
        x = torch.as_tensor(rng.normal(0, 1, (4, n, d)).astype(np.float32),
                            device=dev)
        x2 = x.reshape(-1, d)
        fwd = lambda: sa.segment_mean_op(x, bl, num_rows=n)
        bwd = lambda: sa.segment_mean_bwd_op(x, bl, n_in=n)
        for name, op, plain, transpose in (
                ("fwd", fwd, lambda: sa.segment_mean_plain(x, bl, num_rows=n),
                 False),
                ("bwd", bwd, lambda: sa.segment_mean_bwd_plain(x, bl, n_in=n),
                 True)):
            shape = f"products-s {name} D={d}"
            got, want = op(), plain()
            first = op()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            emit(shape, "kernel", {**measure(op, flush, args.iters),
                                   "repeat_bitwise": bool(torch.equal(got,
                                                                      first))},
                 err)
            a = cs.library_matrix(blk, n, 0, n, True, torch.float32, dev,
                                  transpose=transpose)
            emit(shape, "sparse.mm",
                 measure(lambda: torch.sparse.mm(a, x2), flush, args.iters))
            emit(shape, "zeros", measure(
                lambda: torch.zeros((4, n, d), device=dev), flush, args.iters))

    # the host side: the stacked blocks and their plan, then a serving
    # recompute's blocks
    shape = "products-s stacked blocks, both directions"
    emit(shape, "build_stacked_vjp_blocks",
         {"host_us": host_us(lambda: build_stacked_vjp_blocks(pg), 1)})
    ptrs = {pre: sa.block_row_ptr(blk[pre + "dst"], blk[pre + "mask"])
            for pre in ("", "t_")}
    emit(shape, "block_row_ptr", {"host_us": host_us(
        lambda: [sa.block_row_ptr(blk[pre + "dst"], blk[pre + "mask"])
                 for pre in ptrs], 2)})
    if hasattr(sa, "block_row_work"):
        emit(shape, "block_row_work", {"host_us": host_us(
            lambda: [sa.block_row_work(ptrs[pre], prefix=pre)
                     for pre in ptrs], 20)})
    for m in (16, 256):
        rows = rng.choice(g.num_nodes, m, replace=False)
        counts = np.diff(g.indptr)[rows]
        src = np.concatenate([g.indices[g.indptr[v]:g.indptr[v + 1]]
                              for v in rows]).astype(np.int64)
        dst = np.repeat(np.arange(m), counts)
        shape = f"serving recompute {m} rows ({src.size} in-edges)"
        host = sa.build_mean_blocks(src, dst, num_rows=m)
        emit(shape, "build_mean_blocks", {"host_us": host_us(
            lambda: sa.build_mean_blocks(src, dst, num_rows=m), 200)})
        if hasattr(sa, "block_row_work"):
            ptr = sa.block_row_ptr(host["dst"], host["mask"])
            emit(shape, "block_row_work", {"host_us": host_us(
                lambda: sa.block_row_work(ptr), 200)})

        def to_device():
            sa.blocks_to_device(host, dev)
            torch.cuda.synchronize()
        emit(shape, "blocks_to_device", {"host_us": host_us(to_device, 200)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
