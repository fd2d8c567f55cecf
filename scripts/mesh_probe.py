#!/usr/bin/env python3
"""Run the partition mesh's checks of ``chip_smoke.py`` alone on one CUDA
card: build the kernels, hold every partition's row-range launch of both
overlapped-forward halves against its rows of the stacked launch at
products-s (``chip_smoke.part_split_cases``, with its timings), then
``chip_smoke.mesh_checks`` (ROADMAP item 14 parts 1-3: the NCCL world of
1, the gloo world of 4 ranks sharing the card, an NCCL world of 4 where
there are 4 cards).  Prints what those print, the card's name and power
limit first, and the checks' wall time last.

    python3 scripts/mesh_probe.py

The spawned ranks re-import this file, so its top level only sets
``sys.path``.
"""
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
import chip_smoke as cs  # noqa: E402


def main() -> int:
    import numpy as np
    import torch

    from repro_torch.core import partition_graph
    from repro_torch.engine.stacking import build_stacked_split_vjp_blocks
    from repro_torch.graph import (BENCHMARKS, build_partitioned_graph,
                                   make_benchmark)
    from repro_torch.kernels import build
    from repro_torch.kernels import segment_agg as sa

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    cs.log(card)
    t0 = time.perf_counter()
    build.build_all()
    cs.log(f"build {time.perf_counter() - t0:.1f} s")
    g = make_benchmark(BENCHMARKS["products-s"])
    r = partition_graph(g.indptr, g.indices, g.features, g.labels, 4,
                        method="ew", seed=0)
    pg = build_partitioned_graph(g, r.parts, 4)
    bi, bb = build_stacked_split_vjp_blocks(pg)
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device="cuda")
    cs.part_split_cases(torch, sa, pg, bi, bb, np.random.default_rng(0),
                        flush, [])
    del flush
    t0 = time.perf_counter()
    cs.log(f"mesh launches {cs.mesh_checks(torch, card.splitlines()[0])}")
    cs.log(f"mesh_checks wall {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
