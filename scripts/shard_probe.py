#!/usr/bin/env python3
"""Run the sharded steps' checks of ``chip_smoke.py`` alone on one CUDA
card (phase 7b, ``chip_smoke.shard_checks``): build the kernels, then
qwen2-0.5b's train, prefill, greedy decode and personalize steps on an
NCCL world of 1 (bitwise the unsharded steps) and on a world of 4 sharing
the card over the ``staged`` backend (launches, staged bytes against the
closed form, the f32 4-layer variant against the world of 1, step ms,
peak memory).  Prints what the phase prints, the card's name and power
limit first.

    python3 scripts/shard_probe.py
"""
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    card = card.splitlines()[0]
    cs.log(card)
    t0 = time.perf_counter()
    build.build_all()
    cs.log(f"build {time.perf_counter() - t0:.1f} s")
    cs.log(f"shard launches {cs.shard_checks(torch, card)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
