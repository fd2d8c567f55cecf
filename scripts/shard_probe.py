#!/usr/bin/env python3
"""Run the sharded steps' checks of ``chip_smoke.py`` alone on one CUDA
card (phase 7b, ``chip_smoke.shard_checks``): build the kernels, then
phase 3's flash lines at a rank's shapes (paligemma-3b's Dh 256 prefill,
decode and training forward and backward at the GQA groups of a (2, 2)
and a (1, 4) mesh, f32 and bf16, against the plain versions, timed beside
their bounds and SDPA's), then ``chip_smoke.SHARD_RUNS``' train, prefill,
greedy decode and personalize steps (qwen2-0.5b, whisper-small,
paligemma-3b, phi3.5-moe, mamba2-370m, jamba) on an NCCL world of 1
(bitwise the unsharded steps) and on a world of 4 sharing the card over
the ``staged`` backend (launches, staged bytes against the closed form,
the f32 variants against the world of 1, step ms, peak memory, MoE drops).
Prints what the phases print, the card's name and power limit first, the
wall time last.  ``--arch`` runs the entries of the archs named alone, and
the flash lines of their rank shapes.

    python3 scripts/shard_probe.py [--arch phi3.5-moe-42b-a6.6b ...]
"""
import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=None)
    archs = ap.parse_args().arch
    prefixes = ("paligemma-3b",) if archs is None else tuple(
        a.split("-")[0] for a in archs)

    from repro_torch.kernels import build

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
    cs.log(f"build {time.perf_counter() - t_all:.1f} s")
    from repro_torch.kernels import flash_attention as fa

    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device="cuda")
    for name, case in cs.FLASH_CASES:
        if name.startswith(prefixes) and " rank" in name:
            for dtype_name in ("float32", "bfloat16"):
                cs.run_flash_case(fa, name, case, dtype_name, flush=flush,
                                  iters=10, record=[], main_path=True)
    for name, case in cs.FLASH_TRAIN_CASES:
        if name.startswith(prefixes) and " rank" in name:
            for dtype_name in ("float32", "bfloat16"):
                cs.run_flash_train_case(
                    fa, name, case, dtype_name, flush=flush, iters=10,
                    record=[], main_path=name in cs.FLASH_TRAIN_MAIN)
    del flush
    cs.log(f"flash lines at a rank's shapes "
           f"{time.perf_counter() - t_all:.1f} s")
    cs.log(f"shard launches {cs.shard_checks(torch, card, archs)}")
    cs.log(f"wall {time.perf_counter() - t_all:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
