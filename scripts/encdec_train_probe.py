#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s training flash lines and phase 7e alone on one
CUDA card: build the kernels, then the flash training forward and backward
of every case of ``chip_smoke.FLASH_TRAIN_CASES`` (those of
``FLASH_TRAIN_MAIN`` timed beside their bounds, the plain versions and
SDPA's backward) in f32 and bf16, and the training of whisper-small and
paligemma-3b through ``build_step`` (``chip_smoke.encdec_train_phase``).
Prints what those print, the card's name and power limit first, the wall
time last.

    python3 scripts/encdec_train_probe.py
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
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn

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
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device="cuda")
    t0 = time.perf_counter()
    for name, case in cs.FLASH_TRAIN_CASES:
        for dtype_name in ("float32", "bfloat16"):
            cs.run_flash_train_case(
                fa, name, case, dtype_name, flush=flush, iters=10,
                record=[], main_path=name in cs.FLASH_TRAIN_MAIN)
    cs.log(f"flash training lines {time.perf_counter() - t0:.1f} s")
    del flush
    cs.log(f"encdec train launches "
           f"{cs.encdec_train_phase(torch, fa, rn, card)}")
    cs.log(f"wall {time.perf_counter() - t_all:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
