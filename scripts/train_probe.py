#!/usr/bin/env python3
"""Run the LLM training path's checks of ``chip_smoke.py`` alone on one
CUDA card: build the kernels, hold flash attention's forward with the
log-sum-exp and its backward, and the RMSNorm backward of both entry
points, against their plain versions (``chip_smoke.FLASH_TRAIN_CASES`` and
``RMS_TRAIN_SHAPES``, with the main path's timings), then train qwen2-0.5b
at its published widths (``chip_smoke.llm_train_phase``).  Prints what
those print, the card's name and power limit first, the wall time last.

    python3 scripts/train_probe.py [--kernels-only]
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
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernels' checks")
    args = ap.parse_args()
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
    cs.log(card)
    t_all = time.perf_counter()
    build.build_all()
    cs.log(f"build {time.perf_counter() - t_all:.1f} s")
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device="cuda")
    for name, case in cs.FLASH_TRAIN_CASES:
        for dtype_name in ("float32", "bfloat16"):
            cs.run_flash_train_case(fa, name, case, dtype_name, flush, 10, [],
                                    main_path=name == "qwen2-0.5b train")
    for fused in (False, True):
        for shape in cs.RMS_TRAIN_SHAPES:
            for dtype_name in ("float32", "bfloat16"):
                cs.run_rmsnorm_bwd_case(rn, shape, dtype_name, flush, 10, [],
                                        fused=fused,
                                        main_path=shape == cs.RMS_TRAIN_MAIN)
    del flush
    if not args.kernels_only:
        t0 = time.perf_counter()
        cs.log(f"llm train launches "
               f"{cs.llm_train_phase(torch, fa, rn, card.splitlines()[0])}")
        cs.log(f"llm_train_phase wall {time.perf_counter() - t0:.1f} s")
    cs.log(f"total {time.perf_counter() - t_all:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
