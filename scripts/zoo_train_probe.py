#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phases 7c and 7d alone on one CUDA card: build
the kernels, then the dry run and the roofline on the card's terms
(``chip_smoke.dryrun_phase``: the fake world probed, qwen2-0.5b's four
shapes on the fake (16, 16) world, one bf16 train step counted on the card
against its count on meta and timed) and the training of the zoo's MoE and
Mamba2 families (``chip_smoke.zoo_train_phase``).  Prints what those
print, the card's name and power limit first, the wall time last.

    python3 scripts/zoo_train_probe.py [--no-dryrun] [--no-zoo]
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
    ap.add_argument("--no-dryrun", action="store_true",
                    help="skip phase 7c")
    ap.add_argument("--no-zoo", action="store_true", help="skip phase 7d")
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
    card = card.splitlines()[0]
    cs.log(card)
    t_all = time.perf_counter()
    build.build_all()
    cs.log(f"build {time.perf_counter() - t_all:.1f} s")
    if not args.no_dryrun:
        cs.log(f"roofline step launches {cs.dryrun_phase(torch, fa, rn, card)}")
    if not args.no_zoo:
        cs.log(f"zoo train launches {cs.zoo_train_phase(torch, fa, rn, card)}")
    cs.log(f"wall {time.perf_counter() - t_all:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
