#!/usr/bin/env python3
"""Run the zoo's checks of ``chip_smoke.py`` alone on one CUDA card: build
the kernels, hold flash attention at starcoder2-7b's, whisper-small's and
paligemma-3b's serving shapes and the window + prefix case against its
plain version (``chip_smoke``'s phase-3 lines, f32 and bf16), then the zoo
phase (``chip_smoke.zoo_phase``: starcoder2-7b ``--swa``, mamba2-370m,
phi3.5-moe at depth 8, jamba at one super-block, whisper-small and
paligemma-3b, served at full width, and each one's f32 variant kernels
against plain), and unless ``--no-mesh`` the sequential oracle's 4-epoch
drift from the stacked engine (``chip_smoke.mesh_oracle_drift``).  Prints
what those print, the card's name and power limit first.

    python3 scripts/zoo_probe.py [--no-mesh] [--no-zoo]
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
    ap.add_argument("--no-mesh", action="store_true")
    ap.add_argument("--no-zoo", action="store_true")
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
    t0 = time.perf_counter()
    build.build_all()
    cs.log(f"build {time.perf_counter() - t0:.1f} s")
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device="cuda")
    for name, case in cs.FLASH_CASES:
        if name.startswith(cs.MAIN_FLASH_CASES[1:]):
            for dtype_name in ("float32", "bfloat16"):
                cs.run_flash_case(fa, name, case, dtype_name, flush=flush,
                                  iters=10, record=[], main_path=True)
    del flush
    if not args.no_zoo:
        cs.log(f"zoo launches {cs.zoo_phase(torch, fa, rn, card)}")
    if not args.no_mesh:
        from repro_torch.pipeline import run_eat_distgnn

        stacked = {}
        for k in cs.MESH_ORACLE_RUNS:
            res = run_eat_distgnn(cs.mesh_part3_config(4, "stacked", k))
            stacked[k] = [w.detach().cpu()
                          for w in res.final_params.parameters()]
        cs.log(f"{card}: oracle drift {cs.mesh_oracle_drift(torch, stacked)}")
    cs.log(f"total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
