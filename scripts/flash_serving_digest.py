#!/usr/bin/env python3
"""Print a SHA-256 digest of flash attention's serving outputs (both
designs) for every case of ``chip_smoke.FLASH_CASES`` in f32 and bf16 on
one CUDA card, from the ``repro_torch`` under ``--src``, so two trees of
the port (e.g. the parent commit unpacked with ``git archive`` and the
working tree) can be held bitwise against each other in one command:

    python3 scripts/flash_serving_digest.py --label <name> [--src <tree>/src]

One JSON line per tree: ``{"label", "digests": {"case dtype": sha}}``.
Inputs are made from the seeds chip_smoke.py uses for the same cases.
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", required=True, help="name of the tree")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the tree's src directory, which holds repro_torch")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch
    from repro_torch.kernels import flash_attention as fa

    digests = {}
    takes_prefix = "prefix_len" in inspect.signature(
        fa.flash_attention).parameters
    for name, (b, hq, hkv, sq, sk, dh, causal, window, q_off, *prefix) in \
            cs.FLASH_CASES:
        # a case the tree's kernels cannot take (a prefix, a head size) is
        # left out of its digests
        if dh not in fa.HEAD_DIMS or (prefix and not takes_prefix):
            continue
        kw = {"prefix_len": prefix[0]} if prefix else {}
        for dtype_name in ("float32", "bfloat16"):
            gen = torch.Generator(device="cuda").manual_seed(sq + sk + dh)
            q, k, v = (torch.randn(shape, device="cuda", generator=gen).to(
                getattr(torch, dtype_name)) for shape in (
                (b, hq, sq, dh), (b, hkv, sk, dh), (b, hkv, sk, dh)))
            out = fa.flash_attention(q, k, v, causal=causal, window=window,
                                     q_offset=q_off, **kw)
            raw = out.contiguous().view(torch.uint8).cpu().numpy().tobytes()
            digests[f"{name} {dtype_name}"] = hashlib.sha256(raw).hexdigest()
    print(json.dumps({"label": args.label, "source": fa.__file__,
                      "digests": digests}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
