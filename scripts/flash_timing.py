#!/usr/bin/env python3
"""Time flash attention at the main-path shapes of ``chip_smoke.FLASH_CASES``
whose names start with ``--cases`` (qwen2-0.5b's two by default) in bf16 on
one CUDA card, three ways:

  enqueue_ms  ``chip_smoke.time_ms``: CUDA events around the enqueue of one
              call, L2 flushed before it (host work counts where the
              device outruns the host)
  device_ms   the same with the host's enqueue hidden behind a sleep kernel
              (the device's time alone)
  call_us     host clock per call over back-to-back calls (the call as its
              caller sees it), median of five rounds

for the kernel, its plain version and the PyTorch call that computes the
same function (the kernel alone with ``--kernel-only``).  The kernels come
from the ``repro_torch`` under ``--src``
(this checkout's ``src`` by default), so one command can time two trees of
the port, e.g. the parent commit unpacked with ``git archive`` and the
working tree, in the order parent, change, change, parent:

    python3 scripts/flash_timing.py --label <name> [--src <tree>/src] \
        [--cases qwen2-0.5b paligemma-3b ...] [--kernel-only]

One JSON line per (shape, function); a case the tree's kernels cannot take
(a prefix, a head size) is left out.  Inputs are made from the seeds
chip_smoke.py uses for the same shapes.
"""
from __future__ import annotations

import argparse
import inspect
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def measure(fn, flush, iters):
    cs.time_ms(fn, 2, flush)                       # build and warm up
    return {"enqueue_ms": cs.time_ms(fn, iters, flush),
            "device_ms": cs.time_ms(fn, iters, flush, hide_host=True),
            "call_us": statistics.median(cs.call_us(fn, 50)
                                         for _ in range(5))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", required=True, help="name of the tree timed")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the tree's src directory, which holds repro_torch")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--cases", nargs="+", default=["qwen2-0.5b"],
                    help="prefixes of chip_smoke.FLASH_CASES names")
    ap.add_argument("--kernel-only", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    print(f"flash_timing {args.label}: {fa.__file__}", file=sys.stderr)
    takes_prefix = "prefix_len" in inspect.signature(
        fa.flash_attention).parameters

    if not torch.cuda.is_available():
        print("flash_timing: no CUDA card", file=sys.stderr)
        return 1
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device="cuda")

    def emit(shape, fn_name, times, err=None):
        print(json.dumps({"label": args.label, "shape": shape,
                          "fn": fn_name, "max_abs_err": err, **times}),
              flush=True)

    for name, case in cs.FLASH_CASES:
        b, hq, hkv, sq, sk, dh, causal, window, q_off, *prefix = case
        if not name.startswith(tuple(args.cases)) or dh not in fa.HEAD_DIMS \
                or (prefix and not takes_prefix):
            continue
        gen = torch.Generator(device="cuda").manual_seed(sq + sk + dh)
        q, k, v = (torch.randn(s, device="cuda", generator=gen)
                   .to(torch.bfloat16)
                   for s in ((b, hq, sq, dh), (b, hkv, sk, dh),
                             (b, hkv, sk, dh)))
        kw = dict(causal=causal, window=window, q_offset=q_off)
        if prefix:
            kw["prefix_len"] = prefix[0]
        live = torch.as_tensor(
            cs.flash_live_pairs(sq, sk, causal, window, q_off, *prefix),
            device="cuda")
        err = float((fa.flash_attention(q, k, v, **kw).float()
                     - fa.flash_attention_plain(q, k, v, **kw).float())
                    .abs().max())
        emit(name, "kernel",
             measure(lambda: fa.flash_attention(q, k, v, **kw), flush,
                     args.iters), err)
        if args.kernel_only:
            continue
        emit(name, "plain",
             measure(lambda: fa.flash_attention_plain(q, k, v, **kw), flush,
                     args.iters))
        # as chip_smoke.py's yardstick: the causal flag where it says all
        if causal and window is None and q_off == 0 and sq == sk \
                and not prefix:
            sdpa = lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)
        else:
            sdpa = lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=live, enable_gqa=True)
        emit(name, "sdpa", measure(sdpa, flush, args.iters))
    return 0


if __name__ == "__main__":
    sys.exit(main())
