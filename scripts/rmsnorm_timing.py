#!/usr/bin/env python3
"""Time RMSNorm and the fused residual add + RMSNorm at qwen2-0.5b's prefill
(4, 2048, 896) and decode (4, 1, 896) rows, in bf16 on one CUDA card, three
ways:

  enqueue_ms  ``chip_smoke.time_ms``: CUDA events around the enqueue of one
              call, L2 flushed before it (host work counts where the
              device outruns the host)
  device_ms   the same with the host's enqueue hidden behind a sleep kernel
              (the device's time alone)
  call_us     host clock per call over back-to-back calls (the call as its
              caller sees it), median of five rounds

for the kernels (``rmsnorm`` and, in trees that have it, ``add_rmsnorm``),
torch's ``x + delta``, ``F.rms_norm`` and the two together (what the fused
kernel replaces), with each line's byte bound and the share of it the device
time reaches.  ``--model`` adds qwen2-0.5b at its published widths (random
weights from seed 0, batch 4, prompt 2,048): prefill and decode-step times on
the host clock (synchronised, medians), and under torch.profiler the kernel
launches, torch's elementwise adds and the device-busy time of one prefill
and per decode step.

The kernels and the model come from the ``repro_torch`` under ``--src``
(this checkout's ``src`` by default), so one command can time two trees of
the port, e.g. the parent commit unpacked with ``git archive`` and the
working tree, in the order parent, change, change, parent:

    python3 scripts/rmsnorm_timing.py --label <name> [--src <tree>/src] [--model]

One JSON line per (shape, function).  Inputs are made from the seeds
chip_smoke.py uses for the same shapes.
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

SHAPES = {"prefill": (4, 2048, 896), "decode": (4, 1, 896)}


def measure(fn, flush, iters):
    cs.time_ms(fn, 2, flush)                       # build and warm up
    return {"enqueue_ms": cs.time_ms(fn, iters, flush),
            "device_ms": cs.time_ms(fn, iters, flush, hide_host=True),
            "call_us": statistics.median(cs.call_us(fn, 50)
                                         for _ in range(5))}


def model_times(torch, label, steps=32):
    """qwen2-0.5b at full width: prefill and decode-step medians, then one
    prefill and 8 decode steps under the profiler."""
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer

    cfg = get_config("qwen2-0.5b")
    model = Transformer(cfg, seed=0, device="cuda")
    batch = {"tokens": np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 2048))}
    width = 2048 + steps + 4

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    model.prefill(batch, cache_size=width)          # warm up
    prefill_ms = [timed(lambda: model.prefill(batch, cache_size=width))[1]
                  for _ in range(5)]
    (lg, caches, n), _ = timed(lambda: model.prefill(batch, cache_size=width))
    decode_ms = []
    for t in range(steps):
        tok = lg.argmax(-1)[:, None]
        (lg, caches), ms = timed(lambda: model.decode_step(tok, caches, n + t))
        decode_ms.append(ms)

    def profiled(fn, steps):
        """Kernel launches, torch's elementwise adds and device-busy ms per
        step of ``fn``, and per step the launches and µs of each norm and
        add kernel."""
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        cuda = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        adds = [e for e in cuda if "CUDAFunctor_add" in e.key]
        return {"launches": sum(e.count for e in cuda) / steps,
                "adds": sum(e.count for e in adds) / steps,
                "busy_ms": sum(e.self_device_time_total for e in cuda)
                / steps / 1e3,
                "norms_and_adds": {
                    e.key[:100]: [e.count / steps,
                                  e.self_device_time_total / steps]
                    for e in cuda
                    if "rms" in e.key or "CUDAFunctor_add" in e.key}}

    state = {}

    def prefill():
        state["out"] = model.prefill(batch, cache_size=width)

    def decode8():
        lg, caches, n = state["out"]
        for t in range(8):
            lg, caches = model.decode_step(lg.argmax(-1)[:, None], caches,
                                           n + t)

    prof_prefill = profiled(prefill, 1)
    prof_decode = profiled(decode8, 8)
    print(json.dumps({
        "label": label, "model": cfg.name,
        "prefill_ms": prefill_ms, "prefill_ms_median":
        statistics.median(prefill_ms),
        "decode_ms_median": statistics.median(decode_ms),
        "decode_ms_p10_p90": np.percentile(decode_ms, [10, 90]).tolist(),
        "prefill_profiled": prof_prefill, "decode_profiled_per_step":
        prof_decode}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", required=True, help="name of the tree timed")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the tree's src directory, which holds repro_torch")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--model", action="store_true",
                    help="also time qwen2-0.5b's prefill and decode steps")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as rn
    print(f"rmsnorm_timing {args.label}: {rn.__file__}", file=sys.stderr)

    if not torch.cuda.is_available():
        print("rmsnorm_timing: no CUDA card", file=sys.stderr)
        return 1
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device="cuda")
    fused = hasattr(rn, "add_rmsnorm")

    for where, shape in SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(shape[-1])
        x = torch.randn(shape, device="cuda", generator=gen).bfloat16()
        w = torch.randn(shape[-1], device="cuda", generator=gen)
        delta = torch.randn(shape, device="cuda", generator=gen).bfloat16()
        w_lib = w.bfloat16()
        d = (shape[-1],)
        norm_bytes = 2 * x.numel() * 2 + w.numel() * 4
        fns = {"rmsnorm": (lambda: rn.rmsnorm(x, w), norm_bytes),
               "torch_add": (lambda: x + delta, 3 * x.numel() * 2),
               "rms_norm": (lambda: F.rms_norm(x, d, w_lib, 1e-6), norm_bytes),
               "add_then_rms_norm": (lambda: F.rms_norm(x + delta, d, w_lib,
                                                        1e-6),
                                     2 * norm_bytes)}
        if fused:
            fns["add_rmsnorm"] = (lambda: rn.add_rmsnorm(x, delta, w),
                                  2 * norm_bytes)
        for name, (fn, nbytes) in fns.items():
            t = measure(fn, flush, args.iters)
            bound_ms = nbytes / cs.HBM_BYTES_S * 1e3
            print(json.dumps({"label": args.label, "shape": list(shape),
                              "where": where, "fn": name, **t,
                              "bound_ms": bound_ms,
                              "device_share": bound_ms / t["device_ms"]}),
                  flush=True)
    if args.model:
        del flush
        model_times(torch, args.label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
