#!/usr/bin/env python3
"""Print a SHA-256 digest of flash attention's training outputs (the
forward's output and log-sum-exp, the backward's dq, dk, dv) for every
case of ``chip_smoke.FLASH_TRAIN_CASES`` that the tree's backward takes, in
f32 and bf16 on one CUDA card, from the ``repro_torch`` under ``--src``, so
two trees of the port (e.g. the parent commit unpacked with ``git archive``
and the working tree) can be held bitwise against each other in one
command:

    python3 scripts/flash_bwd_digest.py --label <name> [--src <tree>/src] \
        [--time qwen2-0.5b whisper-small ...]

One JSON line per tree: ``{"label", "digests": {"case dtype": sha}}``;
with ``--time``, also ``"device_ms"``: the bf16 backward's device time
alone (``chip_smoke.time_ms`` with the host hidden, L2 flushed) at the
cases whose names start with the given prefixes, so that trees timed in
turns in one command (parent, change, change, parent) compare on one
card.  Inputs are made from the seeds chip_smoke.py uses for the same
cases.
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
    ap.add_argument("--time", nargs="*", default=[],
                    help="prefixes of the case names whose bf16 backward "
                         "is timed")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    # chip_smoke imported this checkout's repro_torch for its case lists:
    # drop it, so that the package below is the one under --src
    for mod in [m for m in sys.modules
                if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[mod]

    import torch
    from repro_torch.kernels import flash_attention as fa
    assert Path(fa.__file__).resolve().is_relative_to(src), fa.__file__

    # a tree whose backward takes fewer head sizes or no prefix leaves the
    # cases it cannot take out of its digests
    head_dims = getattr(fa, "BWD_HEAD_DIMS", fa.HEAD_DIMS)
    takes_prefix = "prefix_len" in inspect.signature(
        fa.flash_attention_bwd).parameters
    digests, device_ms = {}, {}
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device="cuda")
    for name, (b, hq, hkv, sq, sk, dh, causal, window, q_off, *prefix) in \
            cs.FLASH_TRAIN_CASES:
        if dh not in head_dims or (prefix and prefix[0] and
                                   not takes_prefix):
            continue
        kw = dict(causal=causal, window=window, q_offset=q_off)
        if prefix and prefix[0]:
            kw["prefix_len"] = prefix[0]
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            gen = torch.Generator(device="cuda").manual_seed(sq + sk + dh)
            q, k, v, do = (torch.randn(shape, device="cuda",
                                       generator=gen).to(dtype)
                           for shape in ((b, hq, sq, dh), (b, hkv, sk, dh),
                                         (b, hkv, sk, dh), (b, hq, sq, dh)))
            o, lse = fa.flash_attention_lse(q, k, v, **kw)
            grads = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            h = hashlib.sha256()
            for t in (o, lse, *grads):
                h.update(t.contiguous().view(torch.uint8).cpu().numpy()
                         .tobytes())
            digests[f"{name} {dtype_name}"] = h.hexdigest()
            if dtype_name == "bfloat16" and name.startswith(
                    tuple(args.time)) and args.time:
                fn = lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                    **kw)
                cs.time_ms(fn, 2, flush)                 # warm up
                device_ms[name] = cs.time_ms(fn, 30, flush,
                                             hide_host=True)
    out = {"label": args.label, "source": fa.__file__, "digests": digests}
    if args.time:
        out["device_ms"] = device_ms
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
