#!/usr/bin/env python3
"""Print SHA-256 digests of qwen2-0.5b's full-width serving outputs
(``chip_smoke.py`` phase 6: ``launch.serve``'s ``llm_main`` with
``chip_smoke.LLM_ARGS``, then the bf16 prefill logits of the same prompt)
on one CUDA card, from the ``repro_torch`` under ``--src``, so two trees of
the port (e.g. the parent commit unpacked with ``git archive`` and the
working tree) can be held bitwise against each other in one command:

    python3 scripts/llm_serving_digest.py --label <name> [--src <tree>/src]

One JSON line per tree: ``{"label", "source", "digest": {"prefill_logits",
"tokens"}}``.
"""
from __future__ import annotations

import argparse
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

    from repro_torch.kernels import build
    from repro_torch.launch import serve

    build.build_all()
    run = serve.llm_main(serve.build_parser().parse_args(cs.LLM_ARGS))
    logits, _, _ = run["model"].prefill(
        run["batch"], cache_size=run["engine"].cache_size)
    print(json.dumps({"label": args.label, "source": serve.__file__,
                      "digest": cs.serving_digest(logits, run["tokens"])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
