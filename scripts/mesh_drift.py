#!/usr/bin/env python3
"""The partition mesh's final params after 4 epochs (two of phase 0, two of
phase 1) against the stacked engine's, in the port and in the reference,
side by side, on the CPU: the reference's ``mode="spmd"`` over 4 forced
host devices in a subprocess, the port's gloo world of 4 ranks; P = 4,
EW, hidden 128, seed 0, for the plain gradient mean and the bucketed and
top-k reducers (``tests/_torch_mesh_drift_ranks.py``, which
``tests/test_torch_mesh_drift.py`` holds at tiny).  Prints each run's max
params drift and loss difference, the reference's beside the port's.

    python3 scripts/mesh_drift.py [--dataset tiny|products-s]
"""
import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "tests"), os.path.join(ROOT, "src")]
import numpy as np  # noqa: E402

import _torch_mesh_drift_ranks as md  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="products-s")
    args = ap.parse_args()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        dst = os.path.join(d, "reference.npz")
        ref = md.start_reference(dst, args.dataset)
        try:
            mesh, stacked = md.port_runs(args.dataset, d)
            out, err = ref.communicate()
        finally:
            if ref.poll() is None:
                ref.kill()
                ref.communicate()
        if ref.returncode != 0 or "REF_DONE" not in out:
            print(err[-3000:], file=sys.stderr)
            return 1
        want = dict(np.load(dst))
    for name in md.RUNS:
        got, base = mesh[name], stacked[name]
        print(json.dumps({
            "dataset": args.dataset, "run": name,
            "reference_params_drift": float(want[name + "_drift"]),
            "reference_loss_diff": float(want[name + "_loss"]),
            "port_params_drift": md.drift(got["params"], base["params"]),
            "port_loss_diff": float((got["loss"] - base["loss"]).abs().max()),
        }))
    print(f"wall {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
