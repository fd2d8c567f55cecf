"""The 4-epoch mesh drift check's runs (``tests/test_torch_mesh_drift.py``,
``scripts/mesh_drift.py``): the pipeline at 4 epochs (two of phase 0, two
of phase 1) on the partition mesh and stacked, in the port and in the
reference.  Imports nothing of JAX, so a rank starts in a few seconds; the
reference runs from a script in a subprocess."""
import os
import subprocess
import sys

import torch

from _jax_cache import CACHE_PRELUDE
from repro_torch.launch.mesh import spawn_partition_world
from repro_torch.pipeline import EATConfig, run_eat_distgnn

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the runs: the plain gradient mean (a pmean), and the two reducers
# (the 4-epoch runs that drifted on the card, PERF.md §6)
RUNS = {"sampled": {},
        "fp16-bucketed": {"halo_compress": "fp16",
                          "grad_compress": "bucketed"},
        "int8-topk": {"halo_compress": "int8", "grad_compress": "topk"}}
# P = 4, EW, hidden 128, 4 epochs at phase0_fraction 0.5, seed 0
SCHEDULE = dict(num_parts=4, hidden_dim=128, max_epochs=4,
                phase0_fraction=0.5, seed=0)

REF_SCRIPT = (
    "import os, sys\n"
    "os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'\n"
    + CACHE_PRELUDE
    + f"RUNS, SCHEDULE = {RUNS!r}, {SCHEDULE!r}\n"
    + r"""
import numpy as np
from repro.pipeline import EATConfig, run_eat_distgnn
dst, dataset = sys.argv[1], sys.argv[2]
out = {}
for name, kw in RUNS.items():
    leaves, losses = {}, {}
    for mode in ("stacked", "spmd"):
        # the jnp aggregation on the eval path in both modes (the Pallas
        # kernel in interpret mode costs minutes at products-s)
        r = run_eat_distgnn(EATConfig(dataset=dataset, engine_mode=mode,
                                      use_pallas_agg=False, **SCHEDULE,
                                      **kw))
        assert r.engine_mode == mode, r.engine_mode
        leaves[mode] = [np.asarray(x)
                        for x in jax.tree_util.tree_leaves(r.final_params)]
        losses[mode] = np.asarray(r.loss_history)
    out[name + "_drift"] = max(float(np.abs(a - b).max()) for a, b in
                               zip(leaves["spmd"], leaves["stacked"]))
    out[name + "_loss"] = float(np.abs(losses["spmd"]
                                       - losses["stacked"]).max())
np.savez(dst, **out)
print("REF_DONE")
"""
)


def config(mode: str, name: str, dataset: str = "tiny") -> EATConfig:
    return EATConfig(dataset=dataset, engine_mode=mode, device="cpu",
                     **SCHEDULE, **RUNS[name])


def digest(res) -> dict:
    """The final params and the loss history of an ``EATResult``."""
    return {"params": [w.detach().clone()
                       for w in res.final_params.parameters()],
            "loss": torch.tensor(res.loss_history, dtype=torch.float64),
            "engine": res.engine_mode,
            "start": res.personalize_start_epoch}


def world(rank: int, dataset: str) -> dict:
    """Every run on this rank of the world."""
    return {name: digest(run_eat_distgnn(config("spmd", name, dataset)))
            for name in RUNS}


def start_reference(dst: str, dataset: str) -> subprocess.Popen:
    """The reference's spmd and stacked runs in a subprocess, writing each
    run's max params drift and loss difference to ``dst`` (npz)."""
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO_ROOT, "src"),
           "JAX_PLATFORMS": "cpu"}
    return subprocess.Popen([sys.executable, "-c", REF_SCRIPT, dst, dataset],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=REPO_ROOT)


def port_runs(dataset: str, workdir: str) -> tuple[dict, dict]:
    """The port's gloo world of 4 (rank 0's runs) and its stacked runs."""
    mesh = spawn_partition_world(world, 4, (dataset,), device="cpu",
                                 workdir=workdir, timeout_s=60,
                                 join_timeout_s=900)[0]
    stacked = {name: digest(run_eat_distgnn(config("stacked", name,
                                                   dataset)))
               for name in RUNS}
    return mesh, stacked


def drift(a, b) -> float:
    """Max |difference| over two lists of params."""
    return max(float((x - y).abs().max()) for x, y in zip(a, b, strict=True))
