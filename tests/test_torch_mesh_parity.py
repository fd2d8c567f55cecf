"""The port's partition mesh against the reference's ``mode="spmd"``
(ROADMAP item 14, parts 1 and 3).

The port runs a gloo world of 4 ranks on the CPU
(``repro_torch.launch.mesh``); the reference runs ``shard_map`` over 4
forced host devices in one subprocess (as
``tests/test_engine_parity.py``'s ``SPMD_SCRIPT`` does, with
``tests/_jax_cache.py``'s prelude and ``use_pallas_agg=False``).  Both
read the same tiny graph (EW, P=4, hidden 32), start params, batches and
phase-1 budgets, and run one sampled phase-0 epoch, one full-graph
phase-0 epoch (2 steps) and one phase-1 epoch, each from the same start,
then the val and test evals and the export from the start params; then
(part 3) three evals under the halo cache (K = 2: plans full, (0, 0),
full) with the int8 exchange, one top-k phase-0 epoch (``grad_topk_frac``
0.1) and one overlapped eval, the cached evals' exchange bytes equal.

Tolerances (max |diff|), the reference's own spmd-against-stacked ones
(``tests/test_engine_parity.py::test_spmd_shard_map_matches_stacked``):
phase-0 losses and params (sampled and full-graph) 1e-6, phase-1 losses
and params 1e-5, val and test micro-F1 5e-3, at most 3 test predictions
apart; the export's logits within the one-forward tolerance of
``tests/test_torch_distributed.py`` (atol 5e-6, rtol 1e-5).

Also the CLI: ``python -m repro_torch.launch.train gnn --engine spmd
--parts 2 --device cpu`` spawns its world, exits 0 and prints the stacked
run's summary keys.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import _torch_mesh_part3_ranks as m3
import _torch_mesh_ranks as mr
from _jax_cache import CACHE_PRELUDE
from repro_torch.launch.mesh import spawn_partition_world

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": os.path.join(REPO_ROOT, "src"),
       "JAX_PLATFORMS": "cpu"}

# the reference's spmd-vs-stacked tolerances (max |diff|)
EPOCH_TOL = {"phase0": 1e-6, "fullgraph": 1e-6, "phase1": 1e-5}
F1_TOL, PRED_MISMATCH = 5e-3, 3
LOGIT_ATOL, LOGIT_RTOL = 5e-6, 1e-5   # one forward's logits

REF_SCRIPT = (
    "import os, sys\n"
    "os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'\n"
    + CACHE_PRELUDE
    + r"""
import numpy as np
import jax.numpy as jnp
from repro.core import GPHyperParams, partition_graph
from repro.engine import EngineConfig, SPMDEngine
from repro.graph import (BENCHMARKS, GraphSAGE, build_partitioned_graph,
                         make_benchmark)
from repro.train.optim import AdamW

P, HIDDEN, LR = 4, 32, 1e-2
src = dict(np.load(sys.argv[1]))
g = make_benchmark(BENCHMARKS["tiny"])
r = partition_graph(g.indptr, g.indices, g.features, g.labels, P,
                    method="ew", seed=0)
pg = build_partitioned_graph(g, r.parts, P)
model = GraphSAGE(feature_dim=g.feature_dim, hidden_dim=HIDDEN,
                  num_classes=g.num_classes)
opt = AdamW(lr=LR, grad_clip=5.0)
eng = SPMDEngine(model, model.make_loss_fn(), opt, pg, GPHyperParams(),
                 EngineConfig(mode="spmd", use_pallas_agg=False))
assert eng.mode == "spmd", eng.mode

def params_of(tag):
    base = model.init(0)
    leaves = [jnp.asarray(src[f"{tag}_{i}"]) for i in range(3 * len(base.layers))]
    layers = [type(base.layers[0])(*leaves[3 * i:3 * i + 3])
              for i in range(len(base.layers))]
    return base._replace(layers=layers)

def leaves(p):
    return [np.asarray(x) for lp in p.layers for x in lp]

start, pstart = params_of("start"), params_of("pstart")
batches = {k[6:]: jnp.asarray(v) for k, v in src.items()
           if k.startswith("batch_")}
out = {}
p, _, l, v, _ = eng.phase0_epoch(start, opt.init(start), batches)
out.update({"phase0_loss": l, "phase0_val": v})
out.update({f"phase0_p{i}": x for i, x in enumerate(leaves(p))})
p, _, l, v, _ = eng.phase0_fullgraph_epoch(start, opt.init(start), iters=2)
out.update({"fullgraph_loss": l, "fullgraph_val": v})
out.update({f"fullgraph_p{i}": x for i, x in enumerate(leaves(p))})
import jax
po = jax.vmap(opt.init)(pstart)
p, _, l, v, _ = eng.phase1_epoch(pstart, po, batches, start,
                                 jnp.asarray(src["budgets"]))
out.update({"phase1_loss": l, "phase1_val": v})
out.update({f"phase1_p{i}": x for i, x in enumerate(leaves(p))})
out["val_micro"], out["val_preds"] = eng.evaluate(start, "val",
                                                  per_partition_params=False)
out["test_micro"], out["test_preds"] = eng.evaluate(pstart, "test")
out["logits"] = eng.export_serving_state(start)["logits"]

def engine(**kw):
    return SPMDEngine(model, model.make_loss_fn(), opt, pg, GPHyperParams(),
                      EngineConfig(mode="spmd", use_pallas_agg=False, **kw))

# item 14 part 3: the cache (K = 2) with int8, top-k, the overlap
eng = engine(halo_cache=True, halo_refresh_every=2, halo_compress="int8")
for i, (prm, split, per) in enumerate(((start, "val", False),
                                       (pstart, "test", True),
                                       (start, "val", False))):
    out[f"cache_int8_{i}_micro"], out[f"cache_int8_{i}_preds"] = (
        eng.evaluate(prm, split, per_partition_params=per))
out["cache_int8_bytes"] = eng.last_halo_exchange_bytes
eng = engine(grad_compress="topk", grad_topk_frac=0.1)
p, _, l, v, _ = eng.phase0_epoch(start, opt.init(start), batches)
out.update({"topk_loss": l, "topk_val": v,
            "topk_res": eng.comm_residual_state()[1]})
out.update({f"topk_p{i}": x for i, x in enumerate(leaves(p))})
eng = engine(overlap_halo=True)
out["overlap_micro"], out["overlap_preds"] = eng.evaluate(
    start, "val", per_partition_params=False)
np.savez(sys.argv[2], **{k: np.asarray(x) for k, x in out.items()})
print("REF_DONE")
"""
)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the port's world, run side by side."""
    d = tmp_path_factory.mktemp("parity")
    src, dst = str(d / "inputs.npz"), str(d / "reference.npz")
    np.savez(src, **mr.parity_inputs())
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, src, dst],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=ENV, cwd=REPO_ROOT)
    try:
        port = spawn_partition_world(m3.parity_world, 4, device="cpu",
                                     workdir=str(d), timeout_s=60,
                                     join_timeout_s=240)
        out, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0 and "REF_DONE" in out, err[-3000:]
    return port[0], dict(np.load(dst))


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("what", mr.EPOCHS)
def test_epochs_match_the_reference_spmd(runs, what):
    port, ref = runs
    got = port[what]
    assert tuple(got["losses"].shape) == ref[f"{what}_loss"].shape
    tol = EPOCH_TOL[what]
    _close(got["losses"].numpy(), ref[f"{what}_loss"], tol, 0)
    for i, w in enumerate(got["params"]):
        _close(w.numpy(), ref[f"{what}_p{i}"], tol, 0)
    _close(got["val"].numpy(), ref[f"{what}_val"], F1_TOL, 0)


def test_evals_and_logits_match_the_reference_spmd(runs):
    port, ref = runs
    ev = port["eval"]
    _close(ev["export"][1].numpy(), ref["logits"], LOGIT_ATOL, LOGIT_RTOL)
    for split in ("val", "test"):
        micro, preds = ev[split]
        _close(micro.numpy(), ref[f"{split}_micro"], F1_TOL, 0)
        assert int((preds.numpy() != ref[f"{split}_preds"]).sum()) \
            <= PRED_MISMATCH, split


def test_cached_int8_evals_match_the_reference_spmd(runs):
    port, ref = runs
    got = port["part3"]
    for i, (micro, preds) in enumerate(got["cache_int8"]):
        _close(micro.numpy(), ref[f"cache_int8_{i}_micro"], F1_TOL, 0)
        assert int((preds.numpy() != ref[f"cache_int8_{i}_preds"]).sum()) \
            <= PRED_MISMATCH, i
    assert got["cache_int8_bytes"] == int(ref["cache_int8_bytes"])


def test_topk_epoch_matches_the_reference_spmd(runs):
    port, ref = runs
    got = port["part3"]["topk"]
    tol = EPOCH_TOL["phase0"]
    _close(got["losses"].numpy(), ref["topk_loss"], tol, 0)
    for i, w in enumerate(got["params"]):
        _close(w.numpy(), ref[f"topk_p{i}"], tol, 0)
    _close(got["val"].numpy(), ref["topk_val"], F1_TOL, 0)
    assert tuple(got["grad_res"].shape) == ref["topk_res"].shape
    _close(got["grad_res"].numpy(), ref["topk_res"], tol, 0)


def test_overlapped_eval_matches_the_reference_spmd(runs):
    port, ref = runs
    micro, preds = port["part3"]["overlap"]
    _close(micro.numpy(), ref["overlap_micro"], F1_TOL, 0)
    assert int((preds.numpy() != ref["overlap_preds"]).sum()) \
        <= PRED_MISMATCH


def test_train_cli_spawns_the_mesh():
    """``--engine spmd --parts 2`` spawns a gloo world of 2 on the CPU; the
    summary the parent prints has the stacked run's keys."""
    base = ["gnn", "--device", "cpu", "--dataset", "tiny", "--epochs", "2",
            "--hidden", "8", "--batch-size", "64", "--fanout", "4",
            "--phase0-frac", "0.5", "--parts", "2"]
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *base, "--engine", "spmd"], capture_output=True,
                       text=True, env=ENV, cwd=REPO_ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    summary = json.loads(r.stdout[r.stdout.index("\n{") + 1:])
    assert summary["engine"] == "spmd" and summary["parts"] == 2
    assert "engine[spmd]" in r.stdout and "[phase-1] epoch" in r.stdout
    assert set(summary) == set(_summary_keys())


def _summary_keys():
    """The keys of a stacked run's summary (tiny, two epochs)."""
    from repro_torch.pipeline import EATConfig, run_eat_distgnn
    res = run_eat_distgnn(EATConfig(dataset="tiny", num_parts=2,
                                    hidden_dim=8, batch_size=64,
                                    fanouts=(4, 4), max_epochs=2,
                                    phase0_fraction=0.5,
                                    engine_mode="stacked", device="cpu"))
    return res.summary().keys()
