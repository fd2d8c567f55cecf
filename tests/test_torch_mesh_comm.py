"""The communication options on the partition mesh
(``EngineConfig(mode="spmd")``, ROADMAP item 14 part 3) on the CPU: the
halo cache, the quantized exchange, the overlapped forward and the gradient
reducers, in a world of 1 and a world of 4 gloo ranks, each spawned once
for the module (``repro_torch.launch.mesh``), on tiny with hidden 32; rank
functions in ``tests/_torch_mesh_part3_ranks.py``.

1. Every eval forward is bitwise the stacked engine's from the same params
   and state (its logits, the new cache and residual in the stacked
   layout, the exchange bytes): the cache's full, ``(0, 0)`` and cv-chunk
   plans, the int8 and fp16 codecs, ``ring_chunks`` 0 and 2, the plain
   aggregation, with and without the feature store, and the overlapped
   forward.
2. A ``(0, 0)`` plan issues no collective on any rank (the port's
   counterpart of the reference's HLO witness,
   ``tests/test_engine_parity.py``), and a full refresh one per layer (two
   with int8: payload and scales).
3. One full-graph step's gradient through the overlapped forward is within
   rel 1e-6 of the stacked one's.
4. The reducers' epochs (sampled, full-graph and async phase 0, with the
   cache and int8 in the async ones): in float64 within rel 1e-12 of the
   port's ``SequentialReference``, in float32 within the reference's
   spmd-against-stacked tolerances (phase 0: 1e-6; phase 1: 1e-5; val
   micro-F1: 5e-3).  The bucketed reducer alone, on uneven buckets:
   bitwise the stacked reducer, sending the ring all-reduce's bytes.
5. ``run_eat_distgnn`` with the options: within those tolerances of the
   stacked pipeline, every byte counter equal to its.
6. A cache + int8 + top-k run killed at boundary 1 and resumed is bitwise
   the uninterrupted one, and its archives hold ``halo``, ``halo_res`` and
   ``grad_res`` in the stacked shapes.
7. The reference's refusals hold on the mesh with its messages, and under
   the cache the export's snapshot becomes the cache.
8. A world of 1 is bitwise the stacked engine throughout; every rank of
   the world of 4 returns the same.
"""
import os

import numpy as np
import pytest
import torch

import _torch_mesh_part3_ranks as m3
import _torch_mesh_ranks as mr
from repro_torch.launch.mesh import spawn_partition_world
from repro_torch.train.checkpoint import load_meta

# the reference's spmd-against-stacked tolerances (max |diff|), as
# tests/test_torch_mesh.py states them
P0_TOL, P1_TOL, VAL_F1, PRED_MISMATCH = 1e-6, 1e-5, 5e-3, 3
REL64 = 1e-12
GRAD_RTOL = 1e-6
F32, F64 = str(torch.float32), str(torch.float64)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread here and in the ranks, so the bitwise
    comparisons run this process's products as the ranks run theirs."""
    saved = os.environ.get("OMP_NUM_THREADS"), torch.get_num_threads()
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    yield
    if saved[0] is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = saved[0]
    torch.set_num_threads(saved[1])


def _world(tmp_path_factory, P):
    d = tmp_path_factory.mktemp(f"comm{P}")
    return spawn_partition_world(
        m3.comm_world, P, (P, str(d)), device="cpu", workdir=str(d),
        timeout_s=60, join_timeout_s=240), str(d / "ck")


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _world(tmp_path_factory, 4)


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    return _world(tmp_path_factory, 1)


@pytest.fixture(scope="module")
def case():
    return {P: mr.tiny_case(P) for P in (1, 4)}


@pytest.fixture(scope="module")
def stacked_evals(case):
    return {P: m3.eval_cases(*case[P], P, "stacked") for P in (1, 4)}


@pytest.fixture(scope="module")
def stacked_pipelines():
    return {P: m3.pipeline_runs(P, "stacked") for P in (1, 4)}


def _equal(a, b) -> bool:
    """Bitwise equality of nested results (tensors, arrays, scalars)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def _maxdiff(a, b) -> float:
    return max(float((x.double() - y.double()).abs().max())
               for x, y in zip(a, b, strict=True))


def _rel(a, b) -> float:
    return max(float((x - y).abs().max() / y.abs().max().clamp_min(1e-300))
               for x, y in zip(a, b, strict=True))


# --------------------------------------------------------------------------
# 1-2. eval forwards from the same params and state
# --------------------------------------------------------------------------

def _check_trace(got, want, rank):
    """Rank ``rank``'s eval trace against the stacked engine's."""
    assert len(got["steps"]) == len(want["steps"]) == m3.EVALS
    for i, (g, w) in enumerate(zip(got["steps"], want["steps"])):
        assert _equal(g["logits"], w["logits"][rank]), i
        assert _equal(g["cache"], w["cache"]), i
        assert _equal(g["res"], w["res"]), i
        assert g["bytes"] == w["bytes"], i
    assert _equal(got["evaluate"], want["evaluate"])


@pytest.mark.parametrize("name", list(m3.EVAL_CASES))
def test_evals_bitwise_the_stacked_engine(world4, stacked_evals, name):
    outs, _ = world4
    for r in range(4):
        _check_trace(outs[r]["evals"][name], stacked_evals[4][name], r)


@pytest.mark.parametrize("name", list(m3.EVAL_CASES))
def test_world_of_one_evals_bitwise(world1, stacked_evals, name):
    outs, _ = world1
    _check_trace(outs[0]["evals"][name], stacked_evals[1][name], 0)


@pytest.mark.parametrize("name", ["cache_k2", "cache_k2_int8"])
def test_an_empty_plan_makes_no_collective(world4, world1, name):
    """K = 2: plans full, (0, 0), full.  The empty one issues nothing on
    any rank; a full one issues an exchange per layer (and one for the
    int8 scales)."""
    per_full = 2 * (2 if "int8" in name else 1)
    for outs, _ in (world4, world1):
        for o in outs:
            counts = [s["collectives"] for s in o["evals"][name]["steps"]]
            assert counts == [per_full, 0, per_full], counts


def test_codec_bytes_are_the_closed_forms(world4, case):
    """The int8 eval ships ``D + 4`` bytes a halo row and layer, fp16
    ``2·D`` (the fleet's rows, on every rank)."""
    _, pg = case[4]
    dims = (pg.features.shape[-1], mr.HIDDEN)
    rows = int(pg.n_halo.sum())
    outs, _ = world4
    for o in outs:
        got = {n: o["evals"][n]["steps"][0]["bytes"]
               for n in ("int8", "fp16_ring2")}
        # the engine counts each layer at the feature width
        assert got["int8"] == 2 * rows * (dims[0] + 4)
        assert got["fp16_ring2"] == 2 * rows * 2 * dims[0]


# --------------------------------------------------------------------------
# 3. the overlapped full-graph step
# --------------------------------------------------------------------------

def test_overlapped_fullgraph_gradients(world4, case):
    outs, _ = world4
    want = m3.fullgraph_grads(*case[4], "stacked")
    for o in outs:
        assert _rel(o["fg_grads"], want) <= GRAD_RTOL


# --------------------------------------------------------------------------
# 4. the reducers' epochs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("P", [1, 4])
def test_bucketed_reducer_moves_the_ring_bytes(world1, world4, P):
    """The per-shard bucketed reducer on uneven buckets: bitwise the
    stacked reducer's mean on every rank, and the fleet sends the ring
    all-reduce's closed form, ``2 (P-1) B``, plus fewer than P padding
    entries a bucket in each of its two collectives (an all_gather of the
    slices would send ``P (P-1) B``)."""
    from repro_torch.core.gp.trainer import (grad_sync_wire_bytes,
                                             make_bucketed_reduce_stacked)
    outs, _ = world4 if P == 4 else world1
    grads = m3.wire_grads(P)
    want = make_bucketed_reduce_stacked(P, m3.BUCKET_ELEMS * 4)(grads)
    n = sum(int(np.prod(s)) for s in m3.WIRE_SHAPES)
    buckets = -(-n // m3.BUCKET_ELEMS)
    ring = grad_sync_wire_bytes("bucketed", P, n, itemsize=4)
    fleet = sum(o["bucketed_wire"]["sent"] for o in outs)
    for o in outs:
        assert _equal(o["bucketed_wire"]["mean"], want)
    assert ring <= fleet <= ring + 2 * (P - 1) * P * buckets * 4
    if P > 1:
        assert fleet < grad_sync_wire_bytes("none", P, n, itemsize=4)


@pytest.mark.parametrize("what", list(m3.REDUCER_EPOCHS))
def test_f64_reducer_epochs_match_the_oracle(world4, case, what):
    outs, _ = world4
    got = outs[0][what, F64]
    want = m3.reducer_epoch(*case[4], 4, "sequential", what, torch.float64)
    assert got["losses"].shape == want["losses"].shape
    for a, b in zip(got["params"], want["params"], strict=True):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, b, rtol=REL64, atol=0)
    torch.testing.assert_close(got["losses"], want["losses"], rtol=REL64,
                               atol=0)
    torch.testing.assert_close(got["val"], want["val"], atol=1e-6, rtol=0)
    assert torch.equal(got["step"], want["step"])
    if want["grad_res"] is not None:
        assert got["grad_res"].shape == want["grad_res"].shape
        torch.testing.assert_close(got["grad_res"], want["grad_res"],
                                   rtol=REL64, atol=1e-15)


@pytest.mark.parametrize("what", list(m3.REDUCER_EPOCHS))
def test_f32_reducer_epochs_within_spmd_tolerance(world4, case, what):
    outs, _ = world4
    got = outs[0][what, F32]
    want = m3.reducer_epoch(*case[4], 4, "stacked", what, torch.float32)
    tol = P1_TOL if what.startswith("async1") else P0_TOL
    assert got["losses"].shape == want["losses"].shape
    assert _maxdiff([got["losses"]], [want["losses"]]) <= tol
    assert _maxdiff(got["params"], want["params"]) <= tol
    assert _maxdiff([got["val"]], [want["val"]]) <= VAL_F1
    assert torch.equal(got["step"], want["step"])
    if want["grad_res"] is not None:
        assert got["grad_res"].shape == want["grad_res"].shape
        assert _maxdiff([got["grad_res"]], [want["grad_res"]]) <= tol


@pytest.mark.parametrize("what", list(m3.REDUCER_EPOCHS))
def test_world_of_one_reducer_epochs_bitwise(world1, case, what):
    outs, _ = world1
    for dtype in (torch.float64, torch.float32):
        want = m3.reducer_epoch(*case[1], 1, "stacked", what, dtype)
        assert _equal(outs[0][what, str(dtype)], want), dtype


# --------------------------------------------------------------------------
# 5. the pipeline
# --------------------------------------------------------------------------

def _test_preds(g, pg, params_list):
    eng, _ = mr.engine(pg, g, "stacked", torch.float32)
    pp = mr.per_partition_start(mr.start_params(g, torch.float32),
                                pg.num_parts)
    with torch.no_grad():
        for w, v in zip(pp.parameters(), params_list, strict=True):
            w.copy_(v)
    return eng.evaluate(pp, "test", per_partition_params=True)[1]


@pytest.mark.parametrize("name", list(m3.PIPELINES))
def test_pipeline_within_spmd_tolerance(world4, case, stacked_pipelines,
                                        name):
    outs, _ = world4
    got, want = outs[0]["pipelines"][name], stacked_pipelines[4][name]
    assert got["engine"] == "spmd" and want["engine"] == "stacked"
    assert got["iters"] == want["iters"] and got["epochs"] == want["epochs"]
    assert got["bytes"] == want["bytes"] and got["cold"] == want["cold"]
    n0 = len(got["iters"])
    assert 0 < n0 < got["epochs"]
    d = np.abs(got["loss"] - want["loss"])
    assert d[:n0].max() <= P0_TOL and d[n0:].max() <= P1_TOL, d
    assert _maxdiff(got["params"], want["params"]) <= P1_TOL
    assert np.abs(got["val"] - want["val"]).max() <= VAL_F1
    g, pg = case[4]
    mismatch = int((_test_preds(g, pg, got["params"])
                    != _test_preds(g, pg, want["params"])).sum())
    assert mismatch <= PRED_MISMATCH
    assert abs(got["micro"] - want["micro"]) <= VAL_F1


@pytest.mark.parametrize("name", list(m3.PIPELINES))
def test_world_of_one_pipeline_bitwise(world1, stacked_pipelines, name):
    outs, _ = world1
    got = dict(outs[0]["pipelines"][name])
    want = dict(stacked_pipelines[1][name])
    assert got.pop("engine") == "spmd" and want.pop("engine") == "stacked"
    assert _equal(got, want)


# --------------------------------------------------------------------------
# 6. kill and resume
# --------------------------------------------------------------------------

@pytest.mark.parametrize("P", [1, 4])
def test_kill_and_resume_bitwise(world1, world4, P):
    outs, _ = {1: world1, 4: world4}[P]
    for o in outs:
        got = o["resume"]
        assert got["crashed"] == got["resumed_from"] == m3.RESUME_CRASH
        drop = lambda d: {k: v for k, v in d.items() if k != "cold"}
        assert _equal(drop(got["run"]), drop(got["base"]))
        assert _equal(got["run"], outs[0]["resume"]["run"])


@pytest.mark.parametrize("P", [1, 4])
def test_archives_hold_the_stacked_state(world1, world4, case, P):
    _, ck = {1: world1, 4: world4}[P]
    g, pg = case[P]
    dims = (pg.features.shape[-1], mr.HIDDEN)
    path = os.path.join(ck, f"ckpt_{m3.RESUME_CRASH:06d}.npz")
    arrays = np.load(path)
    # the run's own partition (its seed) fixes the slot count
    S = arrays["halo::h0"].shape[2]
    n = sum(w.numel() for w in mr.start_params(g, torch.float32).parameters())
    want = {"grad_res": (P, n)}
    for i, d in enumerate(dims):
        want[f"halo::h{i}"] = want[f"halo_res::r{i}"] = (P, P, S, d)
    got = {k: arrays[k].shape for k in arrays.files
           if k.split("::")[0] in ("halo", "halo_res", "grad_res")}
    assert got == want
    host = load_meta(path)["host"]
    assert host["has_halo_res"] and host["has_grad_res"]
    assert host["fingerprint"]["engine"] == "spmd"


# --------------------------------------------------------------------------
# 7. refusals and the export
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(m3.REFUSALS))
def test_the_reference_refusals_hold_on_the_mesh(world4, case, name):
    want = m3.refusals(*case[4], "stacked")[name]
    assert want != "no refusal"
    for o in world4[0]:
        assert o["refusals"][name] == want


@pytest.mark.parametrize("P", [1, 4])
def test_the_export_refreshes_the_cache(world1, world4, case, P):
    outs, _ = {1: world1, 4: world4}[P]
    want = m3.export_refresh(*case[P], P, "stacked")
    for o in outs:
        assert _equal(o["export"], want)
        assert _equal(o["export"]["cache"][0], want["export_cache"])


# --------------------------------------------------------------------------
# 8. every rank the same
# --------------------------------------------------------------------------

def test_every_rank_returns_the_same(world4):
    outs, _ = world4
    drop = lambda o: {k: v for k, v in o.items() if k != "evals"}
    for r in range(1, 4):
        assert _equal(drop(outs[r]), drop(outs[0])), r
